"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program under test: the references re-derive every
tensor the program computes from the weights and inputs the benchmark hands
to both sides. Parameter names follow the program's `state_dict` names, so
one weight dict loads into either.

`Precision` is the one knob: "f32" is the reference proper (TF32 off, set by
`strict_f32`); "fp8" rounds every operand of every product (linear layers,
attention's two products, convolutions, resizes) to float8 e4m3 with a
per-tensor scale, and every gradient that flows back through it to float8
e5m2. That is the control of the correctness check: the nearest precision
below the bf16 compute the configurations state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_FWD = torch.float8_e4m3fn
FP8_BWD = torch.float8_e5m2


def strict_f32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through `dtype` and back, scaled so that its largest entry lands on
    the format's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, FP8_FWD)

    @staticmethod
    def backward(ctx, g):
        return _round(g, FP8_BWD)


class Precision:
    """The operand rounding of the products: None (float32) or "fp8"."""
    mode: Optional[str] = None

    @classmethod
    def op(cls, x: torch.Tensor) -> torch.Tensor:
        if cls.mode is None:
            return x
        if cls.mode == "fp8":
            return _Fp8.apply(x)
        raise ValueError(f"unknown precision {cls.mode!r}")


class precision:
    """`with precision("fp8"):` runs the references' products in that mode."""

    def __init__(self, mode: Optional[str]):
        self.mode = None if mode in (None, "f32") else mode

    def __enter__(self):
        self.saved, Precision.mode = Precision.mode, self.mode

    def __exit__(self, *exc):
        Precision.mode = self.saved


def linear(x, weight, bias=None):
    return F.linear(Precision.op(x), Precision.op(weight), bias)


def matmul(a, b):
    return torch.matmul(Precision.op(a), Precision.op(b))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACT = {"quick_gelu": quick_gelu, "relu": F.relu}


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class ConvTranspose(nn.Module):
    """ConvTranspose2d with kernel == stride, torch's (C, O, k, k) weight."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k, k))
        self.bias = nn.Parameter(torch.empty(c_out))

    def forward(self, x):
        return conv_transpose_patch(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, self.eps)


class Embed(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


# where a list is set, each attention call appends (q shape, k shape, biased,
# whether a gradient flows back into it): the kernel bounds read it
ATTENTION_CALLS: Optional[list] = None


def attention(q, k, v, bias=None):
    """softmax(q kᵀ / √D + bias) v for (B, S, H, D) inputs, written as its
    two products."""
    if ATTENTION_CALLS is not None:
        ATTENTION_CALLS.append((tuple(q.shape), tuple(k.shape), bias is not None,
                                q.requires_grad or k.requires_grad or v.requires_grad))
    scale = q.shape[-1] ** -0.5
    s = matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale   # (B, H, S, T)
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return matmul(p, v.transpose(1, 2)).transpose(1, 2)             # (B, S, H, D)


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Dense(dim, dim), Dense(dim, dim)
        self.v_proj, self.out_proj = Dense(dim, dim), Dense(dim, dim)

    def forward(self, x, bias=None, kv=None):
        kv = x if kv is None else kv

        def split(t):
            return t.unflatten(-1, (self.heads, -1))

        out = attention(split(self.q_proj(x)), split(self.k_proj(kv)),
                        split(self.v_proj(kv)), bias)
        return self.out_proj(out.flatten(-2))


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str):
        super().__init__()
        self.act = ACT[act]
        self.fc1, self.fc2 = Dense(dim, hidden), Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class PreNormLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, act: str = "quick_gelu"):
        super().__init__()
        self.layer_norm1, self.layer_norm2 = LayerNorm(dim), LayerNorm(dim)
        self.self_attn = MultiHeadAttention(dim, heads)
        self.mlp = MLP(dim, hidden, act)

    def forward(self, x, bias=None):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class PostNormLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, act: str = "relu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.layer_norm1 = LayerNorm(dim)
        self.mlp = MLP(dim, hidden, act)
        self.layer_norm2 = LayerNorm(dim)

    def forward(self, x):
        x = self.layer_norm1(x + self.self_attn(x))
        return self.layer_norm2(x + self.mlp(x))


def causal_bias(n: int, device) -> torch.Tensor:
    full = torch.full((n, n), torch.finfo(torch.float32).min, device=device)
    return torch.triu(full, diagonal=1)[None, None]


def padding_bias(keep: torch.Tensor) -> torch.Tensor:
    """(B, S) {0, 1} keep-mask -> (B, 1, 1, S) additive bias."""
    return ((1.0 - keep.float()) * torch.finfo(torch.float32).min)[:, None, None, :]


def conv_transpose_patch(x, weight, bias):
    """ConvTranspose2d with kernel == stride, weight (C, O, k, k)."""
    return F.conv_transpose2d(Precision.op(x), Precision.op(weight), bias,
                              stride=weight.shape[-1])


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    return np.where(x <= 1.0, (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0,
                    np.where(x < 2.0, a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x
                             - 4.0 * a, 0.0))


def resize_matrix(n_in: int, n_out: int, mode: str, align_corners: bool = False,
                  out_pad: int = 0) -> np.ndarray:
    """(n_out + 2 out_pad, n_in) interpolation weights of `F.interpolate`
    (half-pixel centres or `align_corners`, taps clamped to the border);
    `out_pad` repeats the first and last rows (a replicate pad)."""
    if align_corners and n_out > 1:
        src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    else:
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    taps = ([(base, 1 - frac), (base + 1, frac)] if mode == "bilinear" else
            [(base + o, _cubic(frac - o)) for o in range(-1, 3)])
    w = np.zeros((n_out, n_in))
    for tap, wt in taps:
        np.add.at(w, (np.arange(n_out), np.clip(tap, 0, n_in - 1)), wt)
    if out_pad:
        w = np.concatenate([np.repeat(w[:1], out_pad, 0), w,
                            np.repeat(w[-1:], out_pad, 0)])
    return w.astype(np.float32)


def resize(x: torch.Tensor, out_hw, mode: str, align_corners: bool = False,
           out_pad: int = 0) -> torch.Tensor:
    """Resize the last two axes as two products with `resize_matrix`."""
    (h, w), (ho, wo) = x.shape[-2:], out_hw
    wr = torch.from_numpy(resize_matrix(h, ho, mode, align_corners, out_pad))
    wc = torch.from_numpy(resize_matrix(w, wo, mode, align_corners, out_pad))
    wr, wc = wr.to(x.device), wc.to(x.device)
    return matmul(wr, matmul(x, wc.T))


IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def normalize_uint8(image: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGE_MEAN, device=image.device).reshape(1, -1, 1, 1)
    std = torch.tensor(IMAGE_STD, device=image.device).reshape(1, -1, 1, 1)
    return (image.float() / 255.0 - mean) / std


def dice_ce_per_sample(logits: torch.Tensor, target: torch.Tensor,
                       lambda_dice: float = 1.0, lambda_ce: float = 0.2,
                       smooth: float = 1e-5) -> torch.Tensor:
    """(B,) MONAI DiceCE terms of a binary (B, 1, H, W) batch: the batch's
    loss is their mean (sigmoid dice per sample, BCE-with-logits per pixel)."""
    x, g = logits.float(), target.float()
    p = torch.sigmoid(x)
    dims = tuple(range(1, x.dim()))
    dice = 1.0 - (2.0 * (g * p).sum(dims) + smooth) / (g.sum(dims) + p.sum(dims)
                                                        + smooth)
    bce = (g * F.softplus(-x) + (1.0 - g) * F.softplus(x)).mean(dims)
    return lambda_dice * dice + lambda_ce * bce


class AdamW:
    """torch's AdamW (decoupled decay, bias-corrected moments, eps after the
    square root) written out, over named f32 leaves; `weight_decay` by leaf
    name (0 where absent). A leaf without a gradient is left as it is."""

    def __init__(self, params: dict, lr: float, weight_decay: dict,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd = params, lr, weight_decay
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in self.params.items():
            g = grads.get(n)
            if g is None:
                continue
            p.mul_(1 - self.lr * self.wd.get(n, 0.0))
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[n], denom, value=-self.lr / c1)


def load_weights(model: nn.Module, weights: dict) -> None:
    """Copy every parameter and buffer of `model` from `weights` (by name,
    f32); a missing or misshapen entry raises."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    missing = sorted(set(own) - set(weights))
    if missing:
        raise KeyError(f"weights lack {missing[:6]}")
    with torch.no_grad():
        for n, p in own.items():
            if tuple(weights[n].shape) != tuple(p.shape):
                raise ValueError(f"{n}: {tuple(weights[n].shape)} != {tuple(p.shape)}")
            p.copy_(weights[n])


def decaying(model: nn.Module) -> set[str]:
    """The leaves AdamW decays under the recipes' two-group policy: the
    weights of linear layers and convolutions and the patch projection;
    never a bias, a norm, an embedding or a bare parameter."""
    out = set()
    for prefix, m in model.named_modules():
        for leaf, _ in m.named_parameters(recurse=False):
            if leaf == "patch_proj" or (leaf == "weight" and isinstance(
                    m, (Dense, ConvTranspose))):
                out.add(f"{prefix}.{leaf}" if prefix else leaf)
    return out

"""Shared transformer building blocks.

Counterpart of `tunevlseg_tpu/nn/layers.py`. Precision follows Flax
`dtype=<compute>` over f32 parameters: the parameters stay f32 and are cast
to the compute dtype at use, LayerNorm statistics and its affine run in f32,
and every block returns the compute dtype. Submodule and parameter names
follow the JAX param tree (`self_attn.q_proj`, `mlp.fc1`, `layer_norm1`) so
the weight mapping in `tunevlseg_torch/convert/from_jax.py` is mechanical.

Parameters are allocated uninitialized; `init_params` fills every module
that defines `init_weights(generator)` from one `torch.Generator`.

Tensor parallelism (`parallel/tensor_parallel.py`): `MultiHeadAttention`
and `TransformerMLP` name their column- and row-parallel products
(`tp_column`, `tp_row`); once `shard_model` has sliced them, `tp` is their
model group, `num_heads` the rank's local head count, and their forward
enters the tensor-parallel region (`copy`, or `gather_seq` when the stream
is sequence-sharded) and leaves it after the row-parallel product
(`reduce`, or `reduce_scatter_seq`), the row-parallel bias added once. The
encoder layers pass `seq_sharded` through: their LayerNorms and residual
adds then run on the rank's rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.nn.attention import dot_product_attention, head_slice
from tunevlseg_torch.ops import layer_norm as n1
from tunevlseg_torch.parallel import tensor_parallel as tp_lib
from tunevlseg_torch.utils import profiling


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACT2FN: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "quick_gelu": quick_gelu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Flax's `lecun_normal`: truncated normal at ±2 std, rescaled so the
    variance is 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(generator)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator],
            mask_shape: Optional[tuple] = None) -> torch.Tensor:
    """Inverted dropout with the mask drawn from `generator` (which lives on
    x's device): kept entries are x / (1 - rate), the rest 0. `mask_shape`
    (broadcastable to x) drops whole slices: (B, C, 1, 1) is Dropout2d,
    (B, 1, 1) a sample's residual branch (DropPath)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(mask_shape or x.shape, device=x.device,
                      generator=generator) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dense(nn.Module):
    """Flax `nn.Dense` semantics with torch's (out, in) weight layout."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
    """Flax `nn.LayerNorm(dtype=..., use_bias=bias)`: f32 statistics and
    affine, output in the compute dtype. A tuple `dim` normalises over that
    many trailing axes with an affine of that shape (torch's
    `nn.LayerNorm((C, H, W))`).

    A call `ops/layer_norm.engages` takes (the last axis alone, on CUDA,
    bfloat16 in and out, D % 8 == 0 and D <= 4096) runs N1, one pass each
    way; every other call runs the plain chain (x to f32, f32 layer_norm, y
    to the compute dtype), counted as `n1.plain`."""

    def __init__(self, dim: int | tuple[int, ...], eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if n1.engages(self.weight.shape, x.dtype, self.dtype, x.device):
            return n1.layer_norm(x, self.weight, self.bias, self.eps, self.dtype)
        profiling.count(n1.N1_PLAIN)
        return n1.layer_norm_ref(x, self.weight, self.bias, self.eps, self.dtype)


class GroupNorm(nn.Module):
    """Flax `nn.GroupNorm(num_groups)` on (B, C, H, W): f32 inside, a (C,)
    affine, output in the compute dtype."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(self.dtype)


class Embed(nn.Module):
    """Flax `nn.Embed(dtype=...)`: gather from the f32 table, then cast."""

    def __init__(self, num_embeddings: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, dim))

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.weight.shape[1] ** -0.5,
                            generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """MHA with separate q/k/v/out projections (CLIP convention)."""

    tp_column = ("q_proj", "k_proj", "v_proj")
    tp_row = ("out_proj",)
    tp: Optional[tp_lib.ModelGroup] = None

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                kv_states: Optional[torch.Tensor] = None,
                kv_valid: Optional[int] = None,
                seq_sharded: bool = False) -> torch.Tensor:
        g = self.tp
        x = tp_lib.enter(hidden_states, g, seq_sharded)
        kv = x if kv_states is None else tp_lib.enter(kv_states, g, seq_sharded)
        if g is not None:
            attn_bias = head_slice(attn_bias, g.rank * self.num_heads,
                                   self.num_heads)

        def split(t):
            return t.unflatten(-1, (self.num_heads, -1))

        out = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(kv)),
                                    split(self.v_proj(kv)),
                                    bias=attn_bias, kv_valid=kv_valid)
        return tp_lib.row(self.out_proj, out.flatten(-2), g, seq_sharded)


class TransformerMLP(nn.Module):
    tp_column = ("fc1",)
    tp_row = ("fc2",)
    tp: Optional[tp_lib.ModelGroup] = None

    def __init__(self, dim: int, intermediate_size: int, act: str = "quick_gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = ACT2FN[act]
        self.fc1 = Dense(dim, intermediate_size, dtype=dtype)
        self.fc2 = Dense(intermediate_size, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, seq_sharded: bool = False) -> torch.Tensor:
        h = self.act(self.fc1(tp_lib.enter(x, self.tp, seq_sharded)))
        return tp_lib.row(self.fc2, h, self.tp, seq_sharded)


class PreNormEncoderLayer(nn.Module):
    """Pre-LayerNorm transformer block (CLIP text/vision encoder layer)."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 act: str = "quick_gelu", layer_norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm(dim, layer_norm_eps, dtype)
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.layer_norm2 = LayerNorm(dim, layer_norm_eps, dtype)
        self.mlp = TransformerMLP(dim, intermediate_size, act, dtype)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                kv_valid: Optional[int] = None,
                seq_sharded: bool = False) -> torch.Tensor:
        """`seq_sharded`: x is the rank's rows of a sequence-parallel stream
        (the layer's blocks are tensor-parallel)."""
        x = x + self.self_attn(self.layer_norm1(x), attn_bias, kv_valid=kv_valid,
                               seq_sharded=seq_sharded)
        return x + self.mlp(self.layer_norm2(x), seq_sharded=seq_sharded)


class PostNormEncoderLayer(nn.Module):
    """Post-LayerNorm block, the CLIPSeg decoder layer."""

    def __init__(self, dim: int, num_heads: int, intermediate_size: int,
                 act: str = "relu", layer_norm_eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.layer_norm1 = LayerNorm(dim, layer_norm_eps, dtype)
        self.mlp = TransformerMLP(dim, intermediate_size, act, dtype)
        self.layer_norm2 = LayerNorm(dim, layer_norm_eps, dtype)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.layer_norm1(x + self.self_attn(x, attn_bias))
        return self.layer_norm2(x + self.mlp(x))

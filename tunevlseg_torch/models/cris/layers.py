"""CRIS multimodal neck, cross-attention decoder and dynamic-conv projector.

Counterpart of `tunevlseg_tpu/models/cris/layers.py`. Submodule names follow
the JAX param tree. The decoder runs at its real token count (676 at 416^2):
the JAX package's padding to a multiple of 64 is a TPU tiling device and is
dropped; `kv_valid` stays an argument of the layer. On a CUDA device in bf16
the decoder's self-attention goes to K1 (K2 in the backward) and its
cross-attention into the text, which carries the key-padding bias, to K3.

Dropout masks come from an explicit `torch.Generator` (see
`training/task.py`); `deterministic=True`, the default, applies none.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import _disable_current_modes

from tunevlseg_torch.models.cris.resnet import (BatchNorm1d, BatchNorm2d,
                                                avg_pool_nchw)
from tunevlseg_torch.nn import remat
from tunevlseg_torch.nn.attention import dot_product_attention
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.nn.layers import Dense, LayerNorm, dropout
from tunevlseg_torch.ops.image import upsample_scale


class ConvBnRelu(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_dim, out_dim, kernel_size, padding=padding,
                           bias=False, dtype=dtype)
        self.bn = BatchNorm2d(out_dim)

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None,
                updates: Optional[dict] = None) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x), use_running_average, updates))


class LinearBnRelu(nn.Module):
    """Linear (no bias) + BatchNorm1d + ReLU."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.linear = Dense(in_dim, out_dim, bias=False, dtype=dtype)
        self.bn = BatchNorm1d(out_dim)

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None,
                updates: Optional[dict] = None) -> torch.Tensor:
        return F.relu(self.bn(self.linear(x), use_running_average, updates))


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Append normalized x / y coordinate channels (CoordConv)."""
    b, _, h, w = x.shape
    xs = torch.linspace(-1, 1, w, dtype=torch.float32, device=x.device)
    ys = torch.linspace(-1, 1, h, dtype=torch.float32, device=x.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([xx, yy])[None].to(x.dtype).expand(b, 2, h, w)
    return torch.cat([x, coords], dim=1)


class FPN(nn.Module):
    """Multimodal neck fusing the text state into the pyramid."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 1024),
                 out_channels: Sequence[int] = (256, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ci, co = in_channels, out_channels
        conv = functools.partial(ConvBnRelu, dtype=dtype)
        self.txt_proj = LinearBnRelu(ci[2], co[2], dtype)
        self.f1_v_proj = conv(ci[2], co[2], 1, 0)
        self.norm_layer_bn = BatchNorm2d(co[2])
        self.f2_v_proj = conv(ci[1], co[1], 3, 1)
        self.f2_cat = conv(co[2] + co[1], co[1], 1, 0)
        self.f3_v_proj = conv(ci[0], co[0], 3, 1)
        self.f3_cat = conv(co[0] + co[1], co[1], 1, 0)
        self.f4_proj5 = conv(co[2], co[1], 3, 1)
        self.f4_proj4 = conv(co[1], co[1], 3, 1)
        self.f4_proj3 = conv(co[1], co[1], 3, 1)
        self.aggr = conv(3 * co[1], co[1], 1, 0)
        self.coordconv_0 = conv(co[1] + 2, co[1], 3, 1)
        self.coordconv_1 = conv(co[1], co[1], 3, 1)

    def forward(self, feats, state: torch.Tensor,
                use_running_average: Optional[bool] = None,
                updates: Optional[dict] = None) -> torch.Tensor:
        """`use_running_average` overrides every BatchNorm of the neck at call
        time (an e2e model trains them but evaluates with the running
        statistics); `updates` collects the new running statistics, see
        `models/cris/resnet.py`."""
        bn = dict(use_running_average=use_running_average, updates=updates)
        v3, v4, v5 = feats
        # fusion 1: text gating of C5
        s = self.txt_proj(state, **bn)
        f5 = self.f1_v_proj(v5, **bn) * s[:, :, None, None]
        f5 = F.relu(self.norm_layer_bn(f5, **bn))
        # fusion 2
        f4 = self.f2_v_proj(v4, **bn)
        f4 = self.f2_cat(torch.cat([f4, upsample_scale(f5, 2, "bilinear")], dim=1),
                         **bn)
        # fusion 3
        f3 = avg_pool_nchw(self.f3_v_proj(v3, **bn), 2)
        f3 = self.f3_cat(torch.cat([f3, f4], dim=1), **bn)
        # fusion 4 + aggregation
        fq5 = upsample_scale(self.f4_proj5(f5, **bn), 2, "bilinear")
        fq = torch.cat([self.f4_proj3(f3, **bn), self.f4_proj4(f4, **bn), fq5],
                       dim=1)
        fq = self.coordconv_0(add_coords(self.aggr(fq, **bn)), **bn)
        return self.coordconv_1(fq, **bn)


def sincos_pos_1d(d_model: int, length: int) -> np.ndarray:
    """(length, d_model) sin/cos encoding (base 1e-4)."""
    pe = np.zeros((length, d_model), np.float32)
    position = np.arange(length)[:, None]
    mul = 1e-4 ** (np.arange(0, d_model, 2) / d_model)
    angles = position * mul
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)
    return pe


def sincos_pos_2d(d_model: int, height: int, width: int) -> np.ndarray:
    """(height*width, d_model) 2D sin/cos encoding."""
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    mul = 1e-4 ** (np.arange(0, half, 2) / half)
    angles_w = np.arange(width)[:, None] * mul      # (W, half/2)
    pe[0:half:2] = np.sin(angles_w).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(angles_w).T[:, None, :].repeat(height, axis=1)
    angles_h = np.arange(height)[:, None] * mul
    pe[half::2] = np.sin(angles_h).T[:, :, None].repeat(width, axis=2)
    pe[half + 1::2] = np.cos(angles_h).T[:, :, None].repeat(width, axis=2)
    return pe.reshape(d_model, height * width).T


@functools.lru_cache(maxsize=16)
def _pos_tensor(kind: str, dims: tuple, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """A position encoding on its device, built once per shape, outside
    every dispatch mode: a real tensor also when the first call comes inside
    a `torch.export` trace, which would otherwise leave its fake tensor in
    the cache for every later call (as `ops/image.py`'s resize matrices)."""
    pe = sincos_pos_2d(*dims) if kind == "2d" else sincos_pos_1d(*dims)
    with _disable_current_modes():
        return torch.from_numpy(pe)[None].to(device=device, dtype=dtype)


class MHA(nn.Module):
    """Explicit-QKV multi-head attention (torch nn.MultiheadAttention
    semantics with separate q / k / v inputs and an optional key-padding
    bias)."""

    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(dim, dim, dtype=dtype)
        self.k_proj = Dense(dim, dim, dtype=dtype)
        self.v_proj = Dense(dim, dim, dtype=dtype)
        self.out_proj = Dense(dim, dim, dtype=dtype)

    def forward(self, q, k, v, key_pad_bias: Optional[torch.Tensor] = None,
                kv_valid: Optional[int] = None) -> torch.Tensor:
        def split(t):
            return t.unflatten(-1, (self.num_heads, -1))

        out = dot_product_attention(split(self.q_proj(q)), split(self.k_proj(k)),
                                    split(self.v_proj(v)), bias=key_pad_bias,
                                    kv_valid=kv_valid)
        return self.out_proj(out.flatten(-2))


class CRISDecoderLayer(nn.Module):
    """Pre-norm self-attention -> cross-attention into the text (key-padding
    bias) -> FFN with an internal LayerNorm; dropout after each of the three
    and inside the FFN."""

    def __init__(self, d_model: int = 512, num_heads: int = 8,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.self_attn = MHA(d_model, num_heads, dtype)
        self.self_attn_norm = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.multihead_attn = MHA(d_model, num_heads, dtype)
        self.cross_attn_norm = LayerNorm(d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype=dtype)
        self.ffn_0 = Dense(d_model, dim_feedforward, dtype=dtype)
        self.ffn_norm = LayerNorm(dim_feedforward, dtype=dtype)
        self.ffn_1 = Dense(dim_feedforward, d_model, dtype=dtype)

    def forward(self, vis, txt, vis_pos, txt_pos, key_pad_bias,
                deterministic: bool = True, kv_valid: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.dropout, deterministic, generator)

        # self-attention over the visual tokens
        v2 = self.norm1(vis)
        qk = v2 + vis_pos
        v2 = self.self_attn_norm(self.self_attn(qk, qk, v2, kv_valid=kv_valid))
        vis = vis + drop(v2)
        # cross-attention into the text
        v2 = self.norm2(vis)
        v2 = self.multihead_attn(v2 + vis_pos, txt + txt_pos, txt, key_pad_bias)
        vis = vis + drop(self.cross_attn_norm(v2))
        # FFN with its internal LayerNorm
        v2 = drop(F.relu(self.ffn_0(self.norm3(vis))))
        return vis + drop(self.ffn_1(self.ffn_norm(v2)))


class CRISTransformerDecoder(nn.Module):
    def __init__(self, num_layers: int = 3, d_model: int = 512,
                 num_heads: int = 8, dim_feedforward: int = 2048,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            CRISDecoderLayer(d_model, num_heads, dim_feedforward, dropout, dtype)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, dtype=dtype)

    def forward(self, fq: torch.Tensor, txt: torch.Tensor,
                pad_mask: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """fq (B, C, H, W), txt (B, L, D), pad_mask (B, L) True = pad.
        Returns (B, C, H, W)."""
        b, c, h, w = fq.shape
        vis_pos = _pos_tensor("2d", (c, h, w), fq.device, fq.dtype)
        txt_pos = _pos_tensor("1d", (txt.shape[-1], txt.shape[1]), fq.device,
                              fq.dtype)
        key_pad_bias = torch.where(
            pad_mask, torch.finfo(torch.float32).min, 0.0)[:, None, None, :]
        vis = fq.reshape(b, c, h * w).transpose(1, 2)
        for layer in self.layers:
            vis = remat.layer_call(layer, vis, txt, vis_pos, txt_pos, key_pad_bias,
                                   deterministic=deterministic, generator=generator)
        vis = self.norm(vis)
        return vis.transpose(1, 2).reshape(b, c, h, w)


def dynamic_conv(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Per-sample k x k "same" convolution to one channel: x (B, C, H, W),
    weight (B, C, k, k), bias (B,) -> (B, 1, H, W); what
    `F.conv2d(x.reshape(1, B*C, H, W), weight, groups=B)` computes, and the
    JAX package's k*k shifted contractions. One batched product over the
    channels, (B, k*k, C) @ (B, C, H*W), reads x once (f32 accumulation, each
    tap map rounded to x's dtype); the k*k tap maps are then shifted and
    summed in f32. On an H100 at b64 x 256 x 104^2 in bf16 it took 0.84 ms
    forward and 1.27 ms backward against the grouped convolution's 1.55 and
    3.55 ms (scripts/torch_dynconv_ab.py; PERF.md)."""
    b, c, h, w = x.shape
    k = weight.shape[-1]
    taps = torch.bmm(weight.to(x.dtype).reshape(b, c, k * k).transpose(1, 2),
                     x.reshape(b, c, h * w)).reshape(b, k, k, h, w)
    taps = F.pad(taps.float(), (k // 2,) * 4)
    out = sum(taps[:, dy, dx, dy:dy + h, dx:dx + w]
              for dy in range(k) for dx in range(k))
    return (out + bias.float().reshape(b, 1, 1)).to(x.dtype)[:, None]


class Projector(nn.Module):
    """Upsampling visual projector + per-sample dynamic convolution."""

    def __init__(self, word_dim: int = 1024, in_dim: int = 256,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.vis_1 = ConvBnRelu(in_dim * 2, in_dim * 2, 3, 1, dtype=dtype)
        self.vis_3 = ConvBnRelu(in_dim * 2, in_dim, 3, 1, dtype=dtype)
        self.vis_4 = Conv2d(in_dim, in_dim, 1, dtype=dtype)
        self.txt = Dense(word_dim, in_dim * kernel_size * kernel_size + 1,
                         dtype=dtype)

    def forward(self, x: torch.Tensor, word: torch.Tensor,
                use_running_average: Optional[bool] = None,
                updates: Optional[dict] = None) -> torch.Tensor:
        bn = dict(use_running_average=use_running_average, updates=updates)
        x = self.vis_1(upsample_scale(x, 2, "bilinear"), **bn)
        x = self.vis_3(upsample_scale(x, 2, "bilinear"), **bn)
        x = self.vis_4(x)
        b, c, h, w = x.shape
        k = self.kernel_size
        params = self.txt(word)
        weight = params[:, :-1].reshape(b, c, k, k)
        return dynamic_conv(x, weight, params[:, -1])

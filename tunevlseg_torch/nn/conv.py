"""Transposed convolution with kernel == stride, as one GEMM.

Counterpart of `tunevlseg_tpu/nn/conv.py:conv_transpose_patch` and
`ConvTranspose2d`. The weight keeps torch's (I, O, k, k) ConvTranspose2d
layout. CLIPSeg rd64 uses only this plain head; the 3x3 `Conv2d` of the
refined head comes with the configurations that need it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def conv_transpose_patch(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ConvTranspose2d with kernel_size == stride: a per-pixel linear map and
    a depth-to-space. x (B, C, h, w), weight (C, O, k, k); returns
    (B, O, h*k, w*k) in x's dtype (f32 accumulation, one rounding)."""
    c, o, kh, kw = weight.shape
    b, _, h, w = x.shape
    wmat = weight.reshape(c, o * kh * kw).to(x.dtype)
    y = torch.einsum("bchw,cf->bhwf", x, wmat)
    y = y.reshape(b, h, w, o, kh, kw).permute(0, 3, 1, 4, 2, 5)
    y = y.reshape(b, o, h * kh, w * kw)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1).to(y.dtype)
    return y


class ConvTranspose2d(nn.Module):
    """ConvTranspose2d with kernel == stride; torch weight layout (I, O, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k, k))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        # torch's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), fan_in = O*k*k
        bound = (self.weight[0].numel()) ** -0.5
        for p in (self.weight, self.bias):
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_patch(x.to(self.dtype), self.weight, self.bias)

"""Convolutions in NCHW layout with torch's weight layouts.

Counterpart of `tunevlseg_tpu/nn/conv.py`: `conv2d` / `Conv2d` (zeros,
replicate and reflect padding, "same", stride, no-bias; `F.conv2d`
underneath, a convolution outside any kernel of the port) and
`conv_transpose_patch` / `ConvTranspose2d`, the transposed convolution with
kernel == stride as one GEMM, with torch's (I, O, k, k) weight. Only the NCHW
layout is ported: the JAX package's NHWC variant is a TPU layout experiment.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
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


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           dilation=1, groups: int = 1, pad_mode: str = "zeros") -> torch.Tensor:
    """`F.conv2d` on x (B, C, H, W) with weight (O, I/g, kh, kw), both cast to
    x's dtype. `padding="same"` pads (k-1)*dilation in all, the smaller half
    first; `pad_mode` "replicate" or "reflect" pads before the convolution
    (nn.Conv2d(padding="same", padding_mode="replicate") of the additive
    head)."""
    kh, kw = weight.shape[2:]
    dh, dw = _pair(dilation)
    if padding == "same":
        ph, pw = (kh - 1) * dh, (kw - 1) * dw
        pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)   # F.pad order
    elif isinstance(padding, str):
        raise ValueError(f"unsupported padding {padding}")
    else:
        ph, pw = _pair(padding)
        pads = (pw, pw, ph, ph)
    symmetric = pads[0] == pads[1] and pads[2] == pads[3]
    if any(pads) and (pad_mode != "zeros" or not symmetric):
        x = F.pad(x, pads, mode="constant" if pad_mode == "zeros" else pad_mode)
        pads = (0, 0, 0, 0)
    return F.conv2d(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    stride=_pair(stride), padding=(pads[2], pads[0]),
                    dilation=(dh, dw), groups=groups)


class Conv2d(nn.Module):
    """Parameter-holding convolution with torch's (O, I, kh, kw) weight and
    torch's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
    bias (a constant bias where `bias_init_value` is given)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, pad_mode: str = "zeros", bias: bool = True,
                 bias_init_value: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.pad_mode = stride, padding, pad_mode
        self.bias_init_value = bias_init_value
        self.dtype = dtype
        kh, kw = _pair(kernel_size)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        bound = self.weight[0].numel() ** -0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            if self.bias_init_value is not None:
                self.bias.fill_(self.bias_init_value)
            else:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x.to(self.dtype), self.weight, self.bias, self.stride,
                      self.padding, pad_mode=self.pad_mode)

"""Image resampling.

Counterpart of `tunevlseg_tpu/ops/image.py:resize_2d`, whose resize matrices
reproduce torch's `F.interpolate` (cubic A = -0.75, half-pixel centres,
clamped taps) as matmuls for the TPU. The port calls `F.interpolate` itself,
in f32. Only the bicubic mode is on the ported path (the vision
position-embedding resize); bilinear and nearest come with their users.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_2d(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic resize of the trailing two axes of `img` (..., H, W) ->
    (..., H', W'), computed in f32, returned in `img`'s dtype."""
    if tuple(img.shape[-2:]) == tuple(out_hw):
        return img
    lead = img.shape[:-2]
    x = img.float().reshape(1, -1, *img.shape[-2:])
    x = F.interpolate(x, size=tuple(out_hw), mode="bicubic", align_corners=False)
    return x.reshape(*lead, *out_hw).to(img.dtype)

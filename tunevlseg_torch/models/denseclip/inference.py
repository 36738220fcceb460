"""mmseg's whole-image and sliding-window inference for DenseCLIP.

Counterpart of `tunevlseg_tpu/models/denseclip/inference.py`. Every
reference DenseCLIP config tests with `mode="slide"` (crop 512, stride 341 in
the RN50 recipe): a ceil grid of windows, the last one of a row or column
clamped to the image edge, the logits summed where windows overlap and
divided by each pixel's visit count. Every window has the crop's shape.
"""
from __future__ import annotations

from typing import Callable

import torch


def whole_inference(apply_fn: Callable, images: torch.Tensor) -> torch.Tensor:
    """`mode="whole"`: one forward of the full image (the segmentor already
    resizes its logits to the input)."""
    return apply_fn(images)


def window_starts(size: int, crop: int, stride: int) -> list[int]:
    """The start of each window along one axis: ceil((size - crop) / stride)
    + 1 windows, each start clamped to size - crop."""
    crop = min(crop, size)
    n = max(size - crop + stride - 1, 0) // stride + 1
    return [min(i * stride, size - crop) for i in range(n)]


def slide_inference(apply_fn: Callable, images: torch.Tensor,
                    crop_size: tuple[int, int],
                    stride: tuple[int, int]) -> torch.Tensor:
    """apply_fn(crop) -> (B, K, ch, cw) class logits of one window. Returns
    the (B, K, H, W) f32 logits averaged over the windows covering each
    pixel."""
    b, _, h, w = images.shape
    ch, cw = min(crop_size[0], h), min(crop_size[1], w)
    preds = None
    count = torch.zeros((1, 1, h, w), dtype=torch.float32, device=images.device)
    for y1 in window_starts(h, ch, stride[0]):
        for x1 in window_starts(w, cw, stride[1]):
            logits = apply_fn(images[:, :, y1:y1 + ch, x1:x1 + cw]).float()
            if preds is None:
                preds = torch.zeros((b, logits.shape[1], h, w), dtype=torch.float32,
                                    device=images.device)
            preds[:, :, y1:y1 + ch, x1:x1 + cw] += logits
            count[:, :, y1:y1 + ch, x1:x1 + cw] += 1.0
    return preds / count


def slide_predict(apply_fn: Callable, images: torch.Tensor,
                  crop_size: tuple[int, int],
                  stride: tuple[int, int]) -> torch.Tensor:
    """The argmax class map (B, H, W) of the slide-averaged logits."""
    return slide_inference(apply_fn, images, crop_size, stride).argmax(dim=1)

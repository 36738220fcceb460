"""Image resampling as two matrix products.

Counterpart of `tunevlseg_tpu/ops/image.py:resize_2d` and `upsample_scale`.
With static sizes, `F.interpolate(mode="bilinear" / "bicubic" / "nearest")`
is a separable linear map with known sample positions, so a resize is

    out = W_rows @ img @ W_cols^T

with row-stochastic matrices that reproduce torch's numerics: the half-pixel
coordinate transform (or `align_corners`), the cubic kernel with A = -0.75,
and clamped (replicated) border taps. The port keeps this formulation rather
than calling `F.interpolate`: the products run in f32 like the JAX package's,
forward and backward are plain GEMMs (deterministic, where the interpolation
kernels' backward adds with atomics), and on an H100 the f32 bilinear
`F.interpolate` kernel took 44% of a CRIS forward (PERF.md).

Users: the vision position-embedding resizes (bicubic), the CRIS neck's and
projector's bilinear upsamples, the CRIS final bicubic `align_corners=True`
upsample and the additive head's bilinear resize, FreeSOLO's heads and
masks, zero-shot RIS's CLIP inputs and mask downsample ("nearest").
`crop_resize_bicubic_masked` (the counterpart of the JAX op of that name)
cuts and resizes every proposal's crop of the mask-filled image at once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

RESIZE_METHODS = ("bilinear", "bicubic", "nearest")


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(
        x <= 1.0, (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0))


def resize_matrix(in_size: int, out_size: int, mode: str,
                  align_corners: bool = False, out_pad: int = 0) -> np.ndarray:
    """(out_size + 2 * out_pad, in_size) row-stochastic interpolation matrix;
    `out_pad` repeats the first and the last row, which replicate-pads the
    output inside the same product."""
    if mode not in RESIZE_METHODS:
        raise ValueError(f"unknown resize mode: {mode}")
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    w = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    base = np.floor(src).astype(np.int64)
    frac = src - base
    if mode == "bilinear":
        taps = ((base, 1.0 - frac), (base + 1, frac))
    elif mode == "bicubic":
        taps = [(base + off, _cubic_kernel(frac - off)) for off in range(-1, 3)]
    else:   # torch "nearest": floor(dst * scale), no half-pixel shift
        taps = ((np.floor(rows * (in_size / out_size)).astype(np.int64), 1.0),)
    for tap, weight in taps:
        np.add.at(w, (rows, np.clip(tap, 0, in_size - 1)), weight)
    if out_pad:
        w = np.concatenate([np.repeat(w[:1], out_pad, 0), w,
                            np.repeat(w[-1:], out_pad, 0)])
    return w.astype(np.float32)


@functools.lru_cache(maxsize=128)
def _matrix_on(device: torch.device, *key) -> torch.Tensor:
    """The resize matrix of `key` as an f32 tensor on `device`, built once.

    Built outside every dispatch mode, so always a real tensor, also when
    the first call comes inside a `torch.export` trace: there the copy to
    `device` would otherwise give a fake tensor, which the cache would then
    hand to every later call (an eager call fails on it, and so does the
    next export). A trace takes the real matrix in as a constant of its
    program."""
    with _disable_current_modes():
        return torch.from_numpy(resize_matrix(*key)).to(device)


@functools.lru_cache(maxsize=16)
def _stats_on(device: torch.device, stats: tuple) -> tuple:
    """(mean, std) of `stats` as f32 (1, C, 1, 1) tensors on `device`, built
    once per device, outside every dispatch mode (as `_matrix_on`): a train
    step then makes no host-to-device copy, which a CUDA graph's capture
    refuses."""
    with _disable_current_modes():
        return tuple(torch.tensor(s, dtype=torch.float32).reshape(1, -1, 1, 1)
                     .to(device) for s in stats)


def normalize_uint8(image: torch.Tensor, stats) -> torch.Tensor:
    """uint8 (B, C, H, W) images as f32 (x / 255 - mean) / std, per channel,
    with `stats` = (mean, std)."""
    mean, std = _stats_on(image.device, tuple(tuple(s) for s in stats))
    return (image.float() / 255.0 - mean) / std


def resize_2d(img: torch.Tensor, out_hw: tuple[int, int],
              method: str = "bilinear", align_corners: bool = False,
              out_pad: int = 0) -> torch.Tensor:
    """Resize the trailing two axes of `img` (..., H, W) -> (..., H', W') with
    the numerics of `F.interpolate(mode=method, align_corners=align_corners)`
    (no antialiasing), as two f32 matrix products, returned in `img`'s dtype.
    `out_pad=p` replicate-pads the result by p on each side of H and W
    (-> H'+2p, W'+2p) inside the same products: what a "same" replicate
    convolution of kernel 2p+1 would pad itself."""
    h_in, w_in = img.shape[-2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out) and not out_pad:
        return img
    wr = _matrix_on(img.device, h_in, h_out, method, align_corners, out_pad)
    wc = _matrix_on(img.device, w_in, w_out, method, align_corners, out_pad)
    # columns first: one GEMM on the small input, then one batched product
    x = torch.matmul(img.float(), wc.T)
    return torch.matmul(wr, x).to(img.dtype)


def upsample_scale(img: torch.Tensor, scale: int,
                   method: str = "bilinear") -> torch.Tensor:
    """`nn.Upsample(scale_factor=scale, mode=method)` on (..., H, W)."""
    h, w = img.shape[-2:]
    return resize_2d(img, (h * scale, w * scale), method)


def _cubic_kernel_t(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """`_cubic_kernel` on a tensor."""
    x = x.abs()
    x2, x3 = x * x, x * x * x
    return torch.where(
        x <= 1.0, (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        torch.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a,
                    torch.zeros_like(x)))


def _crop_axis_taps(start: torch.Tensor, clen: torch.Tensor, n_in: int,
                    out_size: int):
    """Per-proposal bicubic taps for one axis of a crop-resize.

    `start` / `clen` (P,) int canvas origin and length in source
    coordinates. Returns (idx, weight, ok), each (4, P, out_size): the source
    index (clamped into the image), the cubic weight, and whether the CANVAS
    tap lands inside the image. Taps outside the canvas clamp to its edge
    first (the accumulation of `resize_matrix`), and the canvas is zero
    wherever it lies outside the image. Positions and weights are computed
    in f64 and rounded to f32 once, as `resize_matrix` builds its matrices:
    the JAX op's f32 source positions move the weights by ~1e-4 of the
    largest value at a 1024-px canvas (measured against the host crops)."""
    j = torch.arange(out_size, dtype=torch.float64, device=start.device)
    clen_f = clen[:, None].double()
    src = (j[None] + 0.5) * (clen_f / out_size) - 0.5       # (P, S), canvas space
    base = torch.floor(src)
    frac = src - base
    idxs, wgts, oks = [], [], []
    for m in range(-1, 3):
        cidx = torch.minimum(torch.clamp(base + m, min=0.0), clen_f - 1)
        aidx = start[:, None].double() + cidx
        oks.append(((aidx >= 0) & (aidx < n_in)).float())
        idxs.append(aidx.clamp(0, n_in - 1).long())
        wgts.append(_cubic_kernel_t(frac - m).float())
    return torch.stack(idxs), torch.stack(wgts), torch.stack(oks)


def crop_resize_bicubic_masked(image: torch.Tensor, masks: torch.Tensor,
                               boxes: torch.Tensor,
                               out_size: int) -> torch.Tensor:
    """`torchvision.resized_crop` of the mask-filled image for EVERY proposal
    at once, on the image's device: the zero-shot crop-feature path without
    the per-crop host loop (counterpart of
    `tunevlseg_tpu/ops/image.py:crop_resize_bicubic_masked`).

    image (C, H, W), masks (P, H, W) {0, 1}, boxes (P, 4) x1 y1 x2 y2.
    The crop canvas is the mask-filled image (fill = the image's per-channel
    mean) inside the image and ZERO outside it; bicubic (A = -0.75) with the
    taps clamped to the canvas edge; boxes truncated toward zero; degenerate
    boxes clamped to 1 px. Gathers and products over all P proposals in f32
    (the taps' positions and weights from f64, as `resize_matrix` builds
    them); returns (P, C, out_size, out_size) f32. Matches
    `ZeroShotRIS.host_crop_canvases` on the valid proposals."""
    c, h, w = image.shape
    image = image.float()
    masks = masks.float()
    p = masks.shape[0]
    mean = image.mean(dim=(1, 2))                           # (C,)
    bi = boxes.to(torch.int32)                              # trunc toward zero
    x1, y1, x2, y2 = bi.unbind(1)
    cw = torch.clamp(x2 - x1, min=1)
    ch = torch.clamp(y2 - y1, min=1)
    xi, xw, xo = _crop_axis_taps(x1, cw, w, out_size)       # (4, P, S)
    yi, yw, yo = _crop_axis_taps(y1, ch, h, out_size)
    s = out_size
    acc_w = torch.zeros(p, c, h, s, dtype=torch.float32, device=image.device)
    for m in range(4):
        img_cols = image[:, :, xi[m]].permute(2, 0, 1, 3)   # (P, C, H, S)
        m_cols = torch.gather(masks, 2, xi[m][:, None, :].expand(p, h, s))
        m_cols = m_cols[:, None]                            # (P, 1, H, S)
        fill = img_cols * m_cols + (1.0 - m_cols) * mean[None, :, None, None]
        acc_w = acc_w + fill * (xw[m] * xo[m])[:, None, None, :]
    acc = torch.zeros(p, c, s, s, dtype=torch.float32, device=image.device)
    for m in range(4):
        rows = torch.gather(acc_w, 2, yi[m][:, None, :, None].expand(p, c, s, s))
        acc = acc + rows * (yw[m] * yo[m])[:, None, :, None]
    return acc

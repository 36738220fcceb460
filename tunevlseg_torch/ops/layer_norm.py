"""N1: LayerNorm over the last axis in one pass, forward and backward, as
hand-written CUDA kernels.

The JAX package has no kernel here: Flax's `nn.LayerNorm(dtype=...)` is left
to XLA, which fuses the upcast, the f32 statistics, the affine and the
downcast into one pass. The port's `nn/layers.py` `LayerNorm` wrote the same
arithmetic as three passes on the card (an f32 copy of x, PyTorch's f32
layer_norm, a cast of y) and kept an f32 copy of x for the backward; N1
(`tunevlseg_torch/csrc/layer_norm.cu`, built by `ops/build.py`) is the one
pass, by hand:

  * forward: bfloat16 x, the f32 weight and optional f32 bias in, bfloat16
    y and each row's f32 mean and rstd out (every LayerNorm of the port's
    bf16 models takes and gives bfloat16); the statistics in f32 (an exact
    two-pass mean and biased variance, rstd = rsqrt(var + eps)), the affine
    in f32, one rounding of y;
  * backward: dx in f32, rounded once to bfloat16; dw and db as f32 partial
    sums over fixed runs of rows, added in a fixed order by a second kernel:
    deterministic, with no atomics. Skipped where the affine is frozen. The
    forward keeps x in bfloat16 for it, with the row statistics.

`engages` is the rule `LayerNorm.forward` takes N1 by: the last axis alone,
x on CUDA, bfloat16 in and out, D % 8 == 0 and D <= MAX_D.
Every other call keeps the plain chain, which `layer_norm_ref` writes out
(and which is the kernels' plain version: the same arithmetic up to the
order of the row sums). `LayerNorm.forward` counts those calls (`N1_PLAIN`).

The forward is the `torch.library` op `tunevlseg::layer_norm`
(`ops/library.py`) whose CUDA implementation is `n1_cuda` here, so that an
exported CUDA program keeps it; an eager call goes to the launcher
straight, without the dispatcher's round trip (`_forward`), and one no
gradient follows keeps no row statistics. Its launches are counted in
`_launch_fwd` (`N1`), the backward's in `_launch_bwd` (`N1_BWD`). A launch goes on
the current stream, does not synchronise and allocates only with
`torch.empty`: safe under CUDA-graph capture.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from tunevlseg_torch.ops import build
from tunevlseg_torch.utils import profiling

# the counters, in the registry of `utils/profiling.py`: N1's forward and
# backward launches, and the LayerNorm calls that took the plain chain
N1, N1_BWD, N1_PLAIN = "n1.launches", "n1.bwd_launches", "n1.plain"

MAX_D = 4096           # 128 threads a row, 4 vectors of 8 elements each
# blocks an SM of the backward that writes partial rows (its launch bounds):
# all of them resident at once
BWD_BLOCKS_PER_SM = 2

_lib: Optional[ctypes.CDLL] = None
_sm_count: dict = {}


def launch_count() -> int:
    """Number of N1 forward launches since the last `reset_launch_count`."""
    return profiling.counter(N1)


def bwd_launch_count() -> int:
    """Number of N1 backward launches since the last `reset_launch_count`."""
    return profiling.counter(N1_BWD)


def plain_count() -> int:
    """Number of LayerNorm calls that took the plain chain since the last
    `reset_launch_count`."""
    return profiling.counter(N1_PLAIN)


def reset_launch_count() -> None:
    """Set N1's counters to 0."""
    profiling.zero(N1, N1_BWD, N1_PLAIN)


def engages(normalized_shape, dtype: torch.dtype, out_dtype: torch.dtype,
            device: torch.device) -> bool:
    """Whether a LayerNorm over `normalized_shape` (its weight's shape) of an
    x of `dtype` on `device`, giving `out_dtype`, takes N1: the last axis
    alone, on CUDA, bfloat16 in and out (what every LayerNorm of the port's
    bf16 models takes and gives; an all-f32 call is one kernel already),
    D % 8 == 0 and D <= MAX_D."""
    return (len(normalized_shape) == 1 and device.type == "cuda"
            and dtype == torch.bfloat16 and out_dtype == torch.bfloat16
            and normalized_shape[0] % 8 == 0 and normalized_shape[0] <= MAX_D)


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor,
                   bias: Optional[torch.Tensor], eps: float,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The plain chain N1 replaces, and every call `engages` turns away:
    x to f32, PyTorch's f32 layer_norm over the weight's shape (one axis or
    several), y to `out_dtype`."""
    return F.layer_norm(x.float(), weight.shape, weight.float(),
                        None if bias is None else bias.float(), eps).to(out_dtype)


def load_library() -> ctypes.CDLL:
    """Build the kernels from source where needed (`ops/build.py`) and set
    the argument types of N1's entry points. A failed build raises."""
    global _lib
    if _lib is None:
        lib = build.load_libraries()["layer_norm"]
        lib.tvs_layer_norm_fwd.argtypes = ([ctypes.c_void_p] * 6
                                           + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_void_p])
        lib.tvs_layer_norm_fwd.restype = ctypes.c_int
        lib.tvs_layer_norm_bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                                           + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.tvs_layer_norm_bwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, contiguous and starting at a 16-byte aligned address (the kernels'
    vector loads); a copy only where it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> int:
    """Raise on anything N1 does not take: one test for the common case.
    Returns x's device index."""
    d = x.shape[-1] if x.dim() else 0
    index = x.get_device()
    if (x.dtype == torch.bfloat16 and out_dtype == torch.bfloat16
            and d % 8 == 0 and 0 < d <= MAX_D and index >= 0
            and weight.shape == (d,) and weight.dtype == torch.float32
            and weight.get_device() == index
            and (bias is None or (bias.shape == (d,) and bias.dtype == torch.float32
                                  and bias.get_device() == index))):
        return index
    raise ValueError(
        f"N1 normalises the last axis of a CUDA x, D % 8 == 0 and D <= {MAX_D}, "
        f"bfloat16 in and out, with an f32 (D,) weight and bias on x's device: got x {tuple(x.shape)} {x.dtype} on {x.device} -> {out_dtype}, "
        f"weight {tuple(weight.shape)} {weight.dtype} on {weight.device}, bias "
        + ("None" if bias is None else
           f"{tuple(bias.shape)} {bias.dtype} on {bias.device}"))


def _stream_on(index: int):
    """(a context on the device `index`, the current stream's handle there):
    the C entries launch on the current device, so switch only where it is
    another (the switch costs microseconds of an eager call's host time)."""
    context = (torch.cuda.device(index) if index != torch.cuda.current_device()
               else contextlib.nullcontext())
    return context, torch._C._cuda_getCurrentRawStream(index)


def _launch_fwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                eps: float, out_dtype: torch.dtype, stats: bool):
    """One N1 forward launch: (y, mean, rstd), y of x's shape in `out_dtype`,
    mean and rstd f32 of x's leading shape; without `stats` (a call no
    gradient follows) (y, None, None), and the kernel writes no statistics."""
    index = _check(x, weight, bias, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean = rstd = None
    if stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return y, mean, rstd
    x, weight = _aligned(x), _aligned(weight)
    bias = None if bias is None else _aligned(bias)
    lib = load_library()
    context, stream = _stream_on(index)
    with context:
        err = lib.tvs_layer_norm_fwd(
            x.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), mean.data_ptr() if stats else None,
            rstd.data_ptr() if stats else None, rows, d, eps, stream)
    if err != 0:
        raise RuntimeError(f"N1 launch failed: cudaError {err} (x {tuple(x.shape)} "
                           f"{x.dtype} -> {out_dtype})")
    profiling.count(N1)
    return y, mean, rstd


def n1_cuda(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            eps: float, out_dtype: torch.dtype):
    """The CUDA implementation of `tunevlseg::layer_norm`: one N1 forward
    launch, (y, mean, rstd)."""
    return _launch_fwd(x, weight, bias, eps, out_dtype, True)


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             eps: float, out_dtype: torch.dtype, stats: bool = True):
    """(y, mean, rstd), the statistics None in an eager call without
    `stats`. Through the op wherever a trace may see the call
    (`torch.export` and `torch.compile` trace fake tensors, and the op is what
    their program holds); an eager call on a plain tensor goes to the
    launcher straight, saving the dispatcher's round trip of host time."""
    if type(x) is torch.Tensor and not torch.compiler.is_compiling():
        return _launch_fwd(x, weight, bias, eps, out_dtype, stats)
    return library.layer_norm(x, weight, bias, eps, out_dtype)


def _sm_count_of(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def _launch_bwd(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                mean: torch.Tensor, rstd: torch.Tensor, want_dx: bool,
                want_dw: bool, want_db: bool):
    """One N1 backward: (dx or None, dw or None, db or None) for the output
    gradient dy, from the forward's x, weight and row statistics."""
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x, memory_format=torch.contiguous_format) if want_dx else None
    if rows == 0 or not (want_dx or want_dw or want_db):
        # no rows: the affine's gradients are empty sums
        return (dx, torch.zeros_like(weight) if want_dw else None,
                torch.zeros_like(weight) if want_db else None)
    dw = torch.empty_like(weight) if want_dw else None
    db = torch.empty_like(weight) if want_db else None
    dy, x = _aligned(dy), _aligned(x)
    if dy.shape != x.shape or dy.dtype != torch.bfloat16:
        raise ValueError(f"N1: gradient {tuple(dy.shape)} {dy.dtype} for bfloat16 x "
                         f"{tuple(x.shape)}")
    part, blocks = None, 0
    if want_dw or want_db:
        blocks = BWD_BLOCKS_PER_SM * _sm_count_of(x.device)
        part = torch.empty(blocks, 2, d, dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = load_library()
    context, stream = _stream_on(x.get_device())
    with context:
        err = lib.tvs_layer_norm_bwd(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            weight.data_ptr(), ptr(dx), ptr(part), ptr(dw), ptr(db), rows, d, blocks,
            stream)
    if err != 0:
        raise RuntimeError(f"N1 backward launch failed: cudaError {err} (x "
                           f"{tuple(x.shape)} {x.dtype}, dy {dy.dtype})")
    profiling.count(N1_BWD)
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):
    """N1 forward and backward. Keeps x in its own dtype, the weight and the
    row statistics; the backward computes only the gradients asked for."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, out_dtype):
        y, mean, rstd = _forward(x, weight, bias, eps, out_dtype)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        want_dx, want_dw, want_db = ctx.needs_input_grad[:3]
        dx, dw, db = _launch_bwd(dy, x, weight, mean, rstd, want_dx, want_dw,
                                 want_db and ctx.has_bias)
        return dx, dw, db, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of x over its last axis through N1, y in `out_dtype`: the
    weight and bias are used in f32. For calls `engages` takes; a gradient
    goes through N1's backward (the autograd.Function, taken only when one is
    wanted)."""
    weight = weight.float()
    bias = None if bias is None else bias.float()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or (
            bias is not None and bias.requires_grad)):
        return _LayerNorm.apply(x, weight, bias, eps, out_dtype)
    return _forward(x, weight, bias, eps, out_dtype, stats=False)[0]


# the op the wrapper calls; registering it needs this module's launcher
from tunevlseg_torch.ops import library  # noqa: E402

"""S1-S4: the variants of K1 that the attention sweeps time.

Counterparts of the Pallas kernels in the JAX package's sweep scripts:
`scripts/micro_attn.py: make_hg` (S1), `scripts/micro_attn_v2.py:
batched_heads` (S2) and `batched_heads_opt` (S3), and
`scripts/micro_attn_grid.py: make` (S4). The CUDA C++ source is
`tunevlseg_torch/csrc/flash_attn_fwd_variants.cu`: one kernel for S1, S2 and
S4 (`attention_variant`: heads and batch rows per block, the block order,
exp2, no max pass, the two products without a softmax), which is K1's own
forward body (`csrc/attn_fwd_hopper.cuh`: wgmma from a TMA ring, two
consumer warpgroups) with the switches as its softmax policy, and one for S3
(`attention_ones_column`: scale folded into q, the mask as an additive row,
the softmax denominator out of the P V product) on the same wgmma / TMA
building blocks (`csrc/attn_hopper.cuh`, shared with K2). They are built into a
library of their own at the first sweep (`ops/build.py`), so serving and
training never build them, and no model calls them: the models' forward is
K1 (`ops/flash_attention.py`), and `nn/attention.py` does not know this
module. `scripts/torch_micro_attn.py` is their entry point.

CUDA tensors go through the kernels or raise (bf16, head dim 64, contiguous,
16-byte aligned, `hg` dividing H and `bg` dividing B); CPU tensors take the plain versions
`attention_variant_ref` and `attention_ones_column_ref`, which repeat the
kernels' arithmetic step by step where a switch changes the value.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tunevlseg_torch.ops import build
from tunevlseg_torch.ops.flash_attention import (_check_aligned, _check_kernel_inputs,
                                                 _seq_strides)

HEAD_DIM = 64          # the only head dim the variants are instantiated for
KEY_TILE = 64          # keys per ring stage of S3's kernel; its mask row is padded to it
LOG2E = 1.4426950408889634
MASKED = -1e30         # S3's additive mask on a key that is not attended
BLOCK_ORDERS = ("query", "head")   # which index of a block moves fastest

_lib: Optional[ctypes.CDLL] = None
_launches = {"variant": 0, "ones_column": 0}


def launch_count(kernel: str) -> int:
    """Launches of "variant" (S1, S2, S4) or "ones_column" (S3) since the
    last `reset_launch_count`."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for kernel in _launches:
        _launches[kernel] = 0


def load_library() -> ctypes.CDLL:
    """Build the variants' library where needed and set the argument types
    of its two entry points. A failed build raises."""
    global _lib
    if _lib is None:
        lib = build.load_libraries(sweeps=True)["variants"]
        lib.tvs_attn_variant.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        lib.tvs_attn_variant.restype = ctypes.c_int
        lib.tvs_attn_ones_column.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        lib.tvs_attn_ones_column.restype = ctypes.c_int
        _lib = lib
    return _lib


def _masked_scores(scores: torch.Tensor, t_valid: int) -> torch.Tensor:
    col = torch.arange(scores.shape[-1], device=scores.device)
    return scores.masked_fill(col >= t_valid, float("-inf"))


def attention_variant_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[int] = None, *,
                          use_exp2: bool = False, skip_max: bool = False,
                          gemm_only: bool = False, **blocking) -> torch.Tensor:
    """Plain PyTorch version of `attention_variant`. (B, S, H, D) in and out.

    f32 scores times the f32 scale (D^-1/2, times log2(e) with `use_exp2`);
    keys >= kv_valid at -inf; p = exp (or exp2) of the scores less their row
    maximum, or of the scores as they are with `skip_max`; p cast to v's
    dtype for the P V product (f32 accumulation); the denominator the f32 sum
    of the unrounded p. `gemm_only` is (q kᵀ · scale) v over all T keys with
    the scaled scores cast to v's dtype, no softmax and no mask. `hg`, `bg`
    and `block_order` change how the kernel cuts its grid, not its value, and
    are ignored."""
    d = q.shape[-1]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    if use_exp2:
        scale = scale * torch.tensor(LOG2E, dtype=torch.float32)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale.to(q.device)
    if gemm_only:
        out = torch.einsum("bhst,bthd->bhsd", scores.to(v.dtype).float(), v.float())
        return out.transpose(1, 2).to(q.dtype)
    scores = _masked_scores(scores, k.shape[1] if kv_valid is None else kv_valid)
    if not skip_max:
        scores = scores - scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores) if use_exp2 else torch.exp(scores)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(), v.float())
    return (out / denom).transpose(1, 2).to(q.dtype)


def fold_scale(q: torch.Tensor) -> torch.Tensor:
    """q · D^-1/2 · log2(e) in q's dtype (the factor rounded to it first),
    as S3's kernel multiplies its Q tile in shared memory."""
    return q * torch.tensor(q.shape[-1] ** -0.5 * LOG2E, dtype=q.dtype,
                            device=q.device)


def mask_row(t: int, t_valid: int, device) -> Optional[torch.Tensor]:
    """S3's additive f32 mask: 0 on the first `t_valid` keys, -1e30 beyond,
    padded to whole key tiles; None when there is nothing to mask."""
    padded = math.ceil(t / KEY_TILE) * KEY_TILE
    if t_valid == padded:
        return None
    row = torch.full((padded,), MASKED, dtype=torch.float32, device=device)
    row[:t_valid] = 0.0
    return row


def attention_ones_column_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_valid: Optional[int] = None, *,
                              skip_max: bool = False, **blocking) -> torch.Tensor:
    """Plain PyTorch version of `attention_ones_column` (S3), with its
    arithmetic: q times the folded scale in the input dtype, f32 scores, the
    f32 mask row added, p = exp2 of the scores less their row maximum (or as
    they are with `skip_max`), p cast to v's dtype, then ONE product of p with
    [v | 1]: its last column is the denominator, the f32 sum of the ROUNDED
    p. (B, S, H, D) in and out."""
    t = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", fold_scale(q).float(), k.float())
    row = mask_row(t, t if kv_valid is None else kv_valid, q.device)
    if row is not None:
        scores = scores + row[:t]
    if not skip_max:
        scores = scores - scores.amax(dim=-1, keepdim=True)
    p = torch.exp2(scores).to(v.dtype).float()
    ones = torch.ones(*v.shape[:-1], 1, dtype=torch.float32, device=v.device)
    acc = torch.einsum("bhst,bthd->bhsd", p, torch.cat([v.float(), ones], dim=-1))
    out = acc[..., :-1] * (1.0 / acc[..., -1:])
    return out.transpose(1, 2).to(q.dtype)


def _check_blocking(q, hg: int, bg: int, block_order: str) -> None:
    b, _, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the variants take head dim {HEAD_DIM}, got {d}")
    if hg < 1 or h % hg:
        raise ValueError(f"hg={hg} must divide the {h} heads")
    if bg < 1 or b % bg:
        raise ValueError(f"bg={bg} must divide the batch of {b}")
    if block_order not in BLOCK_ORDERS:
        raise ValueError(f"block_order must be one of {BLOCK_ORDERS}")


def attention_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_valid: Optional[int] = None, *, hg: int = 1, bg: int = 1,
                      use_exp2: bool = False, skip_max: bool = False,
                      gemm_only: bool = False,
                      block_order: str = "query") -> torch.Tensor:
    """softmax(q kᵀ / √D) v as K1 computes it, with K1's choices as switches
    (S1, S2, S4): a block works through `hg` heads x `bg` batch rows of one
    query tile; `block_order` says whether neighbouring blocks differ in the
    query tile (one head's K and V shared in L2) or in the head; `use_exp2`
    folds log2(e) into the scale; `skip_max` drops the running maximum and
    the rescale (an experiment: it overflows on large scores); `gemm_only` is
    (q kᵀ · scale) v, the two products alone, and takes no other switch.
    (B, S, H, 64) bf16 in and out; no gradient."""
    if gemm_only and (use_exp2 or skip_max):
        raise ValueError("gemm_only has no softmax: use_exp2 and skip_max do not apply")
    _check_blocking(q, hg, bg, block_order)
    if q.device.type == "cpu":
        return attention_variant_ref(q, k, v, kv_valid, use_exp2=use_exp2,
                                     skip_max=skip_max, gemm_only=gemm_only)
    t_valid = _check_kernel_inputs(q, k, v, kv_valid, kernel="S1/S2/S4")
    _check_aligned("S1/S2/S4", q=q, k=k, v=v)
    lib = load_library()
    o = torch.empty_like(q)
    b, s, h, d = q.shape
    flags = int(use_exp2) | int(skip_max) << 1 | int(gemm_only) << 2
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tvs_attn_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
            k.shape[1], h, d, t_valid, flags, hg, bg, int(block_order == "head"),
            _seq_strides(q, k, v, o), stream)
    if err != 0:
        raise RuntimeError(f"attention variant launch failed: cudaError {err}")
    _launches["variant"] += 1
    return o


def attention_ones_column(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid: Optional[int] = None, *, hg: int = 1,
                          bg: int = 1, skip_max: bool = False,
                          block_order: str = "query") -> torch.Tensor:
    """softmax(q kᵀ / √D) v by S3's recipe: the kernel multiplies q by the
    bf16 factor D^-1/2 · log2(e) (as `fold_scale`), adds an f32 mask row to
    the scores, takes exp2, and has the P V step emit the softmax denominator
    as a product of the same p with a column of ones. (B, S, H, 64) bf16 in
    and out; no gradient. The denominator is the sum of the bf16-rounded p,
    so the result differs from K1's by up to about 2^-9 relative before the
    output's own rounding."""
    _check_blocking(q, hg, bg, block_order)
    if q.device.type == "cpu":
        return attention_ones_column_ref(q, k, v, kv_valid, skip_max=skip_max)
    t_valid = _check_kernel_inputs(q, k, v, kv_valid, kernel="S3")
    _check_aligned("S3", q=q, k=k, v=v)
    lib = load_library()
    row = mask_row(k.shape[1], t_valid, q.device)
    o = torch.empty_like(q)
    b, s, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tvs_attn_ones_column(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if row is None else row.data_ptr(), o.data_ptr(), b, s,
            k.shape[1], h, d, int(skip_max), hg, bg, int(block_order == "head"),
            _seq_strides(q, k, v, o), stream)
    if err != 0:
        raise RuntimeError(f"S3 launch failed: cudaError {err}")
    _launches["ones_column"] += 1
    return o

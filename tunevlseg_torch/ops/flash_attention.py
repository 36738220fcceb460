"""K1, K2 and K3: unbiased self-attention forward and backward, and the
biased / cross-attention forward, as hand-written Hopper kernels.

Counterpart of `tunevlseg_tpu/ops/flash_attention.py`: K1 replaces
`_forward_batched_heads`, K2 replaces `_backward_batched_heads`, K3 replaces
`_forward`. The CUDA C++ sources are `tunevlseg_torch/csrc/flash_attn_fwd.cu`,
`flash_attn_bwd.cu` and `flash_attn_bias_fwd.cu` (K1's forward body, one
producer warp feeding two consumer warpgroups with wgmma from a TMA ring, in
`attn_fwd_hopper.cuh`; K3 the same structure cut for short key sequences,
its 80-key tiles resident while the query tiles stream past them; the wgmma /
TMA building blocks all three share in `attn_hopper.cuh` and `hopper.cuh`);
all are built with `nvcc` for `sm_90a` into plain C shared libraries at
first use (`ops/build.py`) and called through `ctypes` on PyTorch's current
stream. K1 and K3 are `torch.library` custom ops (`ops/library.py`:
`tunevlseg::flash_attn_fwd`, `tunevlseg::biased_attn_fwd`) whose CUDA
implementations are `k1_cuda` and `k3_cuda` here, so that a `torch.export`
trace (on fake tensors, which have no data pointer) keeps them in the
program; the launch counts are kept by those implementations, so they count
the launches of a loaded program too and none of a trace.

`flash_attention` takes K1 for CUDA tensors and raises on anything the kernel
does not take; its gradient is K2 (`flash_attention_bwd`), launched by the
backward of the `autograd.Function`. When a gradient is wanted, K1 also
writes each row's log-sum-exp (log2 domain) and the Function keeps it with
q, k and v: K2 forms p from it. `biased_attention` takes K3 for CUDA
tensors: an optional f32 bias broadcastable to (B, H, S, T), read in place
through its strides, and S != T allowed; like the TPU kernel it has no
backward kernel, its gradient recomputes through `nn.attention.plain_attention`.
There is no fallback: a CUDA call launches the kernels or raises. For CPU
tensors the wrappers run `flash_attention_ref`, `flash_attention_bwd_ref` and
`biased_attention_ref`, the kernels' plain PyTorch versions with the same
numerics.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from tunevlseg_torch.ops import build
from tunevlseg_torch.utils import profiling

SUPPORTED_HEAD_DIMS = (16, 32, 64, 96)

# the launch counters, in the registry of `utils/profiling.py`
K1, K2, K3 = "k1.launches", "k2.launches", "k3.launches"

_libs: Optional[dict[str, ctypes.CDLL]] = None


def launch_count() -> int:
    """Number of K1 launches since the last `reset_launch_count`."""
    return profiling.counter(K1)


def bwd_launch_count() -> int:
    """Number of K2 launches since the last `reset_launch_count`."""
    return profiling.counter(K2)


def bias_launch_count() -> int:
    """Number of K3 launches since the last `reset_launch_count`."""
    return profiling.counter(K3)


def reset_launch_count() -> None:
    """Set the K1, K2 and K3 launch counts to 0."""
    profiling.zero(K1, K2, K3)


def load_library() -> dict[str, ctypes.CDLL]:
    """Build the kernels from source where needed (`ops/build.py`) and set
    the argument types of K1's, K2's and K3's entry points; returns
    {"fwd": lib, "bwd": lib, "bias": lib, ...}. A failed build raises."""
    global _libs
    if _libs is not None:
        return _libs
    libs = build.load_libraries()
    fwd = libs["fwd"].tvs_flash_attn_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = libs["bwd"].tvs_flash_attn_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    biased = libs["bias"].tvs_biased_attn_fwd
    biased.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.POINTER(ctypes.c_longlong)] * 2
                       + [ctypes.c_void_p])
    biased.restype = ctypes.c_int
    _libs = libs
    return libs


def biased_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         kv_valid: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K3 with the kernel's numerics: f32 scores,
    the bias (broadcastable to (B, H, S, T)) added in f32, f32 softmax, p
    cast to v's dtype for the PV product (f32 accumulation), the denominator
    the f32 sum of the unrounded p. Keys at index >= kv_valid get exactly
    zero probability. q (B, S, H, D), k and v (B, T, H, D); (B, S, H, D) out.
    Unlike `nn.attention.plain_attention` it does not round the scores to the
    input dtype before the bias add."""
    d = q.shape[-1]
    t = k.shape[1] if kv_valid is None else kv_valid
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * d ** -0.5
    if bias is not None:
        scores = scores + bias.float()
    col = torch.arange(k.shape[1], device=q.device)
    scores = scores.masked_fill(col >= t, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(), v.float())
    return (out / denom).transpose(1, 2).to(q.dtype)


LOG2E = 1.4426950408889634


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[int] = None, return_lse: bool = False):
    """Plain PyTorch version of K1 with the kernel's numerics, which are
    K3's without a bias: f32 scores and softmax, p cast to v's dtype for the
    PV product (f32 accumulation), the denominator the f32 sum of the
    unrounded p. Keys at index >= kv_valid get exactly zero probability.
    (B, S, H, D) in and out. With `return_lse`, returns (out, lse) with lse
    the f32 (B, H, S) log-sum-exp of the scores in the log2 domain, as K1
    writes it for K2: log2 Σⱼ exp2(s·log2(e)) over the unmasked keys."""
    out = biased_attention_ref(q, k, v, None, kv_valid)
    if not return_lse:
        return out
    return out, _lse2(q, k, kv_valid)


def _lse2(q, k, kv_valid) -> torch.Tensor:
    """(B, H, S) f32 log-sum-exp of the log2-domain scores, masked keys out."""
    t = k.shape[1] if kv_valid is None else kv_valid
    s2 = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * (q.shape[-1] ** -0.5 * LOG2E)
    s2 = s2.masked_fill(torch.arange(k.shape[1], device=q.device) >= t, float("-inf"))
    top = s2.amax(dim=-1, keepdim=True)
    return (top + torch.log2(torch.exp2(s2 - top).sum(dim=-1, keepdim=True))).squeeze(-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            g: torch.Tensor, kv_valid: Optional[int] = None, *,
                            lse: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K2 with the kernel's numerics: p =
    softmax(q kᵀ / √D) in f32 (keys >= kv_valid get p = 0), dv = pᵀ g,
    dp = g vᵀ, δ = Σⱼ p·dp, ds = p (dp - δ) / √D, dq = ds k, dk = dsᵀ q.
    Without `lse`, p is recomputed from q and k alone (e / Σe); with the
    forward's log2-domain log-sum-exp `lse` ((B, H, S) f32, as K1 writes
    it), p = exp2(s·√D⁻¹·log2(e) - lse), as K2 takes it: the same in exact
    arithmetic. p and ds are rounded to the input dtype as operands of their
    products, every product accumulates in f32, and g is cast to q's dtype
    first. Masked keys get exactly zero dk and dv rows. (B, S, H, D) in;
    returns (dq, dk, dv) in the input dtypes."""
    d = q.shape[-1]
    scale = d ** -0.5
    t = k.shape[1] if kv_valid is None else kv_valid
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.to(q.dtype).float()
    col = torch.arange(k.shape[1], device=q.device)
    if lse is None:
        scores = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
        scores = scores.masked_fill(col >= t, float("-inf"))
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        s2 = torch.einsum("bshd,bthd->bhst", qf, kf) * (scale * LOG2E)
        p = torch.exp2(s2 - lse.float()[..., None]).masked_fill(col >= t, 0.0)
    dv = torch.einsum("bhst,bshd->bthd", p.to(q.dtype).float(), gf)
    dp = torch.einsum("bshd,bthd->bhst", gf, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.einsum("bhst,bthd->bshd", ds, kf)
    dk = torch.einsum("bhst,bshd->bthd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(q, k, v, kv_valid, kernel: str = "K1") -> int:
    """Raise on anything the kernels do not take; return the valid key count."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{kernel} needs CUDA tensors; {name} is on {x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{kernel} takes bfloat16; {name} is {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{kernel} takes (B, S, H, D); {name} has shape "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous inputs; {name} is not")
        st = x.stride()
        if st[0] % 8 or st[1] % 8 or st[2] % 8:
            # TMA reads every row through the strides, 16-byte steps only (a
            # dimension of size 1 may have any stride in a contiguous tensor)
            raise ValueError(f"{kernel} needs (batch, seq, head) strides that are "
                             f"multiples of 8 elements; {name} has {st}")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
    b, s, h, d = q.shape
    t = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{kernel} takes head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if k.shape != (b, t, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (0 < b <= 65535 and 0 < h <= 65535 and s > 0 and t > 0):
        raise ValueError(f"{kernel} grid out of range for shape {tuple(q.shape)}")
    t_valid = t if kv_valid is None else int(kv_valid)
    if not 1 <= t_valid <= t:
        raise ValueError(f"kv_valid={kv_valid} must lie in [1, {t}]")
    return t_valid


def _check_aligned(kernel: str, **tensors) -> None:
    """Raise unless every tensor given (None is skipped) starts at a 16-byte
    aligned address, as TMA reads it. The launchers call it on real tensors:
    a traced call has no addresses."""
    for name, x in tensors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{kernel} needs 16-byte aligned inputs; {name} is not")


def _seq_strides(*tensors) -> ctypes.Array:
    """(batch, seq, head) strides in elements of each (B, S, H, D) tensor."""
    values = [n for x in tensors for n in x.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def k1_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, t_valid: int,
            with_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One K1 launch: the CUDA implementation of `tunevlseg::flash_attn_fwd`
    on inputs `_check_kernel_inputs` took. Returns (o, lse): lse the f32
    (B, H, S) log2-domain log-sum-exp with `with_lse`, else an empty f32
    tensor (an op returns tensors only)."""
    _check_aligned("K1", q=q, k=k, v=v)
    lib = load_library()["fwd"]
    o = torch.empty_like(q)
    b, s, h, d = q.shape
    lse = torch.empty((b, h, s) if with_lse else (0,), dtype=torch.float32,
                      device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tvs_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr() if with_lse else None,
                                     b, s, h, d, t_valid, _seq_strides(q, k, v, o), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    profiling.count(K1)
    return o, lse


def _launch(q, k, v, t_valid, with_lse: bool = False):
    """K1 through its op: the output, or (output, lse) with `with_lse`."""
    o, lse = library.flash_attn_fwd(q, k, v, t_valid, with_lse)
    return (o, lse) if with_lse else o


def _kernel_readable(g: torch.Tensor) -> bool:
    """Whether K2 can read a gradient in place: unit stride on D and every
    row 16-byte aligned (TMA reads its rows through the strides)."""
    return (g.stride(3) == 1 and g.data_ptr() % 16 == 0
            and all(g.stride(i) % 8 == 0 for i in range(3)))


# K2 pads its per-row (lse, δ) scratch to whole blocks of its dq pass: 192
# rows at D <= 64, 128 at D = 96
STATS_ROWS = 384


def _launch_bwd(q, k, v, g, t_valid, lse):
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"K2: gradient {tuple(g.shape)} on {g.device} does not "
                         f"match q {tuple(q.shape)} on {q.device}")
    b, s, h, d = q.shape
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"K2: lse must be f32 (B, H, S) = {(b, h, s)}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    g = g.to(q.dtype)
    if not _kernel_readable(g):
        g = g.contiguous()       # a copy K2's caller pays for: rare layouts only
    lib = load_library()["bwd"]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # (lse, δ) of every query row, padded: written by K2's dq pass for its
    # dk / dv pass
    s_pad = -(-s // STATS_ROWS) * STATS_ROWS
    stats = torch.empty(b, h, s_pad, 2, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tvs_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, s,
            s_pad, k.shape[1], h, d, t_valid, _seq_strides(q, k, v, g, dq, dk, dv), stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err} (q {tuple(q.shape)}, "
                           f"g strides {g.stride()}, kv_valid {t_valid})")
    profiling.count(K2)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2 backward. Only when one of q, k, v needs a gradient
    does K1 write the log-sum-exp, and q, k, v and the log-sum-exp are kept
    for K2 (a frozen tower saves nothing)."""

    @staticmethod
    def forward(ctx, q, k, v, t_valid):
        ctx.t_valid = t_valid
        if not any(ctx.needs_input_grad[:3]):
            return _launch(q, k, v, t_valid)
        o, lse = _launch(q, k, v, t_valid, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, grad, ctx.t_valid, lse)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ / √D) v for (B, S, H, D) inputs, keys >= kv_valid masked.

    CUDA tensors go through K1 (bf16, D in {16, 32, 64, 96}, contiguous, no
    bias) or raise, and differentiate through K2 (the autograd.Function,
    taken only when a gradient is wanted); CPU tensors take
    `flash_attention_ref`."""
    if bias is not None:
        raise ValueError("K1 takes no bias; biased attention is K3, "
                         "biased_attention")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_valid)
    t_valid = _check_kernel_inputs(q, k, v, kv_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, t_valid)
    return _launch(q, k, v, t_valid)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, kv_valid: Optional[int] = None, *,
                        lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of `flash_attention(q, k, v, kv_valid)` for the output
    gradient g, given the forward's log2-domain log-sum-exp `lse` as K1
    writes it (a train step has it), or not.

    CUDA tensors go through K2 (the same inputs K1 takes; g may be a strided
    view) or raise; without lse, K1 runs first to make it (a K1 launch).
    CPU tensors take `flash_attention_bwd_ref`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, g, kv_valid, lse=lse)
    t_valid = _check_kernel_inputs(q, k, v, kv_valid, kernel="K2")
    if lse is None:
        _, lse = _launch(q, k, v, t_valid, with_lse=True)
    return _launch_bwd(q, k, v, g, t_valid, lse)


def _check_bias(bias: torch.Tensor, q: torch.Tensor, t: int) -> None:
    """Raise on a bias K3 does not take."""
    b, s, h, _ = q.shape
    if bias.device != q.device:
        raise ValueError(f"K3: bias on {bias.device}, q on {q.device}")
    if bias.dtype != torch.float32:
        raise ValueError(f"K3 takes a float32 bias, got {bias.dtype}")
    full = (b, h, s, t)
    if bias.dim() != 4 or any(n not in (1, m) for n, m in zip(bias.shape, full)):
        raise ValueError(f"K3: bias {tuple(bias.shape)} does not broadcast to "
                         f"(B, H, S, T) = {full}")


def _bias_strides(bias: torch.Tensor) -> ctypes.Array:
    """The (batch, head, query, key) strides in elements of a bias that
    `_check_bias` took, 0 on every dimension it broadcasts over."""
    values = [0 if n == 1 else st for n, st in zip(bias.shape, bias.stride())]
    return (ctypes.c_longlong * 4)(*values)


def _launch_biased(q, k, v, bias, t_valid) -> torch.Tensor:
    """K3 through its op, on inputs `_check_kernel_inputs` took."""
    if bias is not None:
        _check_bias(bias, q, k.shape[1])
    return library.biased_attn_fwd(q, k, v, bias, t_valid)


def k3_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: Optional[torch.Tensor], t_valid: int) -> torch.Tensor:
    """One K3 launch: the CUDA implementation of `tunevlseg::biased_attn_fwd`
    on inputs `_launch_biased` took."""
    _check_aligned("K3", q=q, k=k, v=v)
    bias_strides = None if bias is None else _bias_strides(bias)
    lib = load_library()["bias"]
    o = torch.empty_like(q)
    b, s, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # the C entry launches on the current device: switch to q's only where it
    # is another (the switch costs microseconds of the b1 request's host time)
    switch = (torch.cuda.device(q.device) if q.device.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        err = lib.tvs_biased_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), o.data_ptr(), b, s, h, d,
            t_valid, _seq_strides(q, k, v, o), bias_strides, stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    profiling.count(K3)
    return o


class _BiasedAttention(torch.autograd.Function):
    """K3 forward (its plain version for CPU tensors); the backward recomputes
    through `plain_attention`, as the TPU kernel's does through the plain JAX
    attention. q, k, v and the bias are kept only when a gradient is wanted."""

    @staticmethod
    def forward(ctx, q, k, v, bias, kv_valid):
        ctx.kv_valid = kv_valid
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            return biased_attention_ref(q, k, v, bias, kv_valid)
        return _launch_biased(q, k, v, bias, k.shape[1] if kv_valid is None
                              else kv_valid)

    @staticmethod
    def backward(ctx, grad):
        from tunevlseg_torch.nn.attention import plain_attention
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = plain_attention(*qkv, bias, kv_valid=ctx.kv_valid)
        dq, dk, dv = torch.autograd.grad(out, qkv, grad.to(out.dtype))
        return dq, dk, dv, None, None


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     kv_valid: Optional[int] = None) -> torch.Tensor:
    """softmax(q kᵀ / √D + bias) v for q (B, S, H, D) and k, v (B, T, H, D),
    keys >= kv_valid masked; `bias` is None or f32, broadcastable to
    (B, H, S, T), and takes no gradient.

    CUDA tensors go through K3 (bf16, D in {16, 32, 64, 96}, contiguous q,
    k, v; the bias through its own strides) or raise; CPU tensors take
    `biased_attention_ref`. The gradient recomputes through
    `plain_attention` on either device (the autograd.Function, taken on the
    card only when a gradient is wanted)."""
    if bias is not None and bias.requires_grad:
        raise ValueError("K3 gives the bias no gradient")
    if q.device.type != "cpu":
        t_valid = _check_kernel_inputs(q, k, v, kv_valid, kernel="K3")
        if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                             or v.requires_grad)):
            return _launch_biased(q, k, v, bias, t_valid)
    return _BiasedAttention.apply(q, k, v, bias, kv_valid)


# the ops the wrappers call; registering them needs this module's launchers
from tunevlseg_torch.ops import library  # noqa: E402

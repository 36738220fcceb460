"""K1, the unbiased self-attention forward, as a hand-written Hopper kernel.

Counterpart of `tunevlseg_tpu/ops/flash_attention.py:_forward_batched_heads`.
The CUDA C++ source is `tunevlseg_torch/csrc/flash_attn_fwd.cu`; it is built
with `nvcc` for `sm_90a` into a plain C shared library at first use (under
`tunevlseg_torch/_build/`, keyed by a hash of the source and flags) and
called through `ctypes` on PyTorch's current stream.

`flash_attention` takes the kernel for CUDA tensors and raises on anything
the kernel does not take; for CPU tensors it runs `flash_attention_ref`, the
kernel's plain PyTorch version with the same numerics. The gradient (K2) is
not ported yet: the backward raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "flash_attn_fwd.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SUPPORTED_HEAD_DIMS = (16, 32, 64)

_lib: Optional[ctypes.CDLL] = None
_launches = 0


def launch_count() -> int:
    """Number of K1 launches since the last `reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"flash_attn_fwd-{digest}.so"


def load_library() -> ctypes.CDLL:
    """Build K1 from source if needed and load it. A failed build raises;
    the compiler's output (with `ptxas -v` register and spill counts) is kept
    beside the library as `<name>.log`."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {_SOURCE}:\n"
                f"{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    fn = lib.tvs_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K1 with the kernel's numerics: f32 scores and
    softmax, p cast to v's dtype for the PV product (f32 accumulation), the
    denominator the f32 sum of the unrounded p. Keys at index >= kv_valid get
    exactly zero probability. (B, S, H, D) in and out."""
    d = q.shape[-1]
    t = k.shape[1] if kv_valid is None else kv_valid
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * d ** -0.5
    col = torch.arange(k.shape[1], device=q.device)
    scores = scores.masked_fill(col >= t, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhst,bthd->bhsd", p.to(v.dtype).float(), v.float())
    return (out / denom).transpose(1, 2).to(q.dtype)


def _check_kernel_inputs(q, k, v, kv_valid) -> int:
    """Raise on anything K1 does not take; return the valid key count."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"K1 needs CUDA tensors; {name} is on {x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"K1 takes bfloat16; {name} is {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"K1 takes (B, S, H, D); {name} has shape "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"K1 takes contiguous inputs; {name} is not")
        if x.data_ptr() % 16:
            raise ValueError(f"K1 needs 16-byte aligned inputs; {name} is not")
        if x.device != q.device:
            raise ValueError("q, k and v must be on one device")
    b, s, h, d = q.shape
    t = k.shape[1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"K1 takes head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if k.shape != (b, t, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (0 < b <= 65535 and 0 < h <= 65535 and s > 0 and t > 0):
        raise ValueError(f"K1 grid out of range for shape {tuple(q.shape)}")
    t_valid = t if kv_valid is None else int(kv_valid)
    if not 1 <= t_valid <= t:
        raise ValueError(f"kv_valid={kv_valid} must lie in [1, {t}]")
    return t_valid


def _launch(q, k, v, t_valid) -> torch.Tensor:
    global _launches
    lib = load_library()
    o = torch.empty_like(q)
    b, s, h, d = q.shape
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, o) for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.tvs_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), b, s, h, d, t_valid,
                                     strides, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    _launches += 1
    return o


class _FlashAttentionFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, t_valid):
        return _launch(q, k, v, t_valid)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the attention backward is kernel K2, not ported yet "
            "(ROADMAP Queue 2, K2: _backward_batched_heads)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[int] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q kᵀ / √D) v for (B, S, H, D) inputs, keys >= kv_valid masked.

    CUDA tensors go through K1 (bf16, D in {16, 32, 64}, contiguous, no
    bias) or raise; CPU tensors take `flash_attention_ref`."""
    if bias is not None:
        raise ValueError("K1 takes no bias; biased attention is plain_attention")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, kv_valid)
    t_valid = _check_kernel_inputs(q, k, v, kv_valid)
    return _FlashAttentionFwd.apply(q, k, v, t_valid)

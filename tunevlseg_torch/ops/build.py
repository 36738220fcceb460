"""Building and loading the port's CUDA kernels.

Every kernel is one CUDA C++ source under `tunevlseg_torch/csrc/` with a plain
C entry point. At first use of any of the models' kernels (K1-K4, N1), every
source of theirs whose library is missing is compiled with `nvcc` for `sm_90a`
(one compiler process per source, all started together) into
`tunevlseg_torch/_build/`, under a name keyed by a hash of the source, every
shared header (`csrc/*.cuh`) and the flags, and loaded with `ctypes`. The attention sweeps'
kernels (S1-S4, the variants of K1) are a library of their own, built at the
first sweep: a process that only serves or trains never builds it;
`load_libraries(sweeps=True)` builds whatever is missing of both sets in one
go. A failed build raises; there is no fallback. Each compiler's output (with
the register and spill counts of `ptxas -v`) is kept beside its library as
`<name>.log`. The wrappers (`ops/flash_attention.py`,
`ops/flash_attention_variants.py`, `ops/conv_flat.py`, `ops/layer_norm.py`)
set the argument types of their entry points and launch on PyTorch's current
stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"fwd": _PKG / "csrc" / "flash_attn_fwd.cu",          # K1
           "bwd": _PKG / "csrc" / "flash_attn_bwd.cu",          # K2
           "bias": _PKG / "csrc" / "flash_attn_bias_fwd.cu",    # K3
           "conv": _PKG / "csrc" / "conv_flat.cu",              # K4
           "layer_norm": _PKG / "csrc" / "layer_norm.cu"}       # N1
SWEEP_SOURCES = {"variants": _PKG / "csrc" / "flash_attn_fwd_variants.cu"}  # S1-S4
HEADERS = sorted((_PKG / "csrc").glob("*.cuh"))   # shared by the sources
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(kernel: str) -> Path:
    """Where the built library of a kernel ("fwd" is K1, "bwd" K2, "bias" K3,
    "conv" K4, "layer_norm" N1, "variants" S1-S4) lives for its current
    source and flags."""
    source = {**SOURCES, **SWEEP_SOURCES}[kernel]
    digest = hashlib.sha256(source.read_bytes()
                            + b"".join(h.read_bytes() for h in HEADERS)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def load_libraries(sweeps: bool = False) -> dict[str, ctypes.CDLL]:
    """Build the models' kernels, and with `sweeps` the attention sweeps'
    too, from source where needed (the compilers run side by side) and load
    them; returns {kernel: library}. A failed build raises."""
    wanted = {**SOURCES, **(SWEEP_SOURCES if sweeps else {})}
    builds = []
    for kernel, source in wanted.items():
        out = library_path(kernel)
        if kernel in _libs or out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        builds.append((source, out, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for source, out, tmp, cmd, proc in builds:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}) building "
                            f"{source}:\n{stderr}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    for kernel in wanted:
        if kernel not in _libs:
            _libs[kernel] = ctypes.CDLL(str(library_path(kernel)))
    return {kernel: _libs[kernel] for kernel in wanted}

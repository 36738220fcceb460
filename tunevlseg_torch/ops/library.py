"""The port's forward kernels as `torch.library` custom ops, namespace
`tunevlseg`.

K1, K3, K4 and N1 are launched through `ctypes` with raw data pointers
(`ops/flash_attention.py`, `ops/conv_flat.py`, `ops/layer_norm.py`). A
`torch.export` trace runs on fake tensors, which have no data pointer, so a
traced program can hold a kernel only as an operator of the dispatcher. Each op here has:

  * a CUDA implementation, the wrapper module's launcher (`k1_cuda`,
    `k3_cuda`, `k4_cuda`, `n1_cuda`): one launch on the current stream,
    counted there, so a loaded program's launches count and a trace's do
    not;
  * a fake implementation that gives the output's shape and dtype, which is
    all a trace reads.

No other device has an implementation: a CPU tensor takes the kernel's plain
version in the wrapper, before any op, so a program exported for the CPU
holds no `tunevlseg::` op. The ops have no autograd formula: a gradient goes
through the wrappers' `autograd.Function`s (K2 stays K1's backward), which
call the same ops in their forwards (N1's backward is `ops/layer_norm.py`'s).

    tunevlseg::flash_attn_fwd(q, k, v, t_valid, with_lse) -> (o, lse)   K1
    tunevlseg::biased_attn_fwd(q, k, v, bias?, t_valid) -> o             K3
    tunevlseg::conv_flat(x, w, scale?, offset?, residual?, rows, k, wp,
                         hp, r, mb, relu, for_dx, block_n) -> out        K4

A process that loads an exported program imports this module (and with it
the three wrapper modules, which import no model) before `torch.export.load`.
"""
from __future__ import annotations

import torch

from tunevlseg_torch.ops import conv_flat as _conv_flat
from tunevlseg_torch.ops import flash_attention as _flash_attention
from tunevlseg_torch.ops import layer_norm as _layer_norm

NAMESPACE = "tunevlseg"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("flash_attn_fwd(Tensor q, Tensor k, Tensor v, int t_valid, "
            "bool with_lse) -> (Tensor, Tensor)")
_LIB.define("biased_attn_fwd(Tensor q, Tensor k, Tensor v, Tensor? bias, "
            "int t_valid) -> Tensor")
_LIB.define("conv_flat(Tensor x, Tensor w, Tensor? scale, Tensor? offset, "
            "Tensor? residual, int rows, int k, int wp, int hp, int r, int mb, "
            "bool relu, bool for_dx, int block_n) -> Tensor")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor? bias, float eps, "
            "ScalarType out_dtype) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attn_fwd", _flash_attention.k1_cuda, "CUDA")
_LIB.impl("biased_attn_fwd", _flash_attention.k3_cuda, "CUDA")
_LIB.impl("conv_flat", _conv_flat.k4_cuda, "CUDA")
_LIB.impl("layer_norm", _layer_norm.n1_cuda, "CUDA")


@torch.library.register_fake(f"{NAMESPACE}::flash_attn_fwd", lib=_LIB)
def _flash_attn_fwd_fake(q, k, v, t_valid, with_lse):
    b, s, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, s) if with_lse else (0,), dtype=torch.float32))


@torch.library.register_fake(f"{NAMESPACE}::biased_attn_fwd", lib=_LIB)
def _biased_attn_fwd_fake(q, k, v, bias, t_valid):
    return torch.empty_like(q)


@torch.library.register_fake(f"{NAMESPACE}::conv_flat", lib=_LIB)
def _conv_flat_fake(x, w, scale, offset, residual, rows, k, wp, hp, r, mb,
                    relu, for_dx, block_n):
    return x.new_empty((x.shape[0], rows, w.shape[0]))


@torch.library.register_fake(f"{NAMESPACE}::layer_norm", lib=_LIB)
def _layer_norm_fake(x, weight, bias, eps, out_dtype):
    return (x.new_empty(x.shape, dtype=out_dtype),
            x.new_empty(x.shape[:-1], dtype=torch.float32),
            x.new_empty(x.shape[:-1], dtype=torch.float32))


flash_attn_fwd = torch.ops.tunevlseg.flash_attn_fwd.default
biased_attn_fwd = torch.ops.tunevlseg.biased_attn_fwd.default
conv_flat = torch.ops.tunevlseg.conv_flat.default
layer_norm = torch.ops.tunevlseg.layer_norm.default
OPS = {"K1": flash_attn_fwd, "K3": biased_attn_fwd, "K4": conv_flat, "N1": layer_norm}

"""Attention dispatch: the plain PyTorch path and the kernels K1, K2 and K3.

Counterpart of `tunevlseg_tpu/nn/attention.py`. Every attention of the model
funnels through `dot_product_attention`. On a CUDA device in bf16 it sends
  * unbiased self-attention (S == T) with S >= 256 to K1, whose backward
    launches K2, the fused attention backward;
  * attention with a bias or with S != T to K3 at any length (its users are
    short: the text towers' causal + padding attention, the CRIS decoder's
    cross-attention into the text), whose backward recomputes through
    `plain_attention`;
and everything else (CPU tensors, f32, short unbiased self-attention) to
`plain_attention`, which autograd differentiates as it stands. The
Shared-Attention learner's projector is such a case by construction: it
attends over ONE key (S = T = 1, no bias, 16 heads of 80 dims at full width),
once per step, and stays on the plain path by K1's length rule. The gate
does not look at the head dim: a call it sends to a kernel at a head dim the
kernels are not built for (16, 32, 64) raises there, biased or not. The gate
is a dispatch rule, like the JAX package's TPU-backend test, not a fallback:
a CUDA call that passes it launches its kernel
(`tunevlseg_torch.ops.flash_attention`) or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from tunevlseg_torch.ops.flash_attention import biased_attention, flash_attention

KERNEL_MIN_SEQ = 256


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """softmax(q kᵀ / √D + bias) v for (B, S, H, D) inputs, with the JAX
    package's numerics: f32 accumulation, the scores stored in the input
    dtype BEFORE the bias add, then an f32 softmax; keys >= kv_valid get
    exactly zero probability."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    scores = scores.to(q.dtype)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    scores = scores.float()
    if kv_valid is not None and kv_valid < k.shape[1]:
        col = torch.arange(k.shape[1], device=q.device)
        scores = scores.masked_fill(col >= kv_valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs.float(), v.float()).to(v.dtype)


def _kernel_eligible(q: torch.Tensor, k: torch.Tensor,
                     bias: Optional[torch.Tensor]) -> str:
    """The kernel a call goes to, "K1" or "K3", or "" for the plain path
    (where the Shared-Attention projector's one-key attention lands: no bias,
    S = T = 1 < KERNEL_MIN_SEQ). The head dim plays no part: the kernel
    raises on one it is not built for."""
    if not (q.is_cuda and q.dtype == torch.bfloat16):
        return ""
    if bias is not None or q.shape[1] != k.shape[1]:
        return "K3"
    return "K1" if q.shape[1] >= KERNEL_MIN_SEQ else ""


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          kv_valid: Optional[int] = None) -> torch.Tensor:
    """K1 (and K2 for its gradient) for unbiased bf16 CUDA self-attention at
    S >= 256, K3 for bf16 CUDA attention with a bias or S != T, else
    `plain_attention`. A head dim the kernels are not built for raises in
    the kernel's wrapper."""
    kernel = _kernel_eligible(q, k, bias)
    if kernel == "K1":
        return flash_attention(q, k, v, kv_valid=kv_valid)
    if kernel == "K3":
        return biased_attention(q, k, v, bias, kv_valid=kv_valid)
    return plain_attention(q, k, v, bias, kv_valid=kv_valid)


def causal_bias(seq_len: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """(1, 1, S, S) additive causal mask, dtype-min above the diagonal (HF
    `_create_4d_causal_attention_mask`)."""
    full = torch.full((seq_len, seq_len), torch.finfo(dtype).min, dtype=dtype,
                      device=device)
    return torch.triu(full, diagonal=1)[None, None]


def padding_bias(attention_mask: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S) {0, 1} keep-mask -> (B, 1, 1, S) additive bias; masked keys get
    dtype-min (HF `_prepare_4d_attention_mask`)."""
    neg = torch.finfo(dtype).min
    bias = (1.0 - attention_mask.to(dtype)) * neg
    return bias[:, None, None, :]

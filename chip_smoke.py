#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tunevlseg_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its numbers on lines of its own:
  1. device: the CUDA card's name, the device count, and nvidia-smi's name
     and power limit (exits nonzero without a CUDA device);
  2. build: kernels K1 (csrc/flash_attn_fwd.cu), K2 (csrc/flash_attn_bwd.cu)
     and K3 (csrc/flash_attn_bias_fwd.cu) built from source side by side,
     timed, with the registers and spills `ptxas -v` reports;
  3. kernel vs plain: K1 against `flash_attention_ref` and K2 against
     `flash_attention_bwd_ref` at the CLIPSeg vision and decoder shapes, a
     kv_valid case (masked dk/dv rows exactly zero), the two batch-16 shapes
     of the e2e train step and the CRIS decoder's b64 x 676 x 8 x 64; K3
     against `biased_attention_ref` at the text shape (U = 1 and U = 64 rows,
     causal + padding bias) and the CRIS cross shape (676 queries into 77
     keys, key-padding bias): max abs error against the stated bound, times
     from CUDA events, and each kernel's bound (the larger of bytes over the
     memory rate and operations over the bf16 tensor-core rate);
  4. yardstick: `F.scaled_dot_product_attention` forward and backward at the
     same shapes (with the same mask for K3 and for kv_valid), printed beside
     the kernels and used nowhere in the port;
  5. serve, CLIPSeg: three requests through `serving.task_predict_fn` on the
     full-width bf16 CLIPSeg rd64 + CoOp (depth 3, 4 contexts) model with
     seeded random weights: batch 64 with one deduplicated prompt, batch 64
     with dense prompts, batch 1. Checks the output shape, range and
     finiteness, 13 K1 and 12 K3 launches per forward and no K2 launch, and
     the first request against the same model with every attention on the
     plain path;
  6. train, CLIPSeg CoOp: 2 warm-up + 5 timed steps of
     `SegmentationTask.train_step` on a b64 prompt-dedup batch: 13 K1, 3 K2
     and 12 K3 launches per step, finite loss, the context vectors change,
     every frozen tensor stays bit-identical, and the first step's loss and
     context gradient agree with the same step taken with every attention on
     the plain path;
  7. train, CLIPSeg e2e: the same model with everything trainable, b16 dense
     prompts (b16 keeps the whole script short), 2 warm-up + 6 steps: 13 K1,
     13 K2 and 12 K3 launches per step, finite loss, the loss falls;
  8. serve, CRIS: the full-width bf16 CRIS RN50 + CoOp (depth 3, 4 contexts)
     model at 416^2, the same three requests: 3 K1 and 15 K3 launches per
     forward and no K2, kernel path against plain path; then one b64 request
     on the stock (e2e) CRIS model;
  9. train, CRIS CoOp: 2 warm-up + 5 timed steps at b64 with prompt dedup and
     the decoder's dropout on: 3 K1, 3 K2 and 15 K3 launches per step, finite
     loss, the context vectors and the additive head change, every frozen
     tensor and every BatchNorm buffer stays bit-identical, and the first
     step's loss and gradients agree with the plain path.
`--profile` adds a breakdown of the train steps (forward / backward /
optimizer spans, device busy share under torch.profiler) and of the CRIS
b64 and b1 forwards.
The second-to-last line is a JSON object describing each kernel of the
paths; the last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

KERNEL_TOL = 2e-2          # K1 and K3, bf16 output: a few ulp at |o| ~ 1
# K2, bf16 outputs: the kernel and its plain version round p and ds to bf16
# from f32 values that differ in the last bits (exp2 against a log-sum-exp
# vs e / sum), accumulate in f32 in another order, and round the outputs
# once. At worst the two roundings of an output near the largest magnitude
# land one bf16 ulp apart (2^-8 = 3.9e-3 relative), so the bound is 5e-3 of
# the largest |reference|. Both passes are deterministic (no atomics).
K2_REL_TOL = 5e-3
# kernel path vs plain path, probabilities: the plain path rounds the scores
# to bf16 before the softmax and the kernel does not, so the two bf16 models
# differ by more than the kernel's own rounding (predicted max ~5e-3)
PROB_MAX_TOL = 2e-2
PROB_MEAN_TOL = 2e-3
# kernel path vs plain path, first CoOp train step: the same two bf16 models,
# so the loss (about 1) differs like the probabilities do, and the context
# gradient, carried back through three bf16 decoder blocks and twelve text
# layers, by a few percent of its largest entry
LOSS_TOL = 2e-2
GRAD_REL_TOL = 0.1
GRAD_COS_MIN = 0.99
# launches per forward or step, as (K1, K2, K3).
# CLIPSeg: K1 in 10 vision layers + 3 decoder blocks; K3 in the 12 text
# layers (causal + padding bias); K2 for the decoder blocks, and for the
# vision layers too when they train (the frozen vision tower needs none)
CLIPSEG_SERVE = (13, 0, 12)
CLIPSEG_COOP_STEP = (13, 3, 12)
CLIPSEG_E2E_STEP = (13, 13, 12)
# CRIS: K1 (K2) in the 3 decoder self-attentions over 676 tokens; K3 in the
# 12 text layers and the 3 cross-attentions into the text; the RN50
# attention pool has 169 tokens, under the gate's 256: plain
CRIS_SERVE = (3, 0, 15)
CRIS_COOP_STEP = (3, 3, 15)
IMG, BATCH, SEQ = 352, 64, 77
CRIS_IMG = 416
E2E_BATCH = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same sheet
VISION = (BATCH, 485, 12, 64)
DECODER = (BATCH, 485, 4, 16)
# the shapes the e2e train step launches the kernels at
E2E_VISION = (E2E_BATCH, 485, 12, 64)
E2E_DECODER = (E2E_BATCH, 485, 4, 16)
CRIS_DECODER = (BATCH, 676, 8, 64)     # self-attention over 26 x 26 tokens
F32_MIN = -3.4028234663852886e38       # what the models' biases mask with


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def counts(fa) -> tuple:
    """(K1, K2, K3) launches since the last reset."""
    return fa.launch_count(), fa.bwd_launch_count(), fa.bias_launch_count()


def minus(after: tuple, before: tuple) -> tuple:
    return tuple(a - b for a, b in zip(after, before))


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print(f"device: {name}, count {count}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi.strip().splitlines()[0])
    return name, count


def phase_build(fa):
    t0 = time.perf_counter()
    fa.load_library()
    secs = time.perf_counter() - t0
    print(f"build: K1, K2 and K3 {secs:.2f} s -> "
          + ", ".join(fa.library_path(k).name for k in ("fwd", "bwd", "bias")))
    for kernel, label in (("fwd", "K1"), ("bwd", "K2"), ("bias", "K3")):
        log = fa.library_path(kernel).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {label} ptxas {line.strip()}")


def attention_bound(n_tensors: int, flops_factor: int, b, s, h, d, t_valid,
                    nbytes=None):
    """(bound_ms, bound_by, flops): the larger of `nbytes` (by default those
    of `n_tensors` bf16 (B, S, H, D) tensors) over the memory rate and
    flops_factor*B*H*S*T*D operations over the bf16 tensor-core rate."""
    if nbytes is None:
        nbytes = n_tensors * b * s * h * d * 2
    flops = flops_factor * b * h * s * t_valid * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations",
            flops)


def kernel_cases(gen):
    import torch
    for label, shape, kv in (("vision", VISION, None), ("decoder", DECODER, None),
                             ("vision kv_valid", (BATCH, 512, 12, 64), 485),
                             ("e2e vision", E2E_VISION, None),
                             ("e2e decoder", E2E_DECODER, None),
                             ("cris decoder", CRIS_DECODER, None)):
        yield label, shape, kv, tuple(
            torch.randn(*shape, generator=gen, device="cuda").bfloat16()
            for _ in range(4))


def phase_kernels(fa):
    """K1 against its plain version; returns {label: numbers}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (b, s, h, d), kv, (q, k, v, _) in kernel_cases(gen):
        out = fa.flash_attention(q, k, v, kv_valid=kv)
        torch.cuda.synchronize()
        ref = fa.flash_attention_ref(q, k, v, kv_valid=kv)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, kv_valid=kv), 50)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_ref(q, k, v, kv_valid=kv), 10)
        bound_ms, bound_by, flops = attention_bound(4, 4, b, s, h, d, kv or s)
        print(f"kernel K1 {label} q{(b, s, h, d)} kv_valid {kv}: "
              f"max_abs_err {err:.6g} (bound {KERNEL_TOL}), kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% reached)")
        if not err <= KERNEL_TOL:
            fail(f"K1 {label}: max abs error {err} > {KERNEL_TOL}")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
    return results


def phase_kernels_bwd(fa):
    """K2 against its plain version; returns {label: numbers}."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for label, (b, s, h, d), kv, (q, k, v, g) in kernel_cases(gen):
        before = fa.bwd_launch_count()
        out = fa.flash_attention_bwd(q, k, v, g, kv_valid=kv)
        torch.cuda.synchronize()
        if fa.bwd_launch_count() != before + 1:
            fail(f"K2 {label}: the wrapper did not count its launch")
        ref = fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv)
        errs, rels = [], []
        for name, got, want in zip(("dq", "dk", "dv"), out, ref):
            if got.shape != want.shape or got.dtype != torch.bfloat16:
                fail(f"K2 {label}: {name} is {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            errs.append(err)
            rels.append(err / top)
            if not err <= K2_REL_TOL * top:
                fail(f"K2 {label}: {name} max abs error {err} > "
                     f"{K2_REL_TOL} x {top}")
        if kv is not None:
            for name, got in (("dk", out[1]), ("dv", out[2])):
                if not bool((got[:, kv:] == 0).all()):
                    fail(f"K2 {label}: {name} rows of masked keys are not "
                         "exactly zero")
        del ref
        ms = cuda_time_ms(
            lambda: fa.flash_attention_bwd(q, k, v, g, kv_valid=kv), 50)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_bwd_ref(q, k, v, g, kv_valid=kv), 5)
        bound_ms, bound_by, flops = attention_bound(7, 10, b, s, h, d, kv or s)
        masked = "" if kv is None else f", {s - kv} masked dk/dv rows exactly 0"
        print(f"kernel K2 {label} q{(b, s, h, d)} kv_valid {kv}: max_abs_err "
              f"dq {errs[0]:.6g} dk {errs[1]:.6g} dv {errs[2]:.6g} (bound "
              f"{K2_REL_TOL} of the largest |reference|; reached "
              f"{max(rels):.4g}){masked}, kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s of 10*B*H*S*T*D), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% reached)")
        results[label] = {"max_abs_err": max(errs), "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
    return results


def k3_cases(gen):
    """K3's shapes on the main paths: the text towers' causal + padding bias
    over 77 tokens (U = 1 deduplicated row, U = 64 dense rows; 8 heads of 64
    in CLIPSeg and CRIS alike) and the CRIS decoder's cross-attention from
    676 visual tokens into 77 text tokens with a key-padding bias. Prompts
    have 10 real tokens (+ 4 contexts), the rest is padding."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    def key_pad(rows):
        bias = torch.zeros(rows, 1, 1, SEQ, device="cuda")
        bias[..., 14:] = F32_MIN
        return bias

    causal = torch.triu(torch.full((SEQ, SEQ), F32_MIN, device="cuda"), 1)[None, None]
    for label, b, s in (("text U=1", 1, SEQ), ("text U=64", BATCH, SEQ),
                        ("cris cross", BATCH, 676)):
        # min + min overflows to -inf where a key is both future and padding
        bias = key_pad(b) + causal if s == SEQ else key_pad(b)
        yield label, (b, s, 8, 64), bias, (rnd(b, s, 8, 64), rnd(b, SEQ, 8, 64),
                                            rnd(b, SEQ, 8, 64))


def phase_kernels_k3(fa):
    """K3 against its plain version, with `scaled_dot_product_attention`
    under the same mask beside it; returns {label: numbers}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for label, (b, s, h, d), bias, (q, k, v) in k3_cases(gen):
        before = fa.bias_launch_count()
        out = fa.biased_attention(q, k, v, bias)
        torch.cuda.synchronize()
        if fa.bias_launch_count() != before + 1:
            fail(f"K3 {label}: the wrapper did not count its launch")
        ref = fa.biased_attention_ref(q, k, v, bias)
        if out.shape != q.shape or out.dtype != torch.bfloat16:
            fail(f"K3 {label}: output is {tuple(out.shape)} {out.dtype}")
        if not bool(out.isfinite().all()):
            fail(f"K3 {label}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"K3 {label}: max abs error {err} > {KERNEL_TOL}")
        ms = cuda_time_ms(lambda: fa.biased_attention(q, k, v, bias), 50)
        plain_ms = cuda_time_ms(lambda: fa.biased_attention_ref(q, k, v, bias), 10)
        # one PyTorch call for the same function: the mask as booleans
        keep = bias > -1e30
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep), 50)
        # each input read once, the output written once; the bias at the
        # size it is stored at, not at (B, H, S, T)
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * bias.numel()
        bound_ms, bound_by, flops = attention_bound(0, 4, b, s, h, d, SEQ, nbytes)
        print(f"kernel K3 {label} q{(b, s, h, d)} k{tuple(k.shape)} bias"
              f"{tuple(bias.shape)}: max_abs_err {err:.6g} (bound {KERNEL_TOL}), "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention with the same "
              f"mask {lib_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.1f}% reached)")
        results[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": lib_ms}
    return results


def phase_yardstick():
    """One PyTorch call for the same functions: scaled_dot_product_attention
    forward, and its backward alone on a kept graph. Timed here, used
    nowhere in the port. Returns {label: (forward ms, backward ms)}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for label, shape, kv in (("vision", VISION, None), ("decoder", DECODER, None),
                             ("vision kv_valid", (BATCH, 512, 12, 64), 485),
                             ("cris decoder", CRIS_DECODER, None)):
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                      .bfloat16().transpose(1, 2) for _ in range(4))
        # kv_valid as a boolean key mask (True = attend)
        mask = None if kv is None else (
            torch.arange(shape[1], device="cuda") < kv)[None, None, None]
        fwd_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 50)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
            50)
        print(f"yardstick {label} {shape} kv_valid {kv}: "
              f"scaled_dot_product_attention forward {fwd_ms:.4f} ms, backward "
              f"{bwd_ms:.4f} ms (bf16, (B, H, S, D) views"
              + (", boolean key mask)" if kv else ")"))
        results[label] = (fwd_ms, bwd_ms)
    return results


def make_request(gen, batch: int, unique_prompts: int, img: int = IMG,
                 pad_id: int = 49407):
    """uint8 images and CLIP-style token ids: BOS, 8 word ids, EOS, then
    padding with `pad_id` (CLIPSeg pads with the EOS id, CRIS with 0).
    unique_prompts == 1 gives the deduplicated layout with text_index."""
    import torch
    rows = 1 if unique_prompts == 1 else batch
    ids = torch.randint(3, 1000, (rows, SEQ), generator=gen, dtype=torch.int32)
    ids[:, 0] = 49406
    ids[:, 9] = 49407
    ids[:, 10:] = pad_id
    mask = torch.ones_like(ids)
    mask[:, 9 if pad_id == 49407 else 10:] = 0
    req = {"image": torch.randint(0, 256, (batch, 3, img, img), generator=gen,
                                  dtype=torch.uint8),
           "input_ids": ids, "attention_mask": mask}
    if unique_prompts == 1:
        req["text_index"] = torch.zeros(batch, dtype=torch.int32)
    return {k: v.cuda() for k, v in req.items()}


def check_probs(label: str, probs, batch: int, img: int = IMG) -> None:
    import torch
    if tuple(probs.shape) != (batch, 1, img, img):
        fail(f"{label}: output shape {tuple(probs.shape)}")
    if not bool(torch.isfinite(probs).all()):
        fail(f"{label}: non-finite probabilities")
    lo, hi = probs.min().item(), probs.max().item()
    if lo < 0.0 or hi > 1.0:
        fail(f"{label}: probabilities outside [0, 1]: [{lo}, {hi}]")


def plain_path():
    """A context in which every attention of the models takes
    `plain_attention`: the reference the kernel paths are compared with."""
    from unittest import mock
    from tunevlseg_torch.nn import attention
    return mock.patch.object(attention, "_kernel_eligible", lambda *a: "")


def serve_requests(fa, tag: str, predict, params, requests, img: int,
                   per_forward: tuple, reps: int = 5):
    """Warm up, then `reps` timed forwards of each (label, request, batch)
    with the launch counts set to 0 just before and read just after; checks
    the per-forward (K1, K2, K3) launches and the probabilities. Returns (the
    first request's probabilities, the counts)."""
    import torch
    for _, req, _ in requests:          # warm-up: cuBLAS/cuDNN handles, allocator
        predict(params, req)
    torch.cuda.synchronize()
    first_probs = None
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    for label, req, batch in requests:
        times = []
        for _ in range(reps):
            before = counts(fa)
            t = time.perf_counter()
            probs = predict(params, req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            grew = minus(counts(fa), before)
            if grew != per_forward:
                fail(f"{tag} {label}: one forward launched (K1, K2, K3) = {grew}, "
                     f"expected {per_forward}")
        check_probs(f"{tag} {label}", probs, batch, img)
        if first_probs is None:
            first_probs = probs
        lat = statistics.median(times)
        print(f"{tag}: {label}: latency median {lat * 1e3:.3f} ms over {reps} "
              f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
              f"{batch / lat:.1f} images/s, prob range "
              f"[{probs.min().item():.4f}, {probs.max().item():.4f}]")
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    forwards = len(requests) * reps
    print(f"{tag}: (K1, K2, K3) launches in the main path {launches} "
          f"({forwards} forwards x {per_forward})")
    print(f"{tag}: peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if launches != tuple(forwards * n for n in per_forward):
        fail(f"{tag}: (K1, K2, K3) launched {launches} times in the main path")
    return first_probs, launches


def compare_with_plain_path(fa, tag: str, predict, params, request, probs):
    import torch
    with plain_path():
        before = counts(fa)
        plain = predict(params, request)
        torch.cuda.synchronize()
        if counts(fa) != before:
            fail(f"{tag}: the plain-path reference launched a kernel")
    diff = (probs - plain).abs()
    dmax, dmean = diff.max().item(), diff.mean().item()
    print(f"{tag}: kernel path vs plain path, b64 dedup probabilities: max abs "
          f"diff {dmax:.6g} (bound {PROB_MAX_TOL}), mean {dmean:.6g} "
          f"(bound {PROB_MEAN_TOL})")
    if not (dmax <= PROB_MAX_TOL and dmean <= PROB_MEAN_TOL):
        fail(f"{tag}: kernel path and plain path disagree beyond the stated bounds")


def three_requests(seed: int, img: int, pad_id: int):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return [("b64 dedup U=1", make_request(gen, BATCH, 1, img, pad_id), BATCH),
            ("b64 dense", make_request(gen, BATCH, BATCH, img, pad_id), BATCH),
            ("b1", make_request(gen, 1, 1, img, pad_id), 1)]


def phase_serve(fa):
    import torch

    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model, _ = build_clipseg("coop", prompt_depth=3, num_context=4,
                             dtype=torch.bfloat16, device="cuda", seed=0)
    model.eval()
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    predict = task_predict_fn(SegmentationTask(model))
    print(f"serve: model CLIPSeg rd64 + CoOp(depth 3, n_ctx 4), bf16 compute "
          f"over f32 weights, {n_params} params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    requests = three_requests(1, IMG, 49407)
    probs, launches = serve_requests(fa, "serve", predict, params, requests, IMG,
                                     CLIPSEG_SERVE)
    compare_with_plain_path(fa, "serve", predict, params, requests[0][1], probs)
    return launches


def phase_serve_cris(fa, profile: bool):
    """CRIS RN50 + CoOp at 416^2 through the serving function (parameters and
    BatchNorm buffers passed in), then one b64 request on the stock model."""
    import torch

    from tunevlseg_torch.models.presets import build_cris
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model, _ = build_cris("coop", prompt_depth=3, num_context=4,
                          dtype=torch.bfloat16, device="cuda", seed=0)
    params = dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    predict = task_predict_fn(SegmentationTask(model))
    print(f"serve cris: model CRIS RN50 + CoOp(depth 3, n_ctx 4) at {CRIS_IMG}^2, "
          f"bf16 compute over f32 weights, {n_params} params, "
          f"{sum(b.numel() for b in model.buffers())} BatchNorm statistics, "
          f"built in {time.perf_counter() - t0:.1f} s")
    requests = three_requests(6, CRIS_IMG, 0)
    probs, launches = serve_requests(fa, "serve cris", predict, params, requests,
                                     CRIS_IMG, CRIS_SERVE)
    compare_with_plain_path(fa, "serve cris", predict, params, requests[0][1],
                            probs)
    if profile:
        for label, req, _ in (requests[0], requests[2]):
            profile_calls(f"serve cris {label}", lambda: predict(params, req))
    del model, params, predict, probs

    t0 = time.perf_counter()
    stock, _ = build_cris("e2e", dtype=torch.bfloat16, device="cuda", seed=0)
    predict = task_predict_fn(SegmentationTask(stock))
    print(f"serve cris e2e: the stock model (no learner, no additive head), "
          f"built in {time.perf_counter() - t0:.1f} s")
    _, stock_launches = serve_requests(
        fa, "serve cris e2e", predict, dict(stock.state_dict()), requests[1:2],
        CRIS_IMG, CRIS_SERVE, reps=3)
    return tuple(a + b for a, b in zip(launches, stock_launches))


def make_train_batch(batch: int, text_dedup: int, seed: int, img: int = IMG,
                     pad_id: int = 49407):
    """A training batch as the data pipeline makes it: per-sample uint8
    images, random {0, 1} masks and CLIP-style token ids (padded with
    `pad_id`: the EOS id for CLIPSeg, 0 for CRIS), stacked by the port's
    `collate` (prompt dedup to `text_dedup` rows, `valid` all ones) and moved
    to the card. text_dedup == 0 gives each sample its own prompt."""
    import numpy as np
    import torch
    from tunevlseg_torch.data.pipeline import collate, device_batch
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, 1000, size=(SEQ,)).astype(np.int32)
    samples = []
    for _ in range(batch):
        ids = shared.copy() if text_dedup else rng.integers(
            3, 1000, size=(SEQ,)).astype(np.int32)
        ids[0] = 49406
        ids[9] = 49407
        ids[10:] = pad_id
        samples.append({
            "image": rng.integers(0, 256, (3, img, img), dtype=np.uint8),
            "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids,
            "attention_mask": (ids != pad_id).astype(np.int32)})
    host = device_batch(collate(samples, batch, text_dedup=text_dedup))
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def timed_steps(fa, task, state, batch, label: str, warmup: int, steps: int,
                per_step: tuple):
    """`warmup` untimed and `steps` timed train steps, the launch counts set
    to 0 before the timed ones and read after; checks the per-step (K1, K2,
    K3) launches and that every loss is finite. Returns (state, losses of all
    steps, the counts)."""
    import torch
    losses = []
    for _ in range(warmup):
        state, metrics = task.train_step(state, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    times = []
    for _ in range(steps):
        before = counts(fa)
        t = time.perf_counter()
        state, metrics = task.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(metrics["loss"])
        grew = minus(counts(fa), before)
        if grew != per_step:
            fail(f"{label}: one step launched (K1, K2, K3) = {grew}, expected "
                 f"{per_step}")
    launches = counts(fa)
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"{label}: non-finite loss in {losses}")
    n = batch["image"].shape[0]
    med = statistics.median(times)
    print(f"{label}: step time median {med * 1e3:.3f} ms over {steps} "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{1 / med:.2f} steps/s, {n / med:.1f} images/s at batch {n}")
    print(f"{label}: (K1, K2, K3) launches {launches} in {steps} steps; peak "
          f"device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    print(f"{label}: loss per step (warm-up first) "
          + " ".join(f"{x:.5f}" for x in losses))
    return state, losses, launches


def build_task(family: str, strategy: str, learning_rate: float):
    import torch
    from tunevlseg_torch.models.presets import build_clipseg, build_cris
    from tunevlseg_torch.training.optim import count_params
    from tunevlseg_torch.training.task import SegmentationTask
    t0 = time.perf_counter()
    build = {"CLIPSeg rd64": build_clipseg, "CRIS RN50": build_cris}[family]
    model, spec = build(strategy, prompt_depth=3, num_context=4,
                        dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model, spec, learning_rate=learning_rate)
    state = task.init()
    trainable = count_params(p for p in model.parameters() if p.requires_grad)
    print(f"train {strategy}: {family}, bf16 compute over f32 weights, "
          f"{count_params(model.parameters())} params, {trainable} trainable, "
          f"lr {learning_rate}, built in {time.perf_counter() - t0:.1f} s")
    return task, state


def first_step_kernel_vs_plain(fa, label: str, task, start: dict, batch,
                               leaves: tuple):
    """The first train step from the weights `start`, once on the kernel path
    and once with every attention on the plain path (the same dropout masks:
    they depend on the seed and the step alone): the loss and the gradient
    of each leaf in `leaves` against the stated bounds."""
    import torch
    params = dict(task.model.named_parameters())

    def first_step():
        with torch.no_grad():
            for name, p in params.items():
                if p.requires_grad:
                    p.copy_(start[name])
        _, metrics = task.train_step(task.init(), batch)
        return metrics["loss"].item(), {
            name: params[name].grad.detach().float().clone() for name in leaves}

    loss_k, grads_k = first_step()
    with plain_path():
        before = counts(fa)
        loss_p, grads_p = first_step()
        if counts(fa) != before:
            fail(f"{label}: the plain-path step launched a kernel")
    print(f"{label}: kernel path vs plain path, first step: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (bound {LOSS_TOL})")
    ok = abs(loss_k - loss_p) <= LOSS_TOL
    for name in leaves:
        top = grads_p[name].abs().max().item()
        gdiff = (grads_k[name] - grads_p[name]).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(
            grads_k[name].flatten(), grads_p[name].flatten(), dim=0).item()
        print(f"{label}:   gradient of {name}: max abs diff {gdiff:.6g} against "
              f"largest entry {top:.6g} (bound {GRAD_REL_TOL} of it), cosine "
              f"{cos:.6f} (at least {GRAD_COS_MIN})")
        ok = ok and gdiff <= GRAD_REL_TOL * top and cos >= GRAD_COS_MIN
    if not ok:
        fail(f"{label}: kernel path and plain path disagree beyond the stated "
             "bounds")


def phase_train_coop(fa, profile: bool):
    import torch

    task, state = build_task("CLIPSeg rd64", "coop", 2e-4)
    model = task.model
    batch = make_train_batch(BATCH, text_dedup=1, seed=3)
    if batch["input_ids"].shape[0] != 1 or "text_index" not in batch:
        fail("train coop: collate did not give the U = 1 prompt-dedup layout")
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    ctx = model.learner.context_vectors

    state, _, launches = timed_steps(fa, task, state, batch, "train coop",
                                     warmup=2, steps=5,
                                     per_step=CLIPSEG_COOP_STEP)
    if torch.equal(ctx, start["learner.context_vectors"]):
        fail("train coop: the context vectors did not change")
    if model.residual_ratio.detach().item() != 0.5:
        fail("train coop: residual_ratio, which nothing reads, moved")
    for name, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, start[name]):
            fail(f"train coop: frozen tensor {name} changed")
    print("train coop: context vectors changed, every frozen tensor "
          "bit-identical, residual_ratio still 0.5")
    first_step_kernel_vs_plain(fa, "train coop", task, start, batch,
                               ("learner.context_vectors",))
    if profile:
        profile_step("coop", task, task.init(), batch)
    return launches


def phase_train_e2e(fa, profile: bool):
    task, state = build_task("CLIPSeg rd64", "e2e", 1e-4)
    batch = make_train_batch(E2E_BATCH, text_dedup=0, seed=4)
    if batch["input_ids"].shape[0] != E2E_BATCH:
        fail("train e2e: expected dense prompts")
    print(f"train e2e: batch {E2E_BATCH} rather than {BATCH}, to keep the "
          "whole script short")
    state, losses, launches = timed_steps(fa, task, state, batch, "train e2e",
                                          warmup=2, steps=6,
                                          per_step=CLIPSEG_E2E_STEP)
    if not losses[-1] < losses[0]:
        fail(f"train e2e: the loss did not fall: {losses[0]} -> {losses[-1]}")
    print(f"train e2e: loss fell {losses[0]:.5f} -> {losses[-1]:.5f} on one "
          "fixed batch")
    if profile:
        profile_step("e2e", task, state, batch)
    return launches


def phase_train_cris(fa, profile: bool):
    """CoOp steps of CRIS RN50 at b64 with prompt dedup: the backbone is
    frozen, the gradient runs back through the projector, the decoder (K2 at
    676 tokens; K3's backward is a plain recompute), the neck and the text
    tower into the context vectors and the additive head."""
    import torch

    task, state = build_task("CRIS RN50", "coop", 2e-4)
    model = task.model
    batch = make_train_batch(BATCH, text_dedup=1, seed=7, img=CRIS_IMG, pad_id=0)
    if batch["input_ids"].shape[0] != 1 or "text_index" not in batch:
        fail("train cris: collate did not give the U = 1 prompt-dedup layout")
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainable = sorted(n for n, p in model.named_parameters() if p.requires_grad)
    want = ["additive_conv1.weight", "additive_conv2.bias",
            "additive_conv2.weight", "learner.context_vectors", "residual_ratio"]
    if trainable != want:
        fail(f"train cris: trainable leaves {trainable}, expected {want}")

    state, _, launches = timed_steps(fa, task, state, batch, "train cris",
                                     warmup=2, steps=5, per_step=CRIS_COOP_STEP)
    now = model.state_dict()
    for name in trainable:
        if torch.equal(now[name], start[name]):
            fail(f"train cris: trainable leaf {name} did not change")
    buffers = [n for n, _ in model.named_buffers()]
    for name, value in now.items():
        if name not in trainable and not torch.equal(value, start[name]):
            fail(f"train cris: frozen tensor or buffer {name} changed")
    print(f"train cris: the context vectors and the additive head changed; "
          f"{len(now) - len(trainable) - len(buffers)} frozen tensors and "
          f"{len(buffers)} BatchNorm buffers bit-identical")
    first_step_kernel_vs_plain(fa, "train cris", task, start, batch,
                               ("learner.context_vectors",
                                "additive_conv1.weight"))
    if profile:
        profile_step("cris coop", task, task.init(), batch)
    return launches


def profile_calls(label: str, fn, n: int = 3, wall: float = None):
    """Device-busy time of `n` calls of `fn` (the sum of kernel durations
    under torch.profiler) against the wall time of a call without the
    profiler (measured here over 5 calls unless given)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if wall is None:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        wall = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # device-side events that are kernels or copies: a user annotation (the
    # optimizer's step range) is mirrored on the device timeline and would
    # count its kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.step")]
    if not kernels:
        fail("profile: torch.profiler recorded no device time")
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e6
    print(f"profile {label} ({n} calls under torch.profiler): device busy "
          f"{busy * 1e3:.3f} ms of the {wall * 1e3:.3f} ms call, idle share "
          f"{1 - busy / wall:.3f}, {sum(e.count for e in kernels) / n:.0f} "
          "device kernels per call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile {label}:   {e.self_device_time_total / n / 1e3:8.3f} "
              f"ms  x{e.count / n:6.1f}  {e.key[:90]}")


def profile_step(label: str, task, state, batch, steps: int = 5):
    """Where a train step's time goes: the spans of forward, backward and
    optimizer on the device's timeline (CUDA events at the boundaries, one
    synchronize at the end of each step, so a span holds the device's idle
    gaps too), then the device-busy time of whole steps against that step
    time."""
    import torch

    opt = state.optimizer
    spans = {"forward": [], "backward": [], "optimizer": []}
    walls = []
    for _ in range(steps):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        marks[0].record()
        loss, _ = task._loss(batch)
        marks[1].record()
        loss.backward()
        marks[2].record()
        opt.step()
        marks[3].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        for key, first, last in zip(spans, marks, marks[1:]):
            spans[key].append(first.elapsed_time(last))
    wall = statistics.median(walls)
    print(f"profile {label} step: wall {wall * 1e3:.3f} ms (median of {steps}); "
          "device-timeline spans " + ", ".join(
              f"{key} {statistics.median(v):.3f} ms" for key, v in spans.items()))
    holder = [state]

    def step():
        holder[0], _ = task.train_step(holder[0], batch)

    profile_calls(f"{label} step", step, wall=wall)


def main() -> None:
    from tunevlseg_torch.ops import flash_attention as fa

    profile = "--profile" in sys.argv[1:]
    name, count = phase_device()
    phase_build(fa)
    k1 = phase_kernels(fa)
    k2 = phase_kernels_bwd(fa)
    k3 = phase_kernels_k3(fa)
    library = phase_yardstick()
    by_path = {"serve": phase_serve(fa),
               "train_coop": phase_train_coop(fa, profile),
               "train_e2e": phase_train_e2e(fa, profile),
               "serve_cris": phase_serve_cris(fa, profile),
               "train_cris_coop": phase_train_cris(fa, profile)}

    for label, (fwd_ms, bwd_ms) in library.items():
        k1[label]["library_ms"], k2[label]["library_ms"] = fwd_ms, bwd_ms

    # the launches are those of the five main paths, each counted from 0; the
    # times are for K1's and K2's CLIPSeg vision shape and K3's CRIS cross
    # shape, max_abs_err the largest over every shape checked
    def entry(index: int, name: str, source: str, replaces: str, numbers: dict,
              main: str, library_ms: float) -> dict:
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c[index] for c in by_path.values()),
                "launches_by_path": {p: c[index] for p, c in by_path.items()},
                **numbers[main], "library_ms": library_ms,
                "max_abs_err": max(r["max_abs_err"] for r in numbers.values()),
                "by_shape": numbers}

    kernels = [
        entry(0, "K1 flash_attn_fwd (unbiased self-attention forward)",
              "tunevlseg_torch/csrc/flash_attn_fwd.cu",
              "tunevlseg_tpu/ops/flash_attention.py:80", k1, "vision",
              library["vision"][0]),
        entry(1, "K2 flash_attn_bwd (fused self-attention backward)",
              "tunevlseg_torch/csrc/flash_attn_bwd.cu",
              "tunevlseg_tpu/ops/flash_attention.py:227", k2, "vision",
              library["vision"][1]),
        entry(2, "K3 flash_attn_bias_fwd (biased / cross-attention forward)",
              "tunevlseg_torch/csrc/flash_attn_bias_fwd.cu",
              "tunevlseg_tpu/ops/flash_attention.py:140", k3, "cris cross",
              k3["cris cross"]["library_ms"]),
    ]
    # K1 and K3 run on every path, K2 on those that take a gradient
    for kernel, paths in zip(kernels, (tuple(by_path),
                                       ("train_coop", "train_e2e",
                                        "train_cris_coop"), tuple(by_path))):
        for path in paths:
            if kernel["launches_by_path"][path] <= 0:
                fail(f"{kernel['name']} was never launched on the {path} path")
    for path in ("serve", "serve_cris"):
        if by_path[path][1] != 0:
            fail(f"{path} launched K2 {by_path[path][1]} times; it takes no "
                 "gradient")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tunevlseg_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on lines of its own:
  1. device: the CUDA card's name, the device count, and nvidia-smi's name
     and power limit (exits nonzero without a CUDA device);
  2. build: kernel K1 (csrc/flash_attn_fwd.cu) built from source, timed;
  3. kernel vs plain: K1 against its plain PyTorch version
     (flash_attention_ref) at the serving path's shapes plus a kv_valid
     case, max abs error (bound 2e-2) and times from CUDA events;
  4. serve: three requests through `serving.task_predict_fn` on the
     full-width bf16 CLIPSeg rd64 + CoOp (depth 3, 4 contexts) model with
     seeded random weights: batch 64 with one deduplicated prompt, batch 64
     with dense prompts, batch 1. Checks the output shape, range and
     finiteness, 13 K1 launches per forward, and the first request against
     the same model with every attention on the plain path.
The second-to-last line is a JSON object describing each kernel of the
path; the last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

KERNEL_TOL = 2e-2          # bf16 output: a few ulp at |o| ~ 1
# kernel path vs plain path, probabilities: the plain path rounds the scores
# to bf16 before the softmax and the kernel does not, so the two bf16 models
# differ by more than the kernel's own rounding (predicted max ~5e-3)
PROB_MAX_TOL = 2e-2
PROB_MEAN_TOL = 2e-3
K1_PER_FORWARD = 13        # 10 vision layers + 3 decoder blocks
IMG, BATCH, SEQ = 352, 64, 77


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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
    log = fa.library_path().with_suffix(".log").read_text()
    regs = [l.strip() for l in log.splitlines() if "registers" in l]
    print(f"build: K1 {secs:.2f} s -> {fa.library_path().name}")
    for line in regs:
        print(f"build: ptxas {line}")


def phase_kernels(fa):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("vision", (BATCH, 485, 12, 64), 485, None),
             ("decoder", (BATCH, 485, 4, 16), 485, None),
             ("vision kv_valid", (BATCH, 512, 12, 64), 512, 485)]
    results = {}
    for label, (b, s, h, d), t, kv in cases:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
        out = fa.flash_attention(q, k, v, kv_valid=kv)
        torch.cuda.synchronize()
        ref = fa.flash_attention_ref(q, k, v, kv_valid=kv)
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, kv_valid=kv), 50)
        plain_ms = cuda_time_ms(
            lambda: fa.flash_attention_ref(q, k, v, kv_valid=kv), 10)
        flops = 4 * b * h * s * (t if kv is None else kv) * d
        print(f"kernel K1 {label} q{(b, s, h, d)} T{t} kv_valid {kv}: "
              f"max_abs_err {err:.6g} (bound {KERNEL_TOL}), kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        if not err <= KERNEL_TOL:
            fail(f"K1 {label}: max abs error {err} > {KERNEL_TOL}")
        results[label] = (err, ms, plain_ms)
    return results


def make_request(gen, batch: int, unique_prompts: int):
    """uint8 images and CLIP-style token ids (BOS, 8 word ids, EOS padding).
    unique_prompts == 1 gives the deduplicated layout with text_index."""
    import torch
    rows = 1 if unique_prompts == 1 else batch
    ids = torch.randint(3, 1000, (rows, SEQ), generator=gen, dtype=torch.int32)
    ids[:, 0] = 49406
    ids[:, 9:] = 49407
    req = {"image": torch.randint(0, 256, (batch, 3, IMG, IMG), generator=gen,
                                  dtype=torch.uint8),
           "input_ids": ids, "attention_mask": (ids != 49407).to(torch.int32)}
    if unique_prompts == 1:
        req["text_index"] = torch.zeros(batch, dtype=torch.int32)
    return {k: v.cuda() for k, v in req.items()}


def check_probs(label: str, probs, batch: int) -> None:
    import torch
    if tuple(probs.shape) != (batch, 1, IMG, IMG):
        fail(f"{label}: output shape {tuple(probs.shape)}")
    if not bool(torch.isfinite(probs).all()):
        fail(f"{label}: non-finite probabilities")
    lo, hi = probs.min().item(), probs.max().item()
    if lo < 0.0 or hi > 1.0:
        fail(f"{label}: probabilities outside [0, 1]: [{lo}, {hi}]")


def phase_serve(fa):
    import torch
    from unittest import mock

    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.nn import attention
    from tunevlseg_torch.serving import task_predict_fn
    from tunevlseg_torch.training.task import SegmentationTask

    t0 = time.perf_counter()
    model = build_clipseg("coop", prompt_depth=3, num_context=4,
                          dtype=torch.bfloat16, device="cuda", seed=0).eval()
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    predict = task_predict_fn(SegmentationTask(model))
    print(f"serve: model CLIPSeg rd64 + CoOp(depth 3, n_ctx 4), bf16 compute "
          f"over f32 weights, {n_params} params, built in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator().manual_seed(1)
    requests = [("b64 dedup U=1", make_request(gen, BATCH, 1), BATCH),
                ("b64 dense", make_request(gen, BATCH, BATCH), BATCH),
                ("b1", make_request(gen, 1, 1), 1)]
    for _, req, _ in requests:          # warm-up: cuBLAS handles, allocator
        predict(params, req)
    torch.cuda.synchronize()

    reps = 5
    first_probs = None
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    for label, req, batch in requests:
        times = []
        for _ in range(reps):
            before = fa.launch_count()
            t = time.perf_counter()
            probs = predict(params, req)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            grew = fa.launch_count() - before
            if grew != K1_PER_FORWARD:
                fail(f"{label}: K1 launched {grew} times in one forward, "
                     f"expected {K1_PER_FORWARD}")
        check_probs(label, probs, batch)
        if first_probs is None:
            first_probs = probs
        lat = statistics.median(times)
        print(f"serve: {label}: latency median {lat * 1e3:.3f} ms over {reps} "
              f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
              f"{batch / lat:.1f} images/s, prob range "
              f"[{probs.min().item():.4f}, {probs.max().item():.4f}]")
    launches = fa.launch_count()
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: K1 launches in the main path {launches} "
          f"({len(requests) * reps} forwards x {K1_PER_FORWARD})")
    print(f"serve: peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if launches != len(requests) * reps * K1_PER_FORWARD:
        fail(f"K1 launched {launches} times in the main path")

    with mock.patch.object(attention, "_kernel_eligible", lambda *a: False):
        before = fa.launch_count()
        plain = predict(params, requests[0][1])
        torch.cuda.synchronize()
        if fa.launch_count() != before:
            fail("the plain-path reference launched K1")
    diff = (first_probs - plain).abs()
    dmax, dmean = diff.max().item(), diff.mean().item()
    print(f"serve: kernel path vs plain path, b64 dedup probabilities: max abs "
          f"diff {dmax:.6g} (bound {PROB_MAX_TOL}), mean {dmean:.6g} "
          f"(bound {PROB_MEAN_TOL})")
    if not (dmax <= PROB_MAX_TOL and dmean <= PROB_MEAN_TOL):
        fail("kernel path and plain path disagree beyond the stated bounds")
    return launches


def main() -> None:
    from tunevlseg_torch.ops import flash_attention as fa

    name, count = phase_device()
    phase_build(fa)
    kernel_results = phase_kernels(fa)
    launches = phase_serve(fa)

    err = max(r[0] for r in kernel_results.values())
    _, ms, plain_ms = kernel_results["vision"]
    print(json.dumps({"kernels": [{
        "name": "K1 flash_attn_fwd (unbiased self-attention forward)",
        "route": "cuda",
        "source": "tunevlseg_torch/csrc/flash_attn_fwd.cu",
        "replaces": "tunevlseg_tpu/ops/flash_attention.py:80",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()

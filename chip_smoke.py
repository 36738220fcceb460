#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tunevlseg_torch) on one CUDA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its numbers on lines of its own:
  1. device: the CUDA card's name, the device count, and nvidia-smi's name
     and power limit (exits nonzero without a CUDA device);
  2. build: kernels K1 (csrc/flash_attn_fwd.cu) and K2
     (csrc/flash_attn_bwd.cu) built from source side by side, timed, with
     the registers and spills `ptxas -v` reports;
  3. kernel vs plain: K1 against `flash_attention_ref` and K2 against
     `flash_attention_bwd_ref` at the vision shape, the decoder shape, a
     kv_valid case (masked dk/dv rows exactly zero) and the two batch-16
     shapes of the e2e train step: max abs error against the stated bound,
     times from CUDA events, and each kernel's bound (the larger of bytes
     over the memory rate and operations over the bf16 tensor-core rate);
  4. yardstick: `F.scaled_dot_product_attention` forward and backward at the
     same shapes, printed beside the kernels and used nowhere in the port;
  5. serve: three requests through `serving.task_predict_fn` on the
     full-width bf16 CLIPSeg rd64 + CoOp (depth 3, 4 contexts) model with
     seeded random weights: batch 64 with one deduplicated prompt, batch 64
     with dense prompts, batch 1. Checks the output shape, range and
     finiteness, 13 K1 launches per forward and no K2 launch, and the first
     request against the same model with every attention on the plain path;
  6. train, CoOp: 2 warm-up + 5 timed steps of `SegmentationTask.train_step`
     on a b64 prompt-dedup batch: 13 K1 and 3 K2 launches per step, finite
     loss, the context vectors change, every frozen tensor stays
     bit-identical, and the first step's loss and context gradient agree
     with the same step taken with every attention on the plain path;
  7. train, e2e: the same model with everything trainable, b16 dense
     prompts (b16 keeps the whole script short), 2 warm-up + 6 steps: 13 K1
     and 13 K2 launches per step, finite loss, the loss falls.
`--profile` adds a breakdown of both train steps (forward / backward /
optimizer spans, device busy share under torch.profiler).
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

KERNEL_TOL = 2e-2          # K1, bf16 output: a few ulp at |o| ~ 1
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
K1_PER_FORWARD = 13        # 10 vision layers + 3 decoder blocks
K2_PER_COOP_STEP = 3       # the decoder blocks; the frozen vision tower needs none
K2_PER_E2E_STEP = 13
IMG, BATCH, SEQ = 352, 64, 77
E2E_BATCH = 16
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same sheet
VISION = (BATCH, 485, 12, 64)
DECODER = (BATCH, 485, 4, 16)
# the shapes the e2e train step launches the kernels at
E2E_VISION = (E2E_BATCH, 485, 12, 64)
E2E_DECODER = (E2E_BATCH, 485, 4, 16)


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
    print(f"build: K1 and K2 {secs:.2f} s -> "
          f"{fa.library_path('fwd').name}, {fa.library_path('bwd').name}")
    for kernel, label in (("fwd", "K1"), ("bwd", "K2")):
        log = fa.library_path(kernel).with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {label} ptxas {line.strip()}")


def attention_bound(n_tensors: int, flops_factor: int, b, s, h, d, t_valid):
    """(bound_ms, bound_by, flops): the larger of the bytes of `n_tensors`
    bf16 (B, S, H, D) tensors over the memory rate and
    flops_factor*B*H*S*T*D operations over the bf16 tensor-core rate."""
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
                             ("e2e decoder", E2E_DECODER, None)):
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


def phase_yardstick():
    """One PyTorch call for the same functions: scaled_dot_product_attention
    forward, and its backward alone on a kept graph. Timed here, used
    nowhere in the port. Returns {label: (forward ms, backward ms)}."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    results = {}
    for label, shape in (("vision", VISION), ("decoder", DECODER)):
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                      .bfloat16().transpose(1, 2) for _ in range(4))
        fwd_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 50)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        bwd_ms = cuda_time_ms(
            lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
            50)
        print(f"yardstick {label} {shape}: scaled_dot_product_attention "
              f"forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms "
              "(bf16, (B, H, S, D) views)")
        results[label] = (fwd_ms, bwd_ms)
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
    model, _ = build_clipseg("coop", prompt_depth=3, num_context=4,
                             dtype=torch.bfloat16, device="cuda", seed=0)
    model.eval()
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
    launches, bwd_launches = fa.launch_count(), fa.bwd_launch_count()
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: K1 launches in the main path {launches} "
          f"({len(requests) * reps} forwards x {K1_PER_FORWARD}), "
          f"K2 launches {bwd_launches}")
    print(f"serve: peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    if launches != len(requests) * reps * K1_PER_FORWARD:
        fail(f"K1 launched {launches} times in the main path")
    if bwd_launches != 0:
        fail(f"serving launched K2 {bwd_launches} times; it takes no gradient")

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
    return launches, bwd_launches


def make_train_batch(batch: int, text_dedup: int, seed: int):
    """A training batch as the data pipeline makes it: per-sample uint8 352^2
    images, random {0, 1} masks and CLIP-style token ids, stacked by the
    port's `collate` (prompt dedup to `text_dedup` rows, `valid` all ones)
    and moved to the card. text_dedup == 0 gives each sample its own prompt."""
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
        ids[9:] = 49407
        samples.append({
            "image": rng.integers(0, 256, (3, IMG, IMG), dtype=np.uint8),
            "mask": (rng.random((1, IMG, IMG)) > 0.5).astype(np.float32),
            "input_ids": ids,
            "attention_mask": (ids != 49407).astype(np.int32)})
    host = device_batch(collate(samples, batch, text_dedup=text_dedup))
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def timed_steps(fa, task, state, batch, label: str, warmup: int, steps: int,
                k2_per_step: int):
    """`warmup` untimed and `steps` timed train steps, the launch counts set
    to 0 before the timed ones and read after; checks the per-step launch
    counts and that every loss is finite. Returns (state, losses of all
    steps, K1 launches, K2 launches)."""
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
        k1, k2 = fa.launch_count(), fa.bwd_launch_count()
        t = time.perf_counter()
        state, metrics = task.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(metrics["loss"])
        k1, k2 = fa.launch_count() - k1, fa.bwd_launch_count() - k2
        if (k1, k2) != (K1_PER_FORWARD, k2_per_step):
            fail(f"{label}: one step launched K1 {k1} and K2 {k2} times, "
                 f"expected {K1_PER_FORWARD} and {k2_per_step}")
    launches = fa.launch_count(), fa.bwd_launch_count()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        fail(f"{label}: non-finite loss in {losses}")
    n = batch["image"].shape[0]
    med = statistics.median(times)
    print(f"{label}: step time median {med * 1e3:.3f} ms over {steps} "
          f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
          f"{1 / med:.2f} steps/s, {n / med:.1f} images/s at batch {n}")
    print(f"{label}: K1 launches {launches[0]}, K2 launches {launches[1]} in "
          f"{steps} steps; peak device memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    print(f"{label}: loss per step (warm-up first) "
          + " ".join(f"{x:.5f}" for x in losses))
    return state, losses, launches


def build_task(strategy: str, learning_rate: float):
    import torch
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.optim import count_params
    from tunevlseg_torch.training.task import SegmentationTask
    t0 = time.perf_counter()
    model, spec = build_clipseg(strategy, prompt_depth=3, num_context=4,
                                dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model, spec, learning_rate=learning_rate)
    state = task.init()
    trainable = count_params(p for p in model.parameters() if p.requires_grad)
    print(f"train {strategy}: CLIPSeg rd64, bf16 compute over f32 weights, "
          f"{count_params(model.parameters())} params, {trainable} trainable, "
          f"lr {learning_rate}, built in {time.perf_counter() - t0:.1f} s")
    return task, state


def phase_train_coop(fa, profile: bool):
    import torch
    from unittest import mock

    from tunevlseg_torch.nn import attention

    task, state = build_task("coop", 2e-4)
    model = task.model
    batch = make_train_batch(BATCH, text_dedup=1, seed=3)
    if batch["input_ids"].shape[0] != 1 or "text_index" not in batch:
        fail("train coop: collate did not give the U = 1 prompt-dedup layout")
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    ctx = model.learner.context_vectors

    state, _, launches = timed_steps(fa, task, state, batch, "train coop",
                                     warmup=2, steps=5,
                                     k2_per_step=K2_PER_COOP_STEP)
    if torch.equal(ctx, start["learner.context_vectors"]):
        fail("train coop: the context vectors did not change")
    if model.residual_ratio.detach().item() != 0.5:
        fail("train coop: residual_ratio, which nothing reads, moved")
    for name, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, start[name]):
            fail(f"train coop: frozen tensor {name} changed")
    print("train coop: context vectors changed, every frozen tensor "
          "bit-identical, residual_ratio still 0.5")

    def first_step():
        with torch.no_grad():
            ctx.copy_(start["learner.context_vectors"])
        _, metrics = task.train_step(task.init(), batch)
        return metrics["loss"].item(), ctx.grad.detach().float().clone()

    loss_k, grad_k = first_step()
    with mock.patch.object(attention, "_kernel_eligible", lambda *a: False):
        before = fa.launch_count(), fa.bwd_launch_count()
        loss_p, grad_p = first_step()
        if (fa.launch_count(), fa.bwd_launch_count()) != before:
            fail("train coop: the plain-path step launched a kernel")
    top = grad_p.abs().max().item()
    gdiff = (grad_k - grad_p).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        grad_k.flatten(), grad_p.flatten(), dim=0).item()
    print(f"train coop: kernel path vs plain path, first step: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (bound {LOSS_TOL}); context gradient "
          f"max abs diff {gdiff:.6g} against largest entry {top:.6g} (bound "
          f"{GRAD_REL_TOL} of it), cosine {cos:.6f} (at least {GRAD_COS_MIN})")
    if not (abs(loss_k - loss_p) <= LOSS_TOL and gdiff <= GRAD_REL_TOL * top
            and cos >= GRAD_COS_MIN):
        fail("train coop: kernel path and plain path disagree beyond the "
             "stated bounds")
    if profile:
        profile_step("coop", task, task.init(), batch)
    return launches


def phase_train_e2e(fa, profile: bool):
    task, state = build_task("e2e", 1e-4)
    batch = make_train_batch(E2E_BATCH, text_dedup=0, seed=4)
    if batch["input_ids"].shape[0] != E2E_BATCH:
        fail("train e2e: expected dense prompts")
    print(f"train e2e: batch {E2E_BATCH} rather than {BATCH}, to keep the "
          "whole script short")
    state, losses, launches = timed_steps(fa, task, state, batch, "train e2e",
                                      warmup=2, steps=6,
                                      k2_per_step=K2_PER_E2E_STEP)
    if not losses[-1] < losses[0]:
        fail(f"train e2e: the loss did not fall: {losses[0]} -> {losses[-1]}")
    print(f"train e2e: loss fell {losses[0]:.5f} -> {losses[-1]:.5f} on one "
          "fixed batch")
    if profile:
        profile_step("e2e", task, state, batch)
    return launches


def profile_step(label: str, task, state, batch, steps: int = 5):
    """Where a train step's time goes: the spans of forward, backward and
    optimizer on the device's timeline (CUDA events at the boundaries, one
    synchronize at the end of each step, so a span holds the device's idle
    gaps too), then the device-busy time of whole steps (the sum of kernel
    durations under torch.profiler) against the step time without it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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

    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = task.train_step(state, batch)
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
    print(f"profile {label} step ({n} steps under torch.profiler): device busy "
          f"{busy * 1e3:.3f} ms of the {wall * 1e3:.3f} ms step, idle share "
          f"{1 - busy / wall:.3f}, {sum(e.count for e in kernels) / n:.0f} "
          "device kernels per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"profile {label} step:   {e.self_device_time_total / n / 1e3:8.3f} "
              f"ms  x{e.count / n:6.1f}  {e.key[:90]}")


def main() -> None:
    from tunevlseg_torch.ops import flash_attention as fa

    profile = "--profile" in sys.argv[1:]
    name, count = phase_device()
    phase_build(fa)
    k1 = phase_kernels(fa)
    k2 = phase_kernels_bwd(fa)
    library = phase_yardstick()
    serve_k1, serve_k2 = phase_serve(fa)
    coop_k1, coop_k2 = phase_train_coop(fa, profile)
    e2e_k1, e2e_k2 = phase_train_e2e(fa, profile)

    # every number below is for the vision shape; the launches are those of
    # the three main paths (serve, train coop, train e2e), each counted from 0
    kernels = [
        {"name": "K1 flash_attn_fwd (unbiased self-attention forward)",
         "route": "cuda", "source": "tunevlseg_torch/csrc/flash_attn_fwd.cu",
         "replaces": "tunevlseg_tpu/ops/flash_attention.py:80",
         "launches": serve_k1 + coop_k1 + e2e_k1,
         "launches_by_path": {"serve": serve_k1, "train_coop": coop_k1,
                              "train_e2e": e2e_k1},
         **k1["vision"], "library_ms": library["vision"][0],
         "max_abs_err": max(r["max_abs_err"] for r in k1.values())},
        {"name": "K2 flash_attn_bwd (fused self-attention backward)",
         "route": "cuda", "source": "tunevlseg_torch/csrc/flash_attn_bwd.cu",
         "replaces": "tunevlseg_tpu/ops/flash_attention.py:227",
         "launches": serve_k2 + coop_k2 + e2e_k2,
         "launches_by_path": {"serve": serve_k2, "train_coop": coop_k2,
                              "train_e2e": e2e_k2},
         **k2["vision"], "library_ms": library["vision"][1],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values())},
    ]
    # K1 runs on all three paths, K2 on the two that take a gradient
    for kernel, paths in zip(kernels, (("serve", "train_coop", "train_e2e"),
                                       ("train_coop", "train_e2e"))):
        for path in paths:
            if kernel["launches_by_path"][path] <= 0:
                fail(f"{kernel['name']} was never launched on the {path} path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()

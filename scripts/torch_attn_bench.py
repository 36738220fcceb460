#!/usr/bin/env python3
"""Times the attention kernels of the port on one CUDA GPU at the shapes the
models launch them at: K1 (with and without the log-sum-exp write), K2 (with
the lse K1 wrote, as a train step calls it, and its two kernels' device
times) and S3, beside `F.scaled_dot_product_attention` forward and backward,
each with the share of its bound it reaches; and the host time of a K1 call.

    python3 scripts/torch_attn_bench.py [--iters 50] [--rounds 2]
                                        [--other-k1 path/to/flash_attn_fwd-*.so]

Every kernel is held against its plain version first (K1 and S3 at 2e-2, K2
at 5e-3 of the largest |reference|); a mismatch exits non-zero. Times are
CUDA events over `--iters` launches after a warm-up, the best of `--rounds`
rounds run in turns. A kernel's bound is the larger of the bytes it must move
(each input read once, each output written once) at 3.35 TB/s and its
operations (4 B H S T D for the forward, 10 B H S T D for K2's five products)
at 989 TFLOP/s. The host time of a K1 call is `time.perf_counter` over 1000
calls of the wrapper without a synchronize (the least and the median of
five such rounds), at the batch-1 request shapes, where a call's device time
is a few tens of microseconds; beside it, the kernel's own device time at
those shapes from torch.profiler. With `--other-k1`, another build of K1's
library (another tree's `tunevlseg_torch/_build/flash_attn_fwd-*.so`, which
takes the same C arguments) is put behind the same wrapper and measured the
same way in turns with this tree's, in one process. Prints the card's name
and power limit first, then one line per kernel and shape, and a last JSON
line with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402
from tunevlseg_torch.ops import flash_attention_variants as fav  # noqa: E402

# (label, (B, S, H, D), kv_valid): CLIPSeg's vision tower and decoder at
# b64, with four visual contexts, a padded sequence, the e2e step's b16, and
# the CRIS decoder
SHAPES = (("vision", (64, 485, 12, 64), None), ("decoder", (64, 485, 4, 16), None),
          ("vision 489", (64, 489, 12, 64), None), ("decoder 489", (64, 489, 4, 16), None),
          ("vision kv_valid", (64, 512, 12, 64), 485),
          ("e2e vision", (16, 485, 12, 64), None), ("e2e decoder", (16, 485, 4, 16), None),
          ("cris decoder", (64, 676, 8, 64), None))
# the batch-1 request's shapes, where the host time of a K1 call is measured
HOST_SHAPES = (("b1 vision", (1, 485, 12, 64)), ("b1 decoder", (1, 485, 4, 16)))
K2_REL_TOL = 5e-3
KERNEL_TOL = 2e-2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12


def bound_ms(nbytes: int, flops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3


def host_us(fn, calls: int = 1000) -> float:
    """Host time per call of `fn` over `calls` calls, no synchronize in
    between (the launches are only enqueued)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def event_ms(fn, iters: int, warmup: int = 3) -> float:
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


def device_ms(fn, n: int = 5) -> dict:
    """Device time per call of each kernel `fn` launches, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def check(label: str, got, want, tol: float) -> float:
    worst = 0.0
    for a, w in zip(got, want):
        top = w.float().abs().max().item()
        err = (a.float() - w.float()).abs().max().item() / max(top, 1e-30)
        worst = max(worst, err)
    if not worst <= tol:
        sys.exit(f"{label}: kernel and plain version disagree: {worst} > {tol}")
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--other-k1", default=None,
                    help="another build of K1's library to time the host cost against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, (b, s, h, d), kv in SHAPES:
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        t = kv or s
        _, lse = fa._launch(q, k, v, t, with_lse=True)
        row = {"shape": [b, s, h, d], "kv_valid": kv}
        row["k1_err"] = check(f"K1 {label}", [fa._launch(q, k, v, t)],
                              [fa.flash_attention_ref(q, k, v, kv)], KERNEL_TOL)
        row["k2_err"] = check(f"K2 {label}", fa.flash_attention_bwd(q, k, v, g, kv, lse=lse),
                              fa.flash_attention_bwd_ref(q, k, v, g, kv), K2_REL_TOL)
        fns = {"k1": lambda: fa._launch(q, k, v, t),
               "k1_lse": lambda: fa._launch(q, k, v, t, with_lse=True),
               "k2": lambda: fa.flash_attention_bwd(q, k, v, g, kv, lse=lse)}
        if d == fav.HEAD_DIM:
            row["s3_err"] = check(f"S3 {label}", [fav.attention_ones_column(q, k, v, kv)],
                                  [fav.attention_ones_column_ref(q, k, v, kv)], KERNEL_TOL)
            fns["s3"] = lambda: fav.attention_ones_column(q, k, v, kv)
        keep = None if kv is None else (torch.arange(s, device="cuda") < kv)[None, None, None]
        qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        fns["sdpa_bwd"] = lambda: torch.autograd.grad(out, (qg, kg, vg), gt,
                                                      retain_graph=True)
        for _ in range(args.rounds):        # in turns: drift hits every row alike
            for name, fn in fns.items():
                ms = event_ms(fn, args.iters)
                row[name] = min(row.get(name, ms), ms)
        parts = device_ms(fns["k2"])
        row["k2_dq_pass"] = sum(x for n, x in parts.items() if "bwd_dq" in n)
        row["k2_dkdv_pass"] = sum(x for n, x in parts.items() if "dkdv" in n)
        tensor = b * s * h * d * 2
        fwd_bound = bound_ms(4 * tensor, 4 * b * h * s * t * d)
        bounds = {"k1": fwd_bound, "k1_lse": bound_ms(4 * tensor + 4 * b * h * s,
                                                      4 * b * h * s * t * d),
                  "k2": bound_ms(7 * tensor + 4 * b * h * s, 10 * b * h * s * t * d),
                  "s3": fwd_bound}
        for name, ms in bounds.items():
            if name in row:
                row[f"{name}_bound_share"] = ms / row[name]
        row["k1_bound_ms"] = fwd_bound
        print(f"{label} {(b, s, h, d)} kv_valid {kv}: " + ", ".join(
            f"{n} {x:.4f}" for n, x in row.items() if isinstance(x, float)))
        results[label] = row
        del out
    results.update(k1_host_times(gen, args.other_k1))
    print(json.dumps(results))


def k1_host_times(gen, other: str = None, rounds: int = 5) -> dict:
    """Host microseconds per K1 call at the batch-1 shapes, through the
    wrapper alone (`_launch`) and through `flash_attention`, and the kernel's
    device time from torch.profiler; for this tree's library and, with
    `other`, the library at that path behind the same wrapper, in turns."""
    mine = fa.load_library()["fwd"]
    libs = {"this tree": mine}
    if other:
        lib = ctypes.CDLL(other)
        lib.tvs_flash_attn_fwd.argtypes = mine.tvs_flash_attn_fwd.argtypes
        lib.tvs_flash_attn_fwd.restype = mine.tvs_flash_attn_fwd.restype
        libs[other] = lib
    results = {}
    for label, (b, s, h, d) in HOST_SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        samples = {name: {"launch": [], "flash_attention": []} for name in libs}
        for _ in range(rounds):             # in turns: drift hits both alike
            for name, lib in libs.items():
                fa._libs["fwd"] = lib
                samples[name]["launch"].append(host_us(lambda: fa._launch(q, k, v, s)))
                samples[name]["flash_attention"].append(
                    host_us(lambda: fa.flash_attention(q, k, v)))
        for name, lib in libs.items():
            fa._libs["fwd"] = lib
            device = sum(x for n, x in device_ms(lambda: fa._launch(q, k, v, s)).items()
                         if "flash_attn_fwd" in n)
            row = {"shape": [b, s, h, d], "device_ms": device}
            for path, values in samples[name].items():
                row[f"{path}_host_us_min"] = min(values)
                row[f"{path}_host_us_median"] = statistics.median(values)
            print(f"{label} {(b, s, h, d)} K1 of {name}: host us per call, least / median "
                  f"of {rounds} rounds of 1000: launch alone "
                  f"{row['launch_host_us_min']:.2f} / {row['launch_host_us_median']:.2f}, "
                  f"through flash_attention {row['flash_attention_host_us_min']:.2f} / "
                  f"{row['flash_attention_host_us_median']:.2f}; kernel device time "
                  f"{device * 1e3:.2f} us")
            results[f"{label} ({name})"] = row
        fa._libs["fwd"] = mine
    return results


if __name__ == "__main__":
    main()

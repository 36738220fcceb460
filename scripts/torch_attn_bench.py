#!/usr/bin/env python3
"""Times the attention kernels of the port on one CUDA GPU at the shapes the
models launch them at: K1 (with and without the log-sum-exp write), K2 (with
the lse K1 wrote, as a train step calls it, and its two kernels' device
times), S3 and K3 (the text towers' causal + padding attention at U = 1 and
U = 64 rows, the CRIS cross-attention from 676 queries into 77 keys), beside
`F.scaled_dot_product_attention` forward and backward (with the same mask
for K3), each with the share of its bound it reaches; and the host time of a
K1 and of a K3 call.

    python3 scripts/torch_attn_bench.py [--iters 50] [--rounds 2]
                                        [--other-k1 path/to/flash_attn_fwd-*.so]
                                        [--other-k3 path/to/flash_attn_bias_fwd-*.so ...]
                                        [--other-tree path/to/other/checkout]
                                        [--k3-only]

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
same way in turns with this tree's, in one process. `--other-k3` does the
same for K3's library (`flash_attn_bias_fwd-*.so`; it may be given more than
once): each build's output against the plain version, its event time, its
device time from torch.profiler and, at U = 1, its host microseconds per
`biased_attention` call (the least and the median of 3 x `--rounds` rounds
of 1000 calls, the builds in turns), one process. `--other-tree` loads another
checkout's K3 wrapper (`tunevlseg_torch/ops/flash_attention.py`) under
another module name, with its kernels built from that checkout's sources,
and times it the same way in turns with this tree's: another commit's K3 as
a caller meets it, wrapper and kernel. `--k3-only` times K3 alone. Prints
the card's name and power limit first, then one line per kernel and shape,
and a last JSON line with every number.
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
# K3's shapes: (label, batch rows, query rows); 8 heads of 64 into the
# text's 77 tokens, of which 14 are real (10 words + 4 contexts)
K3_SHAPES = (("text U=1", 1, 77), ("text U=64", 64, 77), ("cris cross", 64, 676))
K3_SEQ = 77
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
    ap.add_argument("--other-k3", action="append", default=[],
                    help="another build of K3's library to time against (repeatable)")
    ap.add_argument("--k3-only", action="store_true", help="time K3 alone")
    ap.add_argument("--other-tree", default=None,
                    help="the root of another checkout whose K3 wrapper and kernel to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"k3": k3_times(gen, args.other_k3, args.other_tree, args.iters,
                              args.rounds)}
    for label, (b, s, h, d), kv in () if args.k3_only else SHAPES:
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
    if not args.k3_only:
        results.update(k1_host_times(gen, args.other_k1))
    print(json.dumps(results))


def other_tree_wrapper(root: str):
    """Another checkout's `ops/flash_attention.py` as a module of its own,
    its libraries built by that checkout's `ops/build.py` from its sources."""
    import importlib.util

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    ops = Path(root).resolve() / "tunevlseg_torch" / "ops"
    wrapper = load("other_tree_flash_attention", ops / "flash_attention.py")
    wrapper.build = load("other_tree_build", ops / "build.py")
    wrapper.load_library()
    return wrapper


def k3_times(gen, others, other_tree, iters: int, rounds: int) -> dict:
    """K3 at its three shapes, for this tree's library, each of `others`
    behind the same wrapper, and `other_tree`'s wrapper with its own
    library, in turns: output against the plain version, event and device
    time, `scaled_dot_product_attention` with the same boolean mask, and at
    U = 1 the host microseconds per call."""
    mine = fa.load_library()["bias"]
    # name: (wrapper module, K3 library it is given)
    libs = {"this tree": (fa, mine)}
    for path in others:
        lib = ctypes.CDLL(path)
        lib.tvs_biased_attn_fwd.argtypes = mine.tvs_biased_attn_fwd.argtypes
        lib.tvs_biased_attn_fwd.restype = mine.tvs_biased_attn_fwd.restype
        libs[path] = (fa, lib)
    if other_tree:
        wrapper = other_tree_wrapper(other_tree)
        libs[f"{other_tree} (its wrapper)"] = (wrapper, wrapper.load_library()["bias"])
    neg = torch.finfo(torch.float32).min
    causal = torch.triu(torch.full((K3_SEQ, K3_SEQ), neg, device="cuda"), 1)[None, None]
    results = {}
    for label, b, s in K3_SHAPES:
        q = torch.randn(b, s, 8, 64, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, K3_SEQ, 8, 64, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        bias = torch.zeros(b, 1, 1, K3_SEQ, device="cuda")
        bias[..., 14:] = neg
        if s == K3_SEQ:
            bias = bias + causal        # min + min overflows to -inf
        ref = fa.biased_attention_ref(q, k, v, bias)
        keep = bias > -1e30
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * bias.numel()
        bound = bound_ms(nbytes, 4 * b * 8 * s * K3_SEQ * 64)
        rows = {name: {"shape": [b, s, 8, 64], "bound_ms": bound} for name in libs}
        for name, (wrapper, lib) in libs.items():
            wrapper._libs["bias"] = lib
            rows[name]["err"] = check(f"K3 {label} ({name})",
                                      [wrapper.biased_attention(q, k, v, bias)], [ref],
                                      KERNEL_TOL)
        sdpa = None
        for _ in range(rounds):             # in turns: drift hits every build alike
            for name, (wrapper, lib) in libs.items():
                wrapper._libs["bias"] = lib
                ms = event_ms(lambda: wrapper.biased_attention(q, k, v, bias), iters)
                rows[name]["ms"] = min(rows[name].get("ms", ms), ms)
            ms = event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep),
                          iters)
            sdpa = ms if sdpa is None else min(sdpa, ms)
        if b == 1:
            for _ in range(3 * rounds):     # 1000 calls of each build in turns
                for name, (wrapper, lib) in libs.items():
                    wrapper._libs["bias"] = lib
                    rows[name].setdefault("host_us_rounds", []).append(
                        host_us(lambda: wrapper.biased_attention(q, k, v, bias)))
            for row in rows.values():
                row["host_us"] = min(row["host_us_rounds"])
                row["host_us_median"] = statistics.median(row["host_us_rounds"])
        for name, (wrapper, lib) in libs.items():
            wrapper._libs["bias"] = lib
            row = rows[name]
            row["device_ms"] = sum(x for n, x in device_ms(
                lambda: wrapper.biased_attention(q, k, v, bias)).items() if "biased_attn" in n)
            row["sdpa_ms"] = sdpa
            row["bound_share"] = bound / row["ms"]
            print(f"K3 {label} q{(b, s, 8, 64)} of {name}: err {row['err']:.3g}, "
                  f"events {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
                  f"SDPA with the mask {sdpa:.4f} ms, bound {bound:.5f} ms "
                  f"({100 * bound / row['device_ms']:.1f}% of it by device time)"
                  + (f", host us per call {row['host_us']:.2f} least, "
                     f"{row['host_us_median']:.2f} median of {len(row['host_us_rounds'])} "
                     "rounds of 1000" if "host_us" in row else ""))
            results[f"{label} ({name})"] = row
        fa._libs["bias"] = mine
    return results


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

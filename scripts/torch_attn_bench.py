#!/usr/bin/env python3
"""Times the attention kernels of the port on one CUDA GPU at the shapes the
models launch them at: K1 (with and without the log-sum-exp write), K2 (with
the lse K1 wrote, as a train step calls it, and its two kernels' device
times) and S3, beside `F.scaled_dot_product_attention` forward and backward.

    python3 scripts/torch_attn_bench.py [--iters 50] [--rounds 2]

Every kernel is held against its plain version first (K1 and S3 at 2e-2, K2
at 5e-3 of the largest |reference|); a mismatch exits non-zero. Times are
CUDA events over `--iters` launches after a warm-up, the best of `--rounds`
rounds run in turns. Prints the card's name and power limit first, then one
line per kernel and shape, and a last JSON line with every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402
from tunevlseg_torch.ops import flash_attention_variants as fav  # noqa: E402

# (label, (B, S, H, D), kv_valid): CLIPSeg's vision tower and decoder at
# b64, a padded sequence, and the CRIS decoder
SHAPES = (("vision", (64, 485, 12, 64), None), ("decoder", (64, 485, 4, 16), None),
          ("vision kv_valid", (64, 512, 12, 64), 485),
          ("cris decoder", (64, 676, 8, 64), None))
K2_REL_TOL = 5e-3
KERNEL_TOL = 2e-2


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
        print(f"{label} {(b, s, h, d)} kv_valid {kv}: " + ", ".join(
            f"{n} {x:.4f}" for n, x in row.items() if isinstance(x, float)))
        results[label] = row
        del out
    print(json.dumps(results))


if __name__ == "__main__":
    main()

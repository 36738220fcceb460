#!/usr/bin/env python3
"""The attention sweeps on one CUDA GPU: K1 (the models' self-attention
forward) against its variants S1-S4 at the CLIPSeg vision shape, bf16.

    python3 scripts/torch_micro_attn.py [--sweep all|hg|v2|grid] [--iters 50]

One script with three sweeps, the counterparts of the JAX package's
`scripts/micro_attn.py`, `scripts/micro_attn_v2.py` and
`scripts/micro_attn_grid.py`:

  hg    S1: hg in {2, 4, 6} heads per block, b64 x 485 x 12 x 64, q = k = v;
  v2    S2: the default (hg 3), hg 1 with exp2 (K1's own choices: the control
        that tells the variants' code from K1's), exp2, no max pass, both,
        the two products
        without a softmax at hg 3 / 2 / 6, hg 2 and 6, and the head-fastest
        block order at hg 6 and 3; S3 (scale folded into q, additive mask
        row, denominator out of the P V product), with and without the max
        pass; b64 x 512 x 12 x 64 with the keys from 485 on masked;
  grid  S4: (bg batch rows, hg heads) per block in the script's seven
        combinations, b64 x 485 x 12 x 64, q = k = v.

On this card "hg heads / bg batch rows per grid cell" is a block that loops
over its (batch, head) pairs, and the TPU's grid `dimension_semantics` become
the order of the blocks: "query" (query tile fastest: neighbours share a
head's K and V in L2) or "head" (see tunevlseg_torch/csrc/
flash_attn_fwd_variants.cu).

Every variant is held against its plain PyTorch version before it is timed,
on q, k and v drawn apart from a standard normal (outputs up to about 1; the
sweeps' own q = k = v inputs are small and near-uniform in their softmax,
where a kernel that wrote zeros would pass): max abs error <= 2e-2 of the
largest |reference| (a few bf16 ulp; the JAX scripts hold theirs against the
XLA attention at 2e-2). A mismatch, a build failure or a failed launch ends
the script with a non-zero exit code. Times are CUDA events over `--iters`
launches after a warm-up, on the sweep's own inputs, the better of two rounds
run in turns.
Per variant: ms, TFLOP/s of 4 B H S T D, and the share of the call's bound
(the larger of q, k, v, o read or written once at 3.35 TB/s and the
operations at 989 TFLOP/s) that it reaches. K1 itself and
`F.scaled_dot_product_attention` (a yardstick: the port never calls it) run
in the same turns. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402
from tunevlseg_torch.ops import flash_attention_variants as fav  # noqa: E402

TOL = 2e-2                  # of the largest |reference|: a few bf16 ulp
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12


def _variant(**kw):
    return (fav.attention_variant, fav.attention_variant_ref, kw)


def _ones_column(**kw):
    return (fav.attention_ones_column, fav.attention_ones_column_ref, kw)


# sweep -> (which TPU kernels it ports, sequence length, kv_valid, q = k = v,
#           [(tag, (kernel wrapper, plain version, switches))])
SWEEPS = {
    "hg": ("S1", 485, None, True,
           [(f"hg{hg}", _variant(hg=hg)) for hg in (2, 4, 6)]),
    "v2": ("S2, S3", 512, 485, False, [
        ("ours (hg3)", _variant(hg=3)),
        ("hg1 exp2 (K1's choices)", _variant(hg=1, use_exp2=True)),
        ("exp2", _variant(hg=3, use_exp2=True)),
        ("nomax", _variant(hg=3, skip_max=True)),
        ("exp2+nomax", _variant(hg=3, use_exp2=True, skip_max=True)),
        ("gemmonly", _variant(hg=3, gemm_only=True)),
        ("gemmonly-hg2", _variant(hg=2, gemm_only=True)),
        ("gemmonly-hg6", _variant(hg=6, gemm_only=True)),
        ("hg2", _variant(hg=2)),
        ("hg6", _variant(hg=6)),
        ("hg6-headfast", _variant(hg=6, block_order="head")),
        ("hg3-headfast", _variant(hg=3, block_order="head")),
        ("opt (S3)", _ones_column(hg=3)),
        ("opt-nomax (S3)", _ones_column(hg=3, skip_max=True)),
    ]),
    "grid": ("S4", 485, None, True, [
        (f"bg{bg} hg{hg} {order}", _variant(bg=bg, hg=hg, block_order=order))
        for bg, hg, order in ((1, 3, "query"), (2, 3, "head"), (2, 3, "query"),
                              (4, 2, "head"), (4, 3, "query"), (8, 1, "query"),
                              (2, 6, "query"))]),
}


def call_bound_ms(b: int, s: int, h: int, d: int, t_valid: int):
    """(bound ms, "bytes" | "operations", operations) of one attention call."""
    flops = 4 * b * h * s * t_valid * d
    by_bytes = 4 * b * s * h * d * 2 / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", flops


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


def sweep_inputs(name: str, batch: int, heads: int, at: tuple = None):
    """(seq, kv_valid, the q, k, v a sweep is timed on, the q, k, v its
    variants are checked on). `at` = (seq, kv_valid) overrides the sweep's own
    length. The check's inputs are apart and standard normal; a sweep that
    times such inputs checks on the same tensors."""
    _, seq, kv_valid, shared, _ = SWEEPS[name]
    if at is not None:
        seq, kv_valid = at
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(scale: float = 1.0):
        x = torch.randn(batch, seq, heads, fav.HEAD_DIM, generator=gen, device="cuda")
        return (x * scale).bfloat16()

    if not shared:
        timed = checked = (rnd(), rnd(), rnd())
    else:
        timed = (rnd(0.05),) * 3
        checked = (rnd(), rnd(), rnd())
    return seq, kv_valid, timed, checked


def check_variants(name: str, batch: int = 64, heads: int = 12,
                   at: tuple = None) -> list[dict]:
    """Every variant of one sweep against its plain version; exits non-zero on
    a mismatch. Returns one dict per variant: tag, kw (its switches),
    max_abs_err, ref_max (the largest |reference|), plain_ms (the plain
    version, timed once)."""
    seq, kv_valid, _, (q, k, v) = sweep_inputs(name, batch, heads, at)
    print(f"sweep {name} ({SWEEPS[name][0]}): check at b{batch} s{seq} h{heads} "
          f"d{fav.HEAD_DIM} bf16, kv_valid {kv_valid}, q, k, v apart, standard normal")
    rows = []
    for tag, (kernel, plain, kw) in SWEEPS[name][4]:
        out = kernel(q, k, v, kv_valid, **kw)
        torch.cuda.synchronize()
        ref = plain(q, k, v, kv_valid, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        plain_ms = event_ms(lambda: plain(q, k, v, kv_valid, **kw), 2, warmup=1)
        del ref
        print(f"check {tag:24s} max abs err vs its plain version {err:.3e} "
              f"(bound {TOL * ref_max:.3g} = {TOL} of the largest |reference|)")
        if not (out.shape == q.shape and err <= TOL * ref_max
                and bool(out.isfinite().all())):
            sys.exit(f"{name} {tag}: kernel and plain version disagree: {err}")
        rows.append({"tag": tag, "kw": kw, "max_abs_err": err, "ref_max": ref_max,
                     "plain_ms": plain_ms})
    return rows


def time_variants(name: str, checked: list[dict], iters: int = 50, batch: int = 64,
                  heads: int = 12, rounds: int = 2, at: tuple = None) -> list[dict]:
    """Time the variants of one sweep, K1 and the yardstick on the sweep's
    inputs; returns `checked` with ms, tflops and bound_share added, and two
    more rows (K1's and the yardstick's, max_abs_err None)."""
    if iters < 20:
        raise ValueError("time at least 20 launches")
    seq, kv_valid, (q, k, v), _ = sweep_inputs(name, batch, heads, at)
    d = fav.HEAD_DIM
    shared = q is k
    bound_ms, bound_by, flops = call_bound_ms(batch, seq, heads, d, kv_valid or seq)
    print(f"sweep {name}: timed at b{batch} s{seq} h{heads} d{d} bf16, kv_valid "
          f"{kv_valid}, {'q = k = v' if shared else 'q, k, v apart'}; "
          f"{flops / 1e9:.2f} GFLOP a call, bound {bound_ms:.4f} ms by {bound_by}")
    kernels = {tag: variant[0] for tag, variant in SWEEPS[name][4]}
    fns = [(lambda kernel=kernels[row["tag"]], kw=row["kw"]:
            kernel(q, k, v, kv_valid, **kw)) for row in checked]
    keep = None if kv_valid is None else (
        torch.arange(seq, device="cuda") < kv_valid)[None, None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows = checked + [
        {"tag": "K1", "kw": {}, "max_abs_err": None, "plain_ms": None},
        {"tag": "sdpa (yardstick)", "kw": {}, "max_abs_err": None, "plain_ms": None}]
    fns.append(lambda: fa.flash_attention(q, k, v, kv_valid=kv_valid))
    fns.append(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep))
    for _ in range(rounds):             # in turns: drift hits every row alike
        for row, fn in zip(rows, fns):
            ms = event_ms(fn, iters)
            row["ms"] = min(row.get("ms", ms), ms)
    for row in rows:
        # the two products alone run over every key: they take no mask
        t_valid = seq if row["kw"].get("gemm_only") else (kv_valid or seq)
        bound_ms, _, flops = call_bound_ms(batch, seq, heads, d, t_valid)
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = bound_ms / row["ms"]
    print(f"best of {rounds} rounds of {iters} launches:")
    for row in sorted(rows, key=lambda r: r["ms"]):
        print(f"  {row['tag']:24s} {row['ms']:8.4f} ms  {row['tflops']:7.1f} TFLOP/s  "
              f"{100 * row['bound_share']:5.1f}% of the bound")
    return rows


def run_sweep(name: str, iters: int = 50, batch: int = 64, heads: int = 12,
              rounds: int = 2, at: tuple = None) -> list[dict]:
    """Check, then time, every variant of one sweep (`check_variants`,
    `time_variants`)."""
    rows = check_variants(name, batch, heads, at)
    return time_variants(name, rows, iters, batch, heads, rounds, at)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", default="all", choices=("all", *SWEEPS))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--heads", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for name in (SWEEPS if args.sweep == "all" else (args.sweep,)):
        run_sweep(name, args.iters, args.batch, args.heads)


if __name__ == "__main__":
    main()

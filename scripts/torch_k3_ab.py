#!/usr/bin/env python3
"""The design choices of K3 (`tunevlseg_torch/csrc/flash_attn_bias_fwd.cu`)
held against each other on one CUDA GPU: each variant is the committed
source with one choice undone, built with the same `nvcc` flags into
`tunevlseg_torch/_build/k3_ab/`, put behind the same wrapper and timed in
turns with the committed build at the CRIS cross shape (b64, 676 queries
into 77 keys, 8 heads of 64, key-padding bias) and the text shape (b64, 77
tokens, causal + padding bias).

    python3 scripts/torch_k3_ab.py [--iters 50] [--rounds 3] [--phases]

Every build is held against the plain version first (2e-2): each variant
computes the same function. Times are CUDA events over `--iters` launches
(the least of `--rounds` rounds in turns) and the device time from
torch.profiler. With `--phases`, a build of the committed source that also
adds up `clock64()` cycles per phase of one consumer warpgroup (waiting for
its Q tile, for K and V, the score product with the bias loads, the
softmax, the P V product, the epilogue) prints the mean cycles per
warpgroup and query tile. Prints the card's name and power limit first, one
line per build and shape, and a last JSON line with every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
from torch_attn_bench import KERNEL_TOL, check, device_ms, event_ms  # noqa: E402

from tunevlseg_torch.ops import build  # noqa: E402
from tunevlseg_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = build.SOURCES["bias"]
OUT = build.BUILD_DIR / "k3_ab"

# variant: (what it undoes, [(text of the committed source, replacement)])
VARIANTS = {
    "two blocks per SM": ("one block per SM (168 registers): two at 96 spill",
                          [("kMinBlocks = 1;", "kMinBlocks = 2;")]),
    "64-key tiles": ("80-key tiles: the text's 77 keys in one",
                     [("kBN = 80;", "kBN = 64;")]),
    "one query tile a block": ("runs of a pair's query tiles past resident K and V",
                               [("  int best = 1;\n", "  return 1;\n  int best = 1;\n")]),
    "three Q stages": ("two Q stages", [("kQStages = 2;", "kQStages = 3;")]),
    "bias per query tile": ("a query-broadcast bias loaded once a run",
                            [("const bool bias_once = kBias && p.bs[2] == 0 && p.n_kt == 1;",
                              "const bool bias_once = false;")]),
    "a division per element": (
        "one reciprocal a row",
        [("    const float inv[2] = {1.f / group4_sum(sum[0]), 1.f / group4_sum(sum[1])};\n",
          "    const float denom[2] = {group4_sum(sum[0]), group4_sum(sum[1])};\n"
          "#pragma unroll\n"
          "    for (int i = 0; i < D / 2; ++i) acc[i] /= denom[acc_row_half(i)];\n"
          "    const float inv[2] = {1.f, 1.f};\n")]),
    "exp2f": ("ex2.approx.ftz", [("= exp2_ftz((", "= exp2f((")]),
}

# the phases build: cycles from one thread of each consumer warpgroup
PHASES = ("wait for Q", "wait for K / V", "score product + bias loads", "softmax",
          "P V product", "epilogue")
TICK = ("#define TICK(k) do { if (t == 0) { const long long now_ = clock64(); "
        "atomicAdd(&g_cycles[k], (unsigned long long)(now_ - t0_)); t0_ = now_; } } while (0)\n")
PHASE_EDITS = [
    ('#include "attn_fwd_hopper.cuh"', '#include "attn_fwd_hopper.cuh"\n'
     "__device__ unsigned long long g_cycles[8];\n" + TICK),
    ("  if (bias_once) load_bias(0, 0);\n  int it = 0;\n",
     "  if (bias_once) load_bias(0, 0);\n  int it = 0;\n  long long t0_ = clock64();\n"),
    ("    mbar_wait(&q_full[qs], (j / kQStages) & 1);\n",
     "    mbar_wait(&q_full[qs], (j / kQStages) & 1);\n    TICK(0);\n"),
    ("      mbar_wait(&kv_full[s], resident ? 0 : (it / kKvStages) & 1);\n",
     "      mbar_wait(&kv_full[s], resident ? 0 : (it / kKvStages) & 1);\n      TICK(1);\n"),
    ("      wgmma_wait<0>();\n      fence_operands(sc);\n",
     "      wgmma_wait<0>();\n      fence_operands(sc);\n      TICK(2);\n"),
    ("      fence_operands(acc);\n      wgmma_fence();\n      const uint64_t mn_v",
     "      TICK(3);\n      fence_operands(acc);\n      wgmma_fence();\n      const uint64_t mn_v"),
    ("      if (!resident && lane == 0) mbar_arrive(&kv_empty[s]);\n",
     "      TICK(4);\n      if (!resident && lane == 0) mbar_arrive(&kv_empty[s]);\n"),
    ("            *reinterpret_cast<const uint4*>(stage + r * L::kOutStride + c);\n    }\n",
     "            *reinterpret_cast<const uint4*>(stage + r * L::kOutStride + c);\n    }\n"
     "    TICK(5);\n    if (t == 0) atomicAdd(&g_cycles[6], 1ull);\n"),
]
PHASE_ENTRY = """
extern "C" int tvs_k3_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zeros[8] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_cycles, zeros, sizeof(zeros)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_cycles, sizeof(g_cycles)));
}
"""


def edited(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            sys.exit(f"the committed K3 source no longer holds {old!r}: update this script")
        text = text.replace(old, new)
    return text


def build_all(sources: dict) -> dict:
    """{name: source text} -> {name: library}, one nvcc each, side by side."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src = OUT / f"k3_{i}.cu"
        src.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(SOURCE.parent),
               "-o", str(OUT / f"k3_{i}.so"), str(src)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    mine = fa.load_library()["bias"]
    libs = {}
    for name, (i, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed building {name}:\n{log}")
        spills = [line.strip() for line in log.splitlines() if "spill stores" in line]
        print(f"build {name}: " + "; ".join(sorted(set(spills))))
        lib = ctypes.CDLL(str(OUT / f"k3_{i}.so"))
        lib.tvs_biased_attn_fwd.argtypes = mine.tvs_biased_attn_fwd.argtypes
        lib.tvs_biased_attn_fwd.restype = mine.tvs_biased_attn_fwd.restype
        libs[name] = lib
    return libs


def shapes(gen):
    neg = torch.finfo(torch.float32).min
    for label, b, s in (("cris cross", 64, 676), ("text U=64", 64, 77)):
        q = torch.randn(b, s, 8, 64, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, 77, 8, 64, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        bias = torch.zeros(b, 1, 1, 77, device="cuda")
        bias[..., 14:] = neg
        if s == 77:
            bias = bias + torch.triu(torch.full((77, 77), neg, device="cuda"), 1)[None, None]
        yield label, q, k, v, bias


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    sources = {name: edited(edits) for name, (_, edits) in VARIANTS.items()}
    if args.phases:
        sources["phases"] = edited(PHASE_EDITS) + PHASE_ENTRY
    libs = {"committed": fa.load_library()["bias"], **build_all(sources)}
    phases = libs.pop("phases", None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for label, q, k, v, bias in shapes(gen):
        ref = fa.biased_attention_ref(q, k, v, bias)
        rows = {}
        for name, lib in libs.items():
            fa._libs["bias"] = lib
            rows[name] = {"err": check(f"K3 {label} ({name})",
                                       [fa.biased_attention(q, k, v, bias)], [ref], KERNEL_TOL)}
        for _ in range(args.rounds):        # in turns: drift hits every build alike
            for name, lib in libs.items():
                fa._libs["bias"] = lib
                ms = event_ms(lambda: fa.biased_attention(q, k, v, bias), args.iters)
                rows[name]["ms"] = min(rows[name].get("ms", ms), ms)
        for name, lib in libs.items():
            fa._libs["bias"] = lib
            row = rows[name]
            row["device_ms"] = sum(x for n, x in device_ms(
                lambda: fa.biased_attention(q, k, v, bias)).items() if "biased_attn" in n)
            undoes = VARIANTS[name][0] if name in VARIANTS else "the committed source"
            print(f"K3 {label}, {name} (undoes: {undoes}): err {row['err']:.3g}, events "
                  f"{row['ms']:.4f} ms, device {row['device_ms']:.4f} ms")
        if phases is not None:
            phases.tvs_k3_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
            fa._libs["bias"] = phases
            check(f"K3 {label} (phases)", [fa.biased_attention(q, k, v, bias)], [ref],
                  KERNEL_TOL)
            torch.cuda.synchronize()
            phases.tvs_k3_cycles(None, 1)
            for _ in range(args.iters):
                fa.biased_attention(q, k, v, bias)
            torch.cuda.synchronize()
            cycles = (ctypes.c_ulonglong * 8)()
            phases.tvs_k3_cycles(ctypes.addressof(cycles), 0)
            tiles = cycles[6]
            rows["phases (cycles per warpgroup and query tile)"] = {
                name: cycles[i] / tiles for i, name in enumerate(PHASES)}
            print(f"K3 {label} cycles per warpgroup and query tile: " + ", ".join(
                f"{name} {cycles[i] / tiles:.0f}" for i, name in enumerate(PHASES)))
        fa._libs["bias"] = libs["committed"]
        results[label] = rows
    print(json.dumps(results))


if __name__ == "__main__":
    main()

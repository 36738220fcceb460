#!/usr/bin/env python3
"""Every convolution of the CRIS RN50 on the flat layout, K4 against cuDNN.

    python3 scripts/torch_conv_flat_bench.py [--batch 64] [--tile-widths]

Builds the full-width bf16 CRIS model with `layout="flat"` on the CUDA card,
records the 54 calls of `conv_flat` that one backbone forward makes at 416^2,
and times each distinct shape (CUDA events, 20 launches after 3 warm-up):
  * K4 through `conv_flat` (weight copy, launch, fused epilogue);
  * `F.conv2d` alone, bf16 channels-last, on the unpadded pixels;
  * what the "nchw" layout runs in K4's place: `F.conv2d`, the one-pass
    BatchNorm, the residual add and the ReLU as separate kernels;
  * the bound from the pixel work (operations over 989 TFLOP/s against bytes
    over 3.35 TB/s);
  * the share of K4's output rows that are guard or ring rows, and what
    writing them as zeros costs at 3.35 TB/s;
  * with --tile-widths, K4's own launch at each of its tile widths (64, 128
    and 256 output channels) beside the one its rule picks.
Then the copies around the flat chains (`to_flat` at each stage's entry, the
pools between specs of the strided blocks, the exits) and the whole backbone
on both layouts. Prints the card's name and power limit first. The numbers
of PERF.md's K4 table by convolution come from this script.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tunevlseg_torch.models.cris import resnet  # noqa: E402
from tunevlseg_torch.models.presets import build_cris  # noqa: E402
from tunevlseg_torch.ops import conv_flat as cf  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--tile-widths", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this script needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    b = args.batch
    model, _ = build_cris("coop", prompt_depth=3, num_context=4, layout="flat",
                          dtype=torch.bfloat16, device="cuda", seed=0)
    net = model.visual
    gen = torch.Generator(device="cuda").manual_seed(0)
    image = torch.randn(b, 3, 416, 416, generator=gen, device="cuda")

    calls, copies = [], []
    real_conv, real_to, real_pool = resnet.conv_flat, resnet.to_flat, resnet._pool_flat

    def rec_conv(flat, spec, weight, scale=None, offset=None, relu=False,
                 residual=None):
        calls.append((spec, flat.shape[-1], weight.shape[0], weight.shape[2], relu,
                      residual is not None))
        return real_conv(flat, spec, weight, scale, offset, relu, residual)

    def rec_to(x, spec):
        copies.append(("to_flat", tuple(x.shape), spec, None))
        return real_to(x, spec)

    def rec_pool(flat, si, so, window):
        copies.append(("pool_flat", tuple(flat.shape), si, so))
        with mock.patch.object(resnet, "to_flat", real_to):
            return real_pool(flat, si, so, window)

    with torch.no_grad(), mock.patch.object(resnet, "conv_flat", rec_conv), \
            mock.patch.object(resnet, "to_flat", rec_to), \
            mock.patch.object(resnet, "_pool_flat", rec_pool):
        net(image)
    print(f"one backbone forward at b{b}, 416^2: {len(calls)} conv_flat calls, "
          f"{len(copies)} copies into flat space")

    widths = (64, 128, 256) if args.tile_widths else ()
    print("| H=W | rows / pixels | C→Cout k | epilogue | calls | K4 ms | "
          "F.conv2d ms | conv2d + BN (+add) + ReLU ms | bound ms (by) | "
          "K4 / conv2d | K4 / unfused | guard + ring rows | their zeros ms |"
          + "".join(f" K4 at {n} ms |" for n in widths))
    print("|---" * (13 + len(widths)) + "|")
    totals = collections.Counter()
    with torch.no_grad():
        for key, n in collections.Counter(calls).items():
            spec, c, cout, k, relu, has_res = key
            hw = spec.h
            x = cf.flat_begin(torch.randn(b, hw, hw, c, generator=gen,
                                          device="cuda").bfloat16(), spec)
            w = torch.randn(cout, c, k, k, generator=gen, device="cuda") \
                * (k * k * c) ** -0.5
            scale = torch.rand(cout, generator=gen, device="cuda") + 0.5
            offset = torch.randn(cout, generator=gen, device="cuda") * 0.1
            res = cf.flat_begin(torch.randn(b, hw, hw, cout, generator=gen,
                                            device="cuda").bfloat16(), spec) \
                if has_res else None
            k4 = cuda_ms(lambda: cf.conv_flat(x, spec, w, scale, offset, relu, res))
            xn = cf.flat_end(x, spec).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            rn = None if res is None else cf.flat_end(res, spec).permute(
                0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            wc = w.bfloat16().contiguous(memory_format=torch.channels_last)
            mean, var = torch.zeros_like(scale), torch.ones_like(scale)
            lib = cuda_ms(lambda: F.conv2d(xn, wc, padding=k // 2))

            def unfused():
                # the nchw Bottleneck's kernels: weight cast, convolution,
                # BatchNorm, add, ReLU
                y = F.batch_norm(F.conv2d(xn, w.to(xn.dtype), padding=k // 2),
                                 mean, var, scale, offset, False, 0.0, 1e-5)
                if rn is not None:
                    y = y + rn
                return F.relu(y) if relu else y

            unf = cuda_ms(unfused)
            flops = 2 * b * hw * hw * k * k * c * cout
            nbytes = 2 * (b * hw * hw * (c + cout * (2 if has_res else 1))
                          + k * k * c * cout)
            by_ops, by_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(by_ops, by_bytes)
            epi = "affine" + (" + res" if has_res else "") + (" + ReLU" if relu else "")
            # the rows of K4's output that hold no pixel, written as zeros
            guard_share = 1 - hw * hw / spec.rows
            guard_ms = b * (spec.rows - hw * hw) * cout * 2 / HBM_BYTES_PER_S * 1e3
            by_width = ""
            if widths:
                w_mat = w.permute(2, 3, 1, 0).reshape(k * k * c, cout)
                for bn in widths:
                    by_width += " {:.4f} |".format(cuda_ms(lambda: cf._launch(
                        spec, relu, x, w_mat, scale, offset, res, k, False, bn)))
            print(f"| {hw} | {spec.rows} / {hw * hw} | {c}→{cout} k{k} | {epi} | {n} "
                  f"| {k4:.4f} | {lib:.4f} | {unf:.4f} | {bound:.4f} "
                  f"({'operations' if by_ops > by_bytes else 'bytes'}) | "
                  f"{k4 / lib:.2f} | {k4 / unf:.2f} | {guard_share:.3f} | "
                  f"{guard_ms:.4f} |" + by_width)
            totals.update(k4=n * k4, lib=n * lib, unf=n * unf, bound=n * bound,
                          guard=n * guard_ms)
            del x, res, xn, rn
        print(f"all {len(calls)} convolutions: K4 {totals['k4']:.3f} ms, F.conv2d "
              f"alone {totals['lib']:.3f} ms, conv2d + BN (+add) + ReLU "
              f"{totals['unf']:.3f} ms, bound {totals['bound']:.3f} ms; writing "
              f"the guard and ring rows' zeros {totals['guard']:.3f} ms of K4's")

        total_copy = 0.0
        for kind, shape, si, so in copies:
            if kind == "to_flat":
                x = torch.randn(shape, generator=gen, device="cuda").bfloat16() \
                    .contiguous(memory_format=torch.channels_last)
                ms = cuda_ms(lambda: real_to(x, si))
            else:
                x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
                ms = cuda_ms(lambda: real_pool(x, si, so, 2))
            total_copy += ms
            print(f"copy {kind} {shape} -> rows {(so or si).rows}: {ms:.4f} ms")
        print(f"all {len(copies)} copies into flat space: {total_copy:.3f} ms")

        flat_ms = cuda_ms(lambda: net(image), iters=5, warmup=2)
        with mock.patch.object(net, "layout", "nchw"):
            nchw_ms = cuda_ms(lambda: net(image), iters=5, warmup=2)
        again = cuda_ms(lambda: net(image), iters=5, warmup=2)
        print(f"RN50 + attention pool forward at b{b}: flat {flat_ms:.3f} ms, nchw "
              f"{nchw_ms:.3f} ms, flat again {again:.3f} ms")


if __name__ == "__main__":
    main()

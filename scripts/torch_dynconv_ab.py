#!/usr/bin/env python3
"""Two formulations of the CRIS projector's per-sample dynamic convolution,
and the additive head's k5 convolution, timed forward and backward on one
CUDA GPU at the full-width shapes (b64, 256 channels, 104 x 104; bf16).

    python3 scripts/torch_dynconv_ab.py

  * grouped: `F.conv2d(x.reshape(1, B*C, H, W), weight, groups=B)`, the
    reference's formulation;
  * taps: one batched product over the channels, (B, 9, C) @ (B, C, H*W),
    which reads x once, then the nine (B, H, W) tap maps shifted and summed
    in f32 (what the JAX package's nine shifted contractions compute).
Run in turns (grouped, taps, taps, grouped); CUDA events, median of 5.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from tunevlseg_torch.models.cris.layers import dynamic_conv  # noqa: E402
from tunevlseg_torch.nn.conv import conv2d  # noqa: E402


def grouped(x, weight, bias):
    b, c, h, w = x.shape
    out = conv2d(x.reshape(1, b * c, h, w), weight, bias,
                 padding=weight.shape[-1] // 2, groups=b)
    return out.transpose(0, 1)


def fwd_bwd_ms(fn, inputs, reps: int = 5):
    def once():
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        out = fn(*inputs)
        marks[1].record()
        out.float().sum().backward()
        marks[2].record()
        torch.cuda.synchronize()
        for t in inputs:
            t.grad = None
        return marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])
    once()
    times = [once() for _ in range(reps)]
    return tuple(statistics.median(t[i] for t in times) for i in (0, 1))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
                .requires_grad_())

    x, weight, bias = rnd(64, 256, 104, 104), rnd(64, 256, 3, 3), rnd(64)
    a, b = grouped(x, weight, bias), dynamic_conv(x, weight, bias)
    print(f"outputs {tuple(a.shape)} / {tuple(b.shape)}, max abs difference "
          f"{(a.float() - b.float()).abs().max().item():.4g} at largest "
          f"|value| {a.float().abs().max().item():.4g}")
    for name, fn in (("grouped", grouped), ("taps", dynamic_conv),
                     ("taps", dynamic_conv), ("grouped", grouped)):
        f, bw = fwd_bwd_ms(fn, (x, weight, bias))
        print(f"dynamic conv {name}: forward {f:.3f} ms, backward {bw:.3f} ms")
    del x, weight, bias, a, b

    head, w5, b5 = rnd(64, 64, 416, 416), rnd(1, 64, 5, 5), rnd(1)
    f, bw = fwd_bwd_ms(lambda *t: conv2d(*t, padding="same", pad_mode="replicate"),
                       (head, w5, b5))
    print(f"additive k5 conv 64 -> 1 at 416^2, replicate pad: forward {f:.3f} ms, "
          f"backward {bw:.3f} ms")


if __name__ == "__main__":
    main()

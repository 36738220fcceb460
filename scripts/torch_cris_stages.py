#!/usr/bin/env python3
"""Where a CRIS forward of the PyTorch port spends its device time, stage by
stage, and whether the RN50 convolutions should run channels-last.

    python3 scripts/torch_cris_stages.py [--batch 64]

Needs one CUDA GPU. Builds the full-width bf16 CRIS RN50 + CoOp(3, 4) model
with seeded random weights, times each stage of one forward at 416^2 with
CUDA events (visual, text, neck, decoder, projector, final upsample, additive
head; median of 5 after a warm-up), then times the whole served forward and
a forward + backward of the CoOp loss with the convolution weights in three
memory formats, in turns (there and back):
  * nchw: every 4-D weight contiguous, so that every tensor is;
  * backbone: as `build_cris` builds the model, the RN50's 4-D weights
    channels-last; the backbone follows its weights and converts the image
    batch on entry, so that cuDNN needs no layout transposes there;
  * all: the head's convolution weights (neck, projector, additive head)
    channels-last too.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from tunevlseg_torch.models.presets import build_cris  # noqa: E402
from tunevlseg_torch.ops.image import resize_2d  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402


def event_ms(fn, reps: int = 5):
    fn()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        result = fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out), result


def wall_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    model, spec = build_cris("coop", prompt_depth=3, num_context=4,
                          dtype=torch.bfloat16, device="cuda", seed=0)
    c = model.config
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 1000, (1, 77), generator=gen, dtype=torch.int32)
    ids[:, 0], ids[:, 9], ids[:, 10:] = 49406, 49407, 0
    batch = {"image": torch.randint(0, 256, (args.batch, 3, 416, 416),
                                    generator=gen, dtype=torch.uint8).cuda(),
             "input_ids": ids.cuda(), "attention_mask": (ids != 0).int().cuda(),
             "text_index": torch.zeros(args.batch, dtype=torch.int32).cuda()}
    task = SegmentationTask(model)
    pixels = task._prep_image(batch["image"])
    pad = torch.cat([torch.zeros(1, 4, dtype=torch.bool, device="cuda"),
                     batch["input_ids"] == 0], dim=1)[:, :77]
    idx = batch["text_index"].long()

    stages = {}
    stages["visual (RN50 + attention pool)"], vis = event_ms(
        lambda: model.visual(pixels))
    stages["text (12 layers, U = 1)"], (tokens, state) = event_ms(
        lambda: model.text(batch["input_ids"], pad_mask=pad,
                           text_ctx=model.learner().text, prompt_depth=3,
                           max_length=77))
    tokens, state, pad_b = tokens[idx], state[idx], pad[idx]
    stages["neck (FPN)"], fq = event_ms(lambda: model.neck(vis, state))
    stages["decoder (3 layers, 676 tokens)"], fq = event_ms(
        lambda: model.decoder(fq, tokens, pad_b))
    stages["projector"], pred = event_ms(lambda: model.proj(fq, state))
    stages["final bicubic upsample"], _ = event_ms(
        lambda: resize_2d(pred, (c.img_size, c.img_size), "bicubic",
                          align_corners=True))
    stages["additive head"], _ = event_ms(
        lambda: model.additive_conv2(resize_2d(
            model.additive_conv1(fq), (c.img_size, c.img_size), "bilinear")))
    for name, ms in stages.items():
        print(f"stage {name}: {ms:.3f} ms")
    print(f"stages sum: {sum(stages.values()):.3f} ms at batch {args.batch}")

    def set_format(fmt: str) -> None:
        model.to(memory_format=torch.channels_last if fmt == "all"
                 else torch.contiguous_format)
        if fmt == "backbone":
            model.visual.to(memory_format=torch.channels_last)

    train_task = SegmentationTask(model, spec)
    train_task.init()
    train_batch = dict(batch, mask=(torch.rand(
        args.batch, 1, 416, 416, generator=gen) > 0.5).float().cuda())

    def loss_and_backward():
        with torch.enable_grad():
            train_task._loss(train_batch)[0].backward()

    order = ("nchw", "backbone", "all", "all", "backbone", "nchw")
    results = {fmt: {"forward": [], "forward + backward": []} for fmt in order}
    probs = {}
    for fmt in order:
        set_format(fmt)
        results[fmt]["forward"].append(wall_ms(lambda: task.predict_step(batch)))
        results[fmt]["forward + backward"].append(wall_ms(loss_and_backward))
        probs[fmt] = task.predict_step(batch)
    for fmt, kinds in results.items():
        for kind, values in kinds.items():
            print(f"{kind} b{args.batch} {fmt}: "
                  + ", ".join(f"{v:.3f}" for v in values) + " ms")
    set_format("backbone")
    a, b = probs["nchw"], probs["backbone"]
    print(f"max abs difference of the probabilities between the formats: "
          f"{(a - b).abs().max().item():.3g}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the training loop's time goes beyond the bare train step, on the
card: the full-width CLIPSeg rd64 + CoOp model (depth 3, 4 contexts, bf16)
at b64, 352², one prompt (`text_dedup=1`), `Trainer.fit` over 8 batches of
an in-memory dataset, with the input pipeline varied, in turns:

  prebuilt      batches collated beforehand (no producer thread)
  loader w4     DataLoader(num_workers=4): collate in the loader's producer
                thread (what chip_smoke.py and the CLI run); device_batch
                pins each batch in the main thread and copies it without
                blocking
  pinning w4    the same, with the pinning moved into the producer thread
  loader w1     one worker thread
  loader p1     prefetch 1
  + memcpy      prebuilt, with a thread copying 55.5 MB arrays with NumPy
                (the interpreter lock released while it copies) throughout
  + python      prebuilt, with a thread running pure-Python arithmetic
                (holding the lock but for the switch interval) throughout

For each: ms a step (host clock over the epoch's train part, the device
drained at both ends), and the producer's collate and pin ms a batch (host
clock in its thread). The last two say which kind of work beside the
host-bound step slows it: memory traffic or the interpreter lock.

    python3 scripts/torch_loop_ab.py [--rounds 2]

Needs one CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCH, IMG, SEQ, STEPS = 64, 352, 77, 8


def samples(n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    ids = np.full((SEQ,), 49407, np.int32)
    ids[0] = 49406
    ids[1:9] = rng.integers(3, 1000, size=(8,))
    return [{"image": rng.integers(0, 256, (3, IMG, IMG), dtype=np.uint8),
             "mask": (rng.random((1, IMG, IMG)) > 0.5).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != 49407).astype(np.int32)}
            for _ in range(n)]


# the loader's own collate, the producer's collate and pin times per batch,
# and whether it pins
PRODUCER = {"collate": None, "collate_s": [], "pin_s": [], "pin": False}


def timed_collate(*args, **kwargs):
    """The loader's `collate`, clocked in its producer thread; with
    PRODUCER["pin"] it also pins the batch there."""
    import torch
    t = time.perf_counter()
    batch = PRODUCER["collate"](*args, **kwargs)
    PRODUCER["collate_s"].append(time.perf_counter() - t)
    if PRODUCER["pin"]:
        t = time.perf_counter()
        for k in ("image", "mask", "input_ids", "attention_mask", "valid",
                  "text_index"):
            if k in batch:
                batch[k] = torch.from_numpy(batch[k]).pin_memory()
        PRODUCER["pin_s"].append(time.perf_counter() - t)
    return batch


def loader(**kw):
    from tunevlseg_torch.data.pipeline import DataLoader
    return DataLoader(samples(STEPS * BATCH, 1), BATCH, shuffle=True, seed=5,
                      text_dedup=1, **kw)


class BatchList:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        pass

    def __iter__(self):
        return iter(self.batches)


def background(kind: str, stop: threading.Event) -> None:
    """Work beside the loop until `stop`: NumPy copies of a b64 batch's
    size, or pure-Python arithmetic."""
    import numpy as np
    if kind == "memcpy":
        # a b64 batch's bytes: uint8 image (3 a pixel) and f32 mask (4)
        src = np.ones(BATCH * IMG * IMG * 7, np.uint8)
        dst = np.empty_like(src)
        while not stop.is_set():
            np.copyto(dst, src)
    else:
        while not stop.is_set():
            sum(i * i for i in range(1000))


def main() -> None:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.loop import Trainer
    from tunevlseg_torch.training.task import SegmentationTask

    from tunevlseg_torch.data import pipeline
    model, spec = build_clipseg("coop", prompt_depth=3, num_context=4,
                                dtype=torch.bfloat16, device="cuda", seed=0)
    task = SegmentationTask(model, spec, learning_rate=2e-4)
    batches = list(loader(num_workers=4))
    variants = {   # name: (loader, pin in the producer, background work)
        "prebuilt": (lambda: BatchList(batches), False, None),
        "loader w4": (lambda: loader(num_workers=4), False, None),
        "pinning w4": (lambda: loader(num_workers=4), True, None),
        "loader w1": (lambda: loader(num_workers=1), False, None),
        "loader p1": (lambda: loader(num_workers=4, prefetch=1), False, None),
        "+ memcpy": (lambda: BatchList(batches), False, "memcpy"),
        "+ python": (lambda: BatchList(batches), False, "python"),
    }
    PRODUCER["collate"] = pipeline.collate
    pipeline.collate = timed_collate      # the producer looks it up per batch
    work = Path(tempfile.mkdtemp(prefix="loop_ab_"))
    # warm-up: kernels, allocator, pinned blocks
    Trainer(task, work / "warm", max_epochs=1, log_image_num=0).fit(
        task.init(), loader(num_workers=4))
    results: dict = {k: [] for k in variants}
    producer: dict = {k: ([], []) for k in variants}
    order = list(variants) + list(reversed(variants))
    for r in range(args.rounds):
        for name in order:
            make, pin, kind = variants[name]
            PRODUCER.update(collate_s=[], pin_s=[], pin=pin)
            tr = Trainer(task, work / f"{name}{r}", max_epochs=1,
                         log_every_n_steps=2, ckpt_every_n_steps=3,
                         log_image_num=0, loggers=("jsonl", "csv"))
            stop = threading.Event()
            worker = threading.Thread(target=background, args=(kind, stop),
                                      daemon=True)
            if kind:
                worker.start()
            try:
                tr.fit(task.init(), make())
            finally:
                stop.set()
                if kind:
                    worker.join(timeout=60)
            _, n, secs = tr.train_times[0]
            results[name].append(secs / n)
            producer[name][0].extend(PRODUCER["collate_s"])
            producer[name][1].extend(PRODUCER["pin_s"])
    PRODUCER["pin"] = False
    for name, vals in results.items():
        collate_s, pin_s = producer[name]
        extra = ""
        if collate_s:
            extra = (f"; producer collate {statistics.median(collate_s) * 1e3:.3f}"
                     f" ms a batch" + (f", pin {statistics.median(pin_s) * 1e3:.3f}"
                                       " ms" if pin_s else ""))
        print(f"loop ab {name}: {statistics.median(vals) * 1e3:.3f} ms a step "
              f"(median of {len(vals)} epochs of {STEPS}; all "
              + ", ".join(f"{v * 1e3:.3f}" for v in vals) + ")" + extra)


if __name__ == "__main__":
    main()

"""Serving benchmark: the exported predict program's latency and throughput,
against the live eager `task_predict_fn` on the same weights and requests:
the port's counterpart of `scripts/servebench.py`.

For each batch size the predict step is exported (`serving.
export_task_predict`, `torch.export`) into a temporary directory, loaded
back with `serving.load_fn` (the program alone: the model's Python code
does not run in it) and timed beside the eager function:

  latency     median wall of one call with `torch.cuda.synchronize()` after
              it (every call waits for its result), median over windows;
  throughput  `--iters` calls in a row and ONE synchronize at the end of the
              window (the pipeline a serving host runs), median over windows.

Before timing, the loaded program's probabilities are held against the eager
call's (bit for bit on the card, where both launch the same kernels; the
largest difference is printed otherwise) and its launches of the port's
kernels against the eager call's. One JSON line per (batch, metric):

  {"metric": "serve_<family>_b{B}_{img}_latency", "value": ms, "unit": "ms",
   "aot_vs_live": latency of the program / latency of the eager call, ...}
  {"metric": "serve_<family>_b{B}_{img}_throughput", "value": images/s, ...}

Usage (on the card; `--tiny --device cpu` rehearses it on the CPU):
  python scripts/torch_servebench.py [--family coop_clipseg] [--batches 1,4,16]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(call, device, warmup: int, iters: int, windows: int) -> tuple:
    """(latency ms, ms per call in a pipelined window), medians over
    `windows` windows of `iters` calls."""
    for _ in range(warmup):
        call()
    sync(device)
    lat = []
    for _ in range(windows):
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            sync(device)
            ts.append(time.perf_counter() - t0)
        lat.append(statistics.median(ts) * 1e3)
    thr = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        sync(device)
        thr.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(lat), statistics.median(thr)


def launches() -> tuple:
    """(K1, K3, K4) launches since the last reset."""
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention as fa
    return fa.launch_count(), fa.bias_launch_count(), cf.launch_count()


def reset_launches() -> None:
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention as fa
    fa.reset_launch_count()
    cf.reset_launch_count()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--family", default="coop_clipseg",
                    choices=("coop_clipseg", "coop_cris", "trans_seg"))
    ap.add_argument("--layout", default="nchw", choices=("nchw", "flat"))
    ap.add_argument("--siglip", action="store_true")
    ap.add_argument("--batches", default="1,4,16")
    ap.add_argument("--img", type=int, default=352)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from scripts.torch_export_model import build, example_batch
    from tunevlseg_torch import serving

    device = torch.device(args.device)
    task, seq, vocab = build(args.family, args.tiny, args.device, args.layout,
                             args.siglip, img=args.img)
    img = args.img
    if args.tiny:
        img, seq = (64 if args.family == "coop_cris" else 32), 12
    params = dict(task.model.state_dict())
    live = serving.task_predict_fn(task)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# torch_servebench device={name} family={args.family} img={img}",
          flush=True)
    rows = []
    for b in [int(x) for x in args.batches.split(",")]:
        batch = example_batch(b, img, seq, vocab, args.device)
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            serving.export_task_predict(task, params, batch, td,
                                        platforms=(device.type,))
            export_s = time.perf_counter() - t0
            aot = serving.load_fn(td, device=device)
            graph_bytes = serving.read_meta(td)["graph_bytes"]
        want = live(params, batch)
        reset_launches()
        got = aot(params, batch)
        sync(device)
        aot_launches = launches()
        reset_launches()
        live(params, batch)
        sync(device)
        if aot_launches != launches():
            raise SystemExit(f"b{b}: the program launched (K1, K3, K4) "
                             f"{aot_launches}, the eager call {launches()}")
        diff = (got - want).abs().max().item()
        lat, thr_ms = measure(lambda: aot(params, batch), device, args.warmup,
                              args.iters, args.windows)
        live_lat, live_thr = measure(lambda: live(params, batch), device,
                                     args.warmup, args.iters, args.windows)
        metric = f"serve_{args.family}_b{b}_{img}"
        rows += [{"metric": f"{metric}_latency", "value": lat, "unit": "ms",
                  "aot_vs_live": lat / live_lat, "live_ms": live_lat,
                  "max_abs_diff_vs_live": diff, "bit_identical": diff == 0.0,
                  "launches_k1_k3_k4": list(aot_launches),
                  "export_s": export_s, "graph_bytes": graph_bytes},
                 {"metric": f"{metric}_throughput", "value": b / (thr_ms * 1e-3),
                  "unit": "imgs/s", "ms_per_call": thr_ms,
                  "aot_vs_live": thr_ms / live_thr,
                  "live_imgs_per_s": b / (live_thr * 1e-3)}]
        for row in rows[-2:]:
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()

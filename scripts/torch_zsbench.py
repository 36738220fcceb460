"""Zero-shot RIS (zsseg) request throughput of the PyTorch port on one GPU.

The counterpart of `scripts/zsbench.py`: the real pipeline (FreeSOLO
proposals, masked-CLIP visual features, crop features when alpha < 1, the
text ensemble, the cosine argmax) at full width with seeded random weights
(the same compute as trained ones) on synthetic images, through
`tunevlseg_torch.eval_zeroshot.build_ris`. Prints one JSON line:

    {"metric": "zsseg_imgs_per_sec_alpha0.95_fused_pipe2", "value": ..., ...}

Modes:
  --alpha 1.0     mask features only
  --alpha 0.95    the reference's default (adds the crop features)
  --fused         `predict_fused`: the whole request on the device, one host
                  read (without it, `__call__`: the host crop loop)
  --pipeline N    with --fused, `predict_fused_many` with N requests in flight
  --n-devices K   the proposal batch over K cards (`eval_zeroshot.build_ris`)

Usage:  python scripts/torch_zsbench.py --images 12 --alpha 0.95 --img 1024 \
            --fused --pipeline 2
The models compute in bf16 over f32 weights on the card (`--dtype f32` for
the JAX package's precision); `--tiny --device cpu` rehearses the script on
the CPU with the test models (a CPU number, not a device measurement).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=12)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--img", type=int, default=800,
                    help="input resolution (the reference resizes the shortest "
                         "side to 800 for FreeSOLO; the zsseg CLI's default is "
                         "1024)")
    ap.add_argument("--n-devices", type=int, default=1,
                    help="the proposal batch over this many devices (the "
                         "masked / crop CLIP towers proposal-parallel, one "
                         "replica a device); on the CPU, the CPU that many "
                         "times")
    ap.add_argument("--fused", action="store_true",
                    help="predict_fused: the whole request on the device")
    ap.add_argument("--pipeline", type=int, default=0, metavar="DEPTH",
                    help="with --fused: DEPTH requests in flight "
                         "(predict_fused_many); 0 = sequential predict_fused")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the test models (a CPU rehearsal)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tunevlseg_torch.eval_zeroshot import build_ris

    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[args.dtype]
    cfg = {"model": {"alpha": args.alpha}, "n_devices": args.n_devices,
           "tiny_model": args.tiny, "seed": 0}
    ris = build_ris(cfg, device=args.device, dtype=dtype)
    on_card = ris.device.type == "cuda"
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip().splitlines()[0]
            if on_card else "cpu")

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(2, 77)).astype(np.int32)
    ids[:, 0] = 49406
    ids[:, 12:] = 49407
    amask = (ids != 49407).astype(np.int32)
    amask[:, 12] = 1
    images = [rng.uniform(0, 255, (3, args.img, args.img)).astype(np.float32)
              for _ in range(3)]
    call = ris.predict_fused if args.fused else ris.__call__

    def sync():
        if on_card:
            for device in ris.devices:
                torch.cuda.synchronize(device)

    def run(n: int) -> None:
        if args.fused and args.pipeline > 0:
            items = ({"image": images[i % len(images)], "input_ids": ids,
                      "attention_mask": amask} for i in range(n))
            for _ in ris.predict_fused_many(items, depth=args.pipeline):
                pass
        else:
            for i in range(n):
                call(images[i % len(images)], ids, amask)
        sync()

    run(len(images))        # warm-up: the allocator, cuDNN, the kernels' build
    t0 = time.perf_counter()
    run(args.images)
    dt = time.perf_counter() - t0
    result = {
        "metric": f"zsseg_imgs_per_sec_alpha{args.alpha}"
                  + ("_fused" if args.fused else "")
                  + (f"_pipe{args.pipeline}" if args.pipeline else ""),
        "value": args.images / dt,
        "unit": "imgs/s",
        "ms_per_image": 1e3 * dt / args.images,
        "images": args.images, "img": args.img, "dtype": args.dtype,
        "n_devices": len(ris.devices), "pipeline_depth": args.pipeline,
        "device": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

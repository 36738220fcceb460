#!/usr/bin/env python3
"""DenseCLIP trainer script of the PyTorch port: the reference's mmseg recipe
as a CLI, over `tunevlseg_torch/training/denseclip_task.py:DenseCLIPTask`.

Counterpart of `scripts/train_denseclip.py` with the same flags: AdamW 1e-4
with the paramwise groups (backbone lr x 0.1, the text encoder frozen), poly
0.9 + a 1500-iteration warm-up, 80k iterations, crop 512 (640 for the ViT),
decode CE + 0.4 identity auxiliary. Runs on the CUDA card by default
(`--device cuda`; without a card it raises, there is no fallback), in bf16
compute over f32 weights there (`--dtype auto`) and f32 elsewhere.

Dataset layout (mmseg-style):
    root/images/{split}/*.jpg|png        RGB images
    root/annotations/{split}/*.png       uint8 class-index labels, 255 = ignore
Class names: a text file, one name per line, tokenized with the CLIP BPE in
the DenseCLIP vocabulary layout (`--vocab`, a merges file); the model's
vocabulary grows to the tokenizer's where that is larger.

    python3 scripts/torch_train_denseclip.py --synthetic --tiny --iters 20 \\
        --batch 8 --device cpu

needs no data and no vocabulary. `--accumulate k` averages k micro-batches'
gradients before each update (`--iters` counts micro-steps, as the JAX
script's loop does; the poly schedule counts updates); `--remat` recomputes
the loss's forward in the backward. `--n-devices k` trains data parallel on
k ranks of this host, one a card (gloo ranks with `--device cpu`), each
`--batch / k` rows of every batch, the model under DistributedDataParallel;
`--fsdp` shards it with `fully_shard` instead (one rank has nothing to
shard: there `--fsdp` runs the plain path); under torchrun the script
joins the launcher's group. Rank 0 logs and writes the checkpoints. The
last line of the output is the JSON object {"final": {metric: value},
"ckpt": directory}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", type=Path, default=None)
    ap.add_argument("--classes", type=Path, default=None,
                    help="text file, one class name per line")
    ap.add_argument("--vocab", type=Path, default=None,
                    help="CLIP BPE merges file (bpe_simple_vocab_16e6.txt.gz)")
    ap.add_argument("--out", type=Path, default=Path("logs/denseclip"))
    ap.add_argument("--iters", type=int, default=80_000)
    ap.add_argument("--warmup-iters", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--backbone", choices=("rn50", "rn101", "vitb16"),
                    default="rn50",
                    help="rn50 = denseclip_fpn_res50_512x512_80k; rn101 = "
                         "denseclip_fpn_res101_512x512_80k (layers (3, 4, 23, 3), "
                         "joint dim 512); vitb16 = denseclip_fpn_vit-b_640x640_80k "
                         "(crop 640, drop_path 0.1)")
    ap.add_argument("--crop", type=int, default=None,
                    help="train crop (default: the recipe's, 512 / 640)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--val-every", type=int, default=4000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the model, AdamW's moments and the text "
                         "encoder over the ranks (fully_shard)")
    ap.add_argument("--n-devices", type=int, default=1,
                    help="data parallel over this many ranks on this host")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--accumulate", type=int, default=1)
    ap.add_argument("--spe", type=int, default=1,
                    help="steps per execution: this many train steps a group "
                         "through compile_train_multistep (one captured CUDA "
                         "graph on the card), their metrics averaged")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out>/checkpoints/last: trainable weights, "
                         "AdamW state and the iteration count; the schedule "
                         "continues from the restored step")
    ap.add_argument("--synthetic", action="store_true",
                    help="random data (smoke test, no files needed)")
    ap.add_argument("--tiny", action="store_true", help="tiny config (smoke test)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("auto", "float32", "bfloat16"),
                    default="auto", help="compute dtype; auto: bf16 on CUDA")
    args = ap.parse_args(argv)
    if args.classes is not None and args.vocab is None:
        ap.error("--classes requires --vocab (CLIP BPE merges file)")
    if not args.synthetic and args.data_root is None:
        ap.error("--data-root is required unless --synthetic")
    return args


def _list_pairs(root: Path, split: str):
    imgs = sorted((root / "images" / split).glob("*"))
    anns = {p.stem: p for p in (root / "annotations" / split).glob("*.png")}
    pairs = [(p, anns[p.stem]) for p in imgs if p.stem in anns]
    if not pairs:
        raise FileNotFoundError(f"no image/annotation pairs under {root} ({split})")
    return pairs


def _load_crop(pair, crop: int, rng, train: bool):
    """mmseg's crop and flip: pad with ignore (255) to the crop, a random crop
    and a horizontal flip at p 0.5 in training, the centre crop otherwise.
    Returns (3, crop, crop) uint8 and (crop, crop) int32."""
    from tunevlseg_torch.data.opencv import cv2
    cv = cv2()
    img = cv.cvtColor(cv.imread(str(pair[0])), cv.COLOR_BGR2RGB)
    lab = cv.imread(str(pair[1]), cv.IMREAD_GRAYSCALE)
    h, w = lab.shape
    if min(h, w) < crop:
        ph, pw = max(0, crop - h), max(0, crop - w)
        img = cv.copyMakeBorder(img, 0, ph, 0, pw, cv.BORDER_CONSTANT, 0)
        lab = cv.copyMakeBorder(lab, 0, ph, 0, pw, cv.BORDER_CONSTANT, value=255)
        h, w = lab.shape
    if train:
        y = int(rng.integers(0, h - crop + 1))
        x = int(rng.integers(0, w - crop + 1))
        if rng.random() < 0.5:
            img, lab = img[:, ::-1], lab[:, ::-1]
    else:
        y, x = (h - crop) // 2, (w - crop) // 2
    img = img[y:y + crop, x:x + crop]
    lab = lab[y:y + crop, x:x + crop]
    return img.transpose(2, 0, 1).copy(), lab.astype(np.int32).copy()


def _batch(pairs, idxs, crop, rng, train):
    imgs, labs = zip(*[_load_crop(pairs[i], crop, rng, train) for i in idxs])
    return {"image": np.stack(imgs).astype(np.uint8), "label": np.stack(labs)}


def config_for(args):
    from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig
    if args.tiny:
        if args.backbone == "vitb16":
            return DenseCLIPConfig.tiny_vit(head_dropout=0.0)
        # tiny rn101 keeps the deep stage 3 and a joint dim of its own
        return DenseCLIPConfig.tiny(
            head_dropout=0.0, **({"vision_layers": (1, 1, 2, 1), "embed_dim": 16}
                                 if args.backbone == "rn101" else {}))
    if args.backbone == "vitb16":
        return DenseCLIPConfig.vitb16()
    if args.backbone == "rn101":
        return DenseCLIPConfig.rn101()
    return DenseCLIPConfig()


def main(argv=None):
    args = parse_args(argv)
    import torch

    from tunevlseg_torch import train as train_cli
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on the card; pass "
                           "--device cpu to run on the CPU")
    if args.batch % args.n_devices:
        raise ValueError(f"--batch {args.batch} must divide by the "
                         f"{args.n_devices} ranks")
    # the train CLI's launch: k ranks started here, or torchrun's group
    cfg = {"trainer": {"device": args.device, "fsdp": args.fsdp,
                       "n_devices": args.n_devices}, "args": args}
    if args.n_devices > 1:
        if device.type == "cuda" and args.n_devices > torch.cuda.device_count():
            raise ValueError(f"--n-devices {args.n_devices}, but "
                             f"{torch.cuda.device_count()} card(s) are visible")
        return train_cli.start_ranks(_train_rank, cfg, args.n_devices)
    device, undo = train_cli.join_group(cfg, device)
    try:
        return _train(args, device)
    finally:
        for fn in undo:
            fn()


def _train_rank(cfg: dict) -> dict:
    from tunevlseg_torch.parallel import distributed
    return _train(cfg["args"], distributed.rank_device(cfg["trainer"]["device"]))


def _train(args, device):
    import torch

    from tunevlseg_torch.models.presets import build_denseclip
    from tunevlseg_torch.parallel import distributed
    from tunevlseg_torch.training.checkpoint import CheckpointManager
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
    from tunevlseg_torch.utils.logging import get_logger

    log = get_logger("train_denseclip")
    world, rank = distributed.world_size(), distributed.rank()
    lead = rank == 0
    dtype = {"auto": torch.bfloat16 if device.type == "cuda" else torch.float32,
             "float32": torch.float32, "bfloat16": torch.bfloat16}[args.dtype]
    rng = np.random.default_rng(args.seed)
    cfg = config_for(args)

    # class token ids: the class names in the 5-token budget, or synthetic
    # ids with the EOS (the largest id) in the last slot
    if args.classes is not None:
        from tunevlseg_torch.data.tokenizer import CLIPTokenizer
        names = [ln.strip() for ln in args.classes.read_text().splitlines()
                 if ln.strip()]
        tok = CLIPTokenizer(str(args.vocab), vocab_layout="denseclip")
        class_ids = tok(names, max_length=cfg.text_context_length,
                        style="openai")["input_ids"]
        cfg = dataclasses.replace(cfg, num_classes=len(names),
                                  vocab_size=max(cfg.vocab_size, tok.vocab_size))
    else:
        class_ids = rng.integers(1, cfg.vocab_size - 1,
                                 (cfg.num_classes, cfg.text_context_length)
                                 ).astype(np.int32)
        class_ids[:, -1] = cfg.vocab_size - 1

    model = build_denseclip(cfg, class_ids, bn_train=True, dtype=dtype,
                            device=device, seed=args.seed)
    task = DenseCLIPTask(
        model, learning_rate=args.lr, weight_decay=args.weight_decay,
        total_iters=args.iters, warmup_iters=args.warmup_iters,
        accumulate_grad_batches=args.accumulate, remat=args.remat,
        image_stats=IMAGENET_STATS, seed=args.seed)

    crop = (64 if args.tiny else args.crop if args.crop is not None
            else cfg.input_resolution)
    batch = args.batch // world
    if args.synthetic:
        n = max(args.batch, 8)
        yy = np.mgrid[:crop, :crop][0]
        synth = {"image": rng.integers(0, 255, (n, 3, crop, crop), dtype=np.uint8),
                 "label": ((yy // 16) % cfg.num_classes)[None].repeat(n, 0)
                 .astype(np.int32)}
    else:
        train_pairs = _list_pairs(args.data_root, "training")
        val_pairs = _list_pairs(args.data_root, "validation")

    # each rank draws its own rows (one rank: the generator above, as before)
    draw = rng if world == 1 else np.random.default_rng((args.seed, rank))

    def next_batch(train=True):
        if args.synthetic:
            idx = draw.integers(0, synth["image"].shape[0], batch)
            host = {k: v[idx] for k, v in synth.items()}
        else:
            pairs = train_pairs if train else val_pairs
            idx = draw.integers(0, len(pairs), batch)
            host = _batch(pairs, idx, crop, draw, train)
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}

    state = task.init()
    fsdp = args.fsdp and world > 1
    if args.fsdp and not fsdp:
        log.info("--fsdp over one rank: nothing to shard, the plain path runs")
    if distributed.is_initialized():
        if fsdp:
            state = task.state_fsdp_shardings(state)
        task.compile_steps(fsdp=fsdp)
    train_multi = (task.compile_train_multistep(args.spe) if args.spe > 1
                   else None)
    args.out.mkdir(parents=True, exist_ok=True)
    ckpt = CheckpointManager(args.out / "checkpoints", model, monitor="val_acc")
    ckpt.save_frozen()
    metrics_path = args.out / "metrics.jsonl"
    it = 0
    if args.resume:
        if not (ckpt.dir / "last").exists():
            raise FileNotFoundError(f"--resume: no {ckpt.dir / 'last'}")
        ckpt.restore_frozen()
        state = ckpt.restore("last", state)
        ckpt.best_value = ckpt.load_meta("last").get("best_value")
        it = state.step
        log.info("resumed at iter %d (best %s)", it, ckpt.best_value)
    last_t, last_it, last_val = time.perf_counter(), it, it
    m = {}
    while it < args.iters:
        if train_multi is not None:
            group = [next_batch() for _ in range(args.spe)]
            state, m = train_multi(state, {k: torch.stack([b[k] for b in group])
                                           for k in group[0]})
            it += args.spe
        else:
            state, m = task.train_step(state, next_batch())
            it += 1
        if it <= args.spe:
            # leave the first group's warm-up out of the throughput window
            float(m["loss"])
            last_t, last_it = time.perf_counter(), it
        if it - last_it >= args.log_every or it >= args.iters:
            m = {k: float(v) for k, v in m.items()}
            m["iter"] = it
            window = it - last_it
            m["imgs_per_sec"] = (round(window * args.batch
                                       / (time.perf_counter() - last_t), 2)
                                 if window else None)
            last_t, last_it = time.perf_counter(), it
            if lead:
                log.info("iter %d: %s", it, json.dumps(m))
                with metrics_path.open("a") as f:
                    f.write(json.dumps(m) + "\n")
        if it - last_val >= args.val_every or it >= args.iters:
            last_val = it
            ev = {f"val_{k}": float(v)
                  for k, v in task.eval_step(state, next_batch(False)).items()}
            if lead:
                log.info("iter %d: %s", it, json.dumps(ev))
            ckpt.maybe_save_best(state, ev, epoch=it)
    ckpt.save("last", state, {"iter": args.iters})
    ckpt.wait()
    final = {k: float(v) for k, v in m.items()
             if k != "iter" and v is not None}
    if lead:
        print(json.dumps({"final": final, "ckpt": str(ckpt.dir)}))
    return final


if __name__ == "__main__":
    main()

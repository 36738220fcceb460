#!/usr/bin/env python3
"""Zero-shot RIS exploration of the PyTorch port: the reference notebooks
`freesolo_limit.ipynb` and `zero-shot-topk.ipynb` as a script.

Counterpart of `scripts/analyze_zeroshot.py` with the same modes, flags and
outputs, over a `ZeroShotDataset` and a `ZeroShotRIS` composed exactly as
`tunevlseg_torch.eval_zeroshot` composes them (the same config overrides
apply; the models in the dtype and on the device that entry point uses):

  limit  — the FreeSOLO ORACLE upper bound: for every image, the max
           dice/IoU over ALL class-agnostic proposals.  This bounds what
           any CLIP-based proposal selection can achieve (the notebook's
           headline numbers were the mean of these per-image maxima).
  topk   — best-of-top-k selection quality: rank proposals by CLIP
           similarity (the host path, `ZeroShotRIS.__call__`) and score the
           BEST of the k highest-ranked masks for each k.

The models run on the CUDA card; without one it raises, unless the
overrides ask for the CPU (`+trainer.device=cpu`). They compute in f32, as
eval_zeroshot's do (the JAX package's precision); `--dtype bf16` computes
in bf16 over the f32 weights, as `scripts/torch_zsbench.py` does on the
card, and only then do the attention and the flat convolution run their
kernels (K3 for the text tower; K4 with `+model.layout=flat`, which runs
FreeSOLO's ResNet through the flat convolution). Writes
`<mode>_metrics.json` (also printed as a JSON line), `<mode>_per_image.npz`
and, with --plots (matplotlib, where it imports), the notebooks' panels.

    python3 scripts/torch_analyze_zeroshot.py limit [eval_zeroshot overrides...]
    python3 scripts/torch_analyze_zeroshot.py topk [overrides...] --topk 1 5 10

(the overrides right after the mode: Python 3.12.3's argparse takes none
after an option, `--` included; 3.12.12's does).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def dice_iou(pred: np.ndarray, gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(P, H, W) binary preds vs (H, W) gt -> per-proposal dice/IoU."""
    gt = gt.astype(bool)
    pred = pred.astype(bool)
    inter = (pred & gt).sum((-2, -1)).astype(np.float64)
    psum = pred.sum((-2, -1))
    gsum = gt.sum()
    dice = 2 * inter / np.maximum(psum + gsum, 1)
    iou = inter / np.maximum(psum + gsum - inter, 1)
    return dice, iou


def analyze(ris, dataset, mode: str, topk=(1, 5, 10),
            limit_images=None) -> dict:
    """The per-image loop over `dataset` with `ris` (any object with the
    `ZeroShotRIS` interface): {"result": the metrics, "max_dices",
    "max_ious": per image, "best", "worst": (dice, (image, gt, shown mask,
    iou)) for the plots}. In "topk" mode `ris.num_masks` becomes
    max(topk)."""
    if mode == "topk":
        ris.num_masks = max(topk)
    n = len(dataset)
    if limit_images is not None:
        n = min(n, limit_images)

    max_dices, max_ious = [], []
    per_k = {k: ([], []) for k in topk}
    worst = (2.0, None)
    best = (-1.0, None)
    for i in range(n):
        item = dataset[i]
        gt = np.asarray(item["mask"]).squeeze()
        if mode == "limit":
            masks, _, valid = ris.get_freesolo_predictions(
                item["image"], cache_name=item.get("cache_name"))
            masks = masks[valid.astype(bool)]
            if not len(masks):
                max_dices.append(0.0)
                max_ious.append(0.0)
                # a zero-proposal image IS the worst case (dice 0): keep it
                # eligible for the worst-example triptych with an empty mask
                if 0.0 < worst[0]:
                    worst = (0.0, (item["image"], gt,
                                   np.zeros_like(gt, dtype=np.float32), 0.0))
                continue
            dice, iou = dice_iou(masks > 0.5, gt > 0.5)
        else:
            pred = ris(item["image"], item["input_ids"],
                       item["attention_mask"],
                       cache_name=item.get("cache_name"))
            dice, iou = dice_iou(pred[:, 0] > 0.5, gt > 0.5)
            for k in topk:
                dk, ik = per_k[k]
                dk.append(float(dice[:k].max()) if len(dice) else 0.0)
                ik.append(float(iou[:k].max()) if len(iou) else 0.0)
        md, mi = float(dice.max()), float(iou.max())
        max_dices.append(md)
        max_ious.append(mi)
        amax = int(dice.argmax())
        shown = masks[amax] if mode == "limit" else pred[amax, 0]
        if md < worst[0]:
            worst = (md, (item["image"], gt, shown, mi))
        if md > best[0]:
            best = (md, (item["image"], gt, shown, mi))
        if i % 25 == 24:
            print(f"{i + 1}/{n}: running max-dice "
                  f"{np.mean(max_dices):.4f}", file=sys.stderr)

    result = {"mode": mode, "images": n,
              "oracle_mean_max_dice": float(np.mean(max_dices)),
              "oracle_mean_max_iou": float(np.mean(max_ious))}
    if mode == "topk":
        for k in topk:
            dk, ik = per_k[k]
            result[f"top{k}_dice"] = float(np.mean(dk))
            result[f"top{k}_iou"] = float(np.mean(ik))
    return {"result": result, "max_dices": max_dices, "max_ious": max_ious,
            "best": best, "worst": worst}


def plot(out_dir: Path, mode: str, run: dict) -> None:
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, sharex=True, sharey=True,
                                   figsize=(14, 7))
    ax1.hist(run["max_dices"], bins="auto")
    ax1.set_title("Max Dices")
    ax2.hist(run["max_ious"], bins="auto")
    ax2.set_title("Max IoU")
    fig.savefig(out_dir / f"{mode}_hist.png", dpi=120)
    plt.close(fig)

    def rescale(img):
        mn = img.min((0, 1))
        return (img - mn) / (img.max((0, 1)) - mn + 1e-8)

    for tag in ("best", "worst"):
        score, payload = run[tag]
        if payload is None:
            continue
        image, gt, pm, iou = payload
        fig, (a1, a2, a3) = plt.subplots(1, 3, figsize=(20, 7))
        a1.imshow(rescale(np.moveaxis(np.asarray(image), 0, -1)))
        a1.set_title("Original Image")
        a2.imshow(gt)
        a2.set_title("Original Mask")
        a3.imshow(pm)
        a3.set_title(f"Best Prediction: Dice={score:4f}, iou={iou:4f}")
        fig.savefig(out_dir / f"{mode}_{tag}.png", dpi=120)
        plt.close(fig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("limit", "topk"))
    ap.add_argument("--topk", type=int, nargs="+", default=(1, 5, 10))
    ap.add_argument("--limit-images", type=int, default=None)
    ap.add_argument("--plots", action="store_true",
                    help="save histogram/triptych PNGs next to the metrics")
    ap.add_argument("--out-dir", type=Path, default=Path("zeroshot_analysis"))
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("overrides", nargs="*", default=())
    args = ap.parse_args(argv)

    import torch

    from tunevlseg_torch import eval_zeroshot
    from tunevlseg_torch.config.composer import compose
    from tunevlseg_torch.train import CONFIG_DIR, resolve_device

    cfg = compose(CONFIG_DIR, "eval_zeroshot", list(args.overrides))
    device = resolve_device(cfg)
    dataset = eval_zeroshot.zero_shot_dataset(cfg)
    ris = eval_zeroshot.build_ris(
        cfg, device=device,
        dtype={"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype])
    run = analyze(ris, dataset, args.mode, tuple(args.topk), args.limit_images)
    result = run["result"]
    print(json.dumps(result))

    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / f"{args.mode}_metrics.json").write_text(
        json.dumps(result, indent=2))
    np.savez(args.out_dir / f"{args.mode}_per_image.npz",
             max_dices=np.array(run["max_dices"]),
             max_ious=np.array(run["max_ious"]))
    if args.plots:
        plot(args.out_dir, args.mode, run)
    return result


if __name__ == "__main__":
    main()

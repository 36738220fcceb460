#!/usr/bin/env python3
"""PhraseCut dataset exploration of the PyTorch port: the reference notebooks
`Phrasecut Analysis.ipynb` / `Phrasecut Plotting.ipynb` as a script, over the
port's `PhraseCutDataset` (`tunevlseg_torch/data/open_domain.py`).

Counterpart of `scripts/analyze_phrasecut.py` with the same flags and the
same `stats.json`:
  * task/image/phrase counts, images-per-phrase distribution (log-hist),
  * image shape statistics and the SmallestMaxSize(target) scaled sizes
    (the crop-headroom analysis that motivated the 224/352 training crops),
  * with --plots (matplotlib, where it imports) the histogram and the shape
    scatter.

It reads the task file and decodes every scanned image on the host (cv2,
on one thread): no model runs, so there is no device to choose.

    python3 scripts/torch_analyze_phrasecut.py --task-json refer_train.json \
        --image-dir images/ --mask-dir masks/ [--target-size 224] [--plots]
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task-json", type=Path, required=True)
    ap.add_argument("--image-dir", type=Path, required=True)
    ap.add_argument("--mask-dir", type=Path, default=None)
    ap.add_argument("--target-size", type=int, default=224)
    ap.add_argument("--max-images", type=int, default=None,
                    help="subsample the shape scan (it reads every image)")
    ap.add_argument("--plots", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=Path("phrasecut_analysis"))
    args = ap.parse_args(argv)

    from tunevlseg_torch.data.open_domain import PhraseCutDataset
    from tunevlseg_torch.data import opencv
    cv2 = opencv.cv2()

    # the analysis only touches task metadata (never __getitem__), so a
    # no-op tokenizer satisfies the dataset contract
    noop_tok = lambda *a, **k: {"input_ids": np.zeros((1, 1), np.int32)}
    ds = PhraseCutDataset(
        image_dir=args.image_dir, mask_dir=args.mask_dir or args.image_dir,
        task_path=args.task_json, tokenizer=noop_tok, max_length=77)

    phrases = Counter(str(t["phrase"]) for t in ds.tasks)
    image_ids = sorted({ds.image_id(t) for t in ds.tasks})
    per_phrase = np.array(sorted(phrases.values()))

    # shape scan: scaled sizes under SmallestMaxSize(target) — how much
    # headroom RandomCrop(target) has on each side (notebook "Shape
    # Analysis" section)
    scan_ids = image_ids[:args.max_images] if args.max_images else image_ids
    shapes, scaled = [], []
    for image_id in scan_ids:
        img = cv2.imread(str(args.image_dir / f"{image_id}.jpg"),
                         cv2.IMREAD_COLOR)
        if img is None:
            continue
        h, w = img.shape[:2]
        shapes.append((h, w))
        scale = args.target_size / min(h, w)
        scaled.append((round(h * scale), round(w * scale)))
    shapes_np = np.array(shapes) if shapes else np.zeros((0, 2), int)
    scaled_np = np.array(scaled) if scaled else np.zeros((0, 2), int)
    diff = scaled_np - args.target_size

    result = {
        "tasks": len(ds.tasks),
        "unique_images": len(image_ids),
        "unique_phrases": len(phrases),
        "images_per_phrase": {
            "mean": float(per_phrase.mean()) if len(per_phrase) else 0.0,
            "median": float(np.median(per_phrase)) if len(per_phrase) else 0.0,
            "max": int(per_phrase.max()) if len(per_phrase) else 0,
            "singletons": int((per_phrase == 1).sum()),
        },
        "top_phrases": phrases.most_common(20),
        "image_shapes": {
            "scanned": len(shapes),
            "min": shapes_np.min(0).tolist() if len(shapes_np) else None,
            "max": shapes_np.max(0).tolist() if len(shapes_np) else None,
            "mean": shapes_np.mean(0).tolist() if len(shapes_np) else None,
        },
        "crop_headroom_after_smallest_max_size": {
            "target": args.target_size,
            "mean_extra_hw": diff.mean(0).tolist() if len(diff) else None,
            "max_extra_hw": diff.max(0).tolist() if len(diff) else None,
        },
    }
    print(json.dumps(result))
    args.out_dir.mkdir(parents=True, exist_ok=True)
    (args.out_dir / "stats.json").write_text(json.dumps(result, indent=2))

    if args.plots and len(per_phrase):
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, ax = plt.subplots()
        ax.hist(per_phrase, bins=20, log=True)
        ax.set_xlabel("images per phrase")
        ax.set_ylabel("count (log)")
        fig.savefig(args.out_dir / "images_per_phrase.png", dpi=120)
        plt.close(fig)

        if len(shapes_np):
            fig, ax = plt.subplots()
            ax.scatter(shapes_np[:, 1], shapes_np[:, 0], s=4, alpha=0.4)
            ax.set_xlabel("width")
            ax.set_ylabel("height")
            fig.savefig(args.out_dir / "image_shapes.png", dpi=120)
            plt.close(fig)
    return result


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Learned-prompt embedding analysis of the PyTorch port: the reference's
notebooks (TuneVLSeg_t_SNE*.ipynb, TuneVLSeg_UMAP*.ipynb) as a script, over
the port's checkpoints.

Counterpart of `scripts/analyze_prompts.py`, which reads the JAX Trainer's
orbax checkpoints; this one reads the port's (`training/checkpoint.py`):
`<run>/checkpoints/{best|last}/state.pt` (its "trainable" dict, flat
`state_dict` names) and `<run>/checkpoints/frozen/frozen.pt`. For each run
it takes every learned context tensor (a trainable name with "context" in
it, 2-D or 3-D: CoOp's `learner.context_vectors` and its kin), decodes each
context vector to its nearest vocabulary ids by euclidean distance against
the token embedding of the frozen file (`...token_embedding.weight`; the
CoOp-paper "prompt interpretation" table), and projects the pooled vectors
to 2-D (PCA always; t-SNE when sklearn imports). It writes `contexts.json`
(the JAX script's fields; a tensor's name is its path with "/" between the
parts, as the JAX script writes it), `pca.csv`, `tsne.csv` and, where
matplotlib imports, the scatter PNGs.

The distances run on the CUDA card (`--device cuda`, the default; without a
card it raises): one f64 product of the contexts with the embedding table
and a stable sort a row; `--device cpu` runs them on the CPU. PCA, t-SNE and
the plots run on the host.

    python3 scripts/torch_analyze_prompts.py RUN_DIR [RUN_DIR ...] --out analysis/
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def find_context_tensors(trainable: dict) -> dict[str, np.ndarray]:
    """The flat trainable dict's learned prompt contexts: names containing
    'context' whose tensor is (depth, n, dim) or (n, dim), as f32 numpy
    arrays under the name's "/"-joined path."""
    out = {}
    for name, tensor in trainable.items():
        arr = tensor.detach().cpu().float().numpy()
        if "context" in name.lower() and arr.ndim in (2, 3):
            out[name.replace(".", "/")] = arr
    return out


def pca_2d(x: np.ndarray) -> np.ndarray:
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def tsne_2d(x: np.ndarray):
    try:
        from sklearn.manifold import TSNE
    except Exception:
        return None
    perplexity = max(2, min(30, (len(x) - 1) // 3))
    if len(x) <= 3:
        return None
    return TSNE(n_components=2, perplexity=perplexity,
                init="pca", random_state=0).fit_transform(x)


def nearest_tokens(vectors: np.ndarray, embedding, k: int = 3,
                   device="cpu") -> list[list[int]]:
    """Nearest vocabulary ids by euclidean distance (the notebooks' prompt
    interpretation step): ||e||^2 - 2 v.e (||v||^2 is the row's constant),
    in f64 on `device`, ties to the lower id."""
    import torch

    e = torch.as_tensor(embedding).to(device=device, dtype=torch.float64)
    v = torch.as_tensor(vectors).to(device=device, dtype=torch.float64)
    d = -2.0 * v @ e.T + (e * e).sum(1)[None, :]
    return torch.sort(d, dim=1, stable=True).indices[:, :k].cpu().tolist()


def load_run(run_dir: Path):
    """(the state.pt payload of best, else last; frozen.pt's dict or None)."""
    import torch

    ckpt_dir = run_dir / "checkpoints"
    if not ckpt_dir.exists():
        ckpt_dir = run_dir  # allow pointing straight at checkpoints/
    name = "best" if (ckpt_dir / "best").exists() else "last"
    state = torch.load(ckpt_dir / name / "state.pt", map_location="cpu",
                       weights_only=True)
    frozen_path = ckpt_dir / "frozen" / "frozen.pt"
    frozen = (torch.load(frozen_path, map_location="cpu", weights_only=True)
              if frozen_path.exists() else None)
    return state, frozen


def find_token_embedding(frozen):
    """The frozen file's token embedding table (a 2-D tensor under a name
    ending in `token_embedding.weight`), or None."""
    for name, tensor in (frozen or {}).items():
        if name.endswith("token_embedding.weight") and tensor.dim() == 2:
            return tensor
    return None


def analyze(run_dirs: list[Path], out_dir: Path, decode_tokens: bool = True,
            device="cuda"):
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script decodes on the card; "
                           "pass --device cpu to run on the CPU")
    out_dir.mkdir(parents=True, exist_ok=True)
    groups: dict[str, np.ndarray] = {}
    reports = []
    for run in run_dirs:
        state, frozen = load_run(run)
        ctxs = find_context_tensors(state.get("trainable", state))
        emb = find_token_embedding(frozen) if decode_tokens else None
        for path, arr in ctxs.items():
            flat = arr.reshape(-1, arr.shape[-1])
            label = f"{run.name}:{path}"
            groups[label] = flat
            rec = {"run": str(run), "tensor": path,
                   "shape": list(arr.shape),
                   "norm_mean": float(np.linalg.norm(flat, axis=1).mean())}
            if emb is not None and emb.shape[1] == flat.shape[1]:
                rec["nearest_token_ids"] = nearest_tokens(flat, emb,
                                                          device=device)
            reports.append(rec)

    (out_dir / "contexts.json").write_text(json.dumps(reports, indent=2))

    if groups:
        all_vecs = np.concatenate(list(groups.values()), axis=0)
        labels = np.concatenate([
            np.full(len(v), i) for i, v in enumerate(groups.values())])
        proj = {"pca": pca_2d(all_vecs)}
        ts = tsne_2d(all_vecs)
        if ts is not None:
            proj["tsne"] = ts
        for method, xy in proj.items():
            np.savetxt(out_dir / f"{method}.csv",
                       np.column_stack([xy, labels]), delimiter=",",
                       header="x,y,group", comments="")
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                fig, ax = plt.subplots(figsize=(6, 5))
                for i, name in enumerate(groups):
                    m = labels == i
                    ax.scatter(xy[m, 0], xy[m, 1], s=12, label=name[:40])
                ax.legend(fontsize=6)
                ax.set_title(f"learned prompt contexts ({method})")
                fig.savefig(out_dir / f"{method}.png", dpi=120,
                            bbox_inches="tight")
                plt.close(fig)
            except Exception:
                pass
    return reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("runs", nargs="+", type=Path)
    ap.add_argument("--out", type=Path, default=Path("analysis"))
    ap.add_argument("--no-decode", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reports = analyze(args.runs, args.out, decode_tokens=not args.no_decode,
                      device=args.device)
    print(f"analyzed {len(reports)} context tensors -> {args.out}")
    return reports


if __name__ == "__main__":
    main()

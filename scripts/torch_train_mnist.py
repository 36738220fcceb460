#!/usr/bin/env python3
"""MNIST smoke-training CLI of the PyTorch port: the template recipe the
reference ships configs for but no code (configs/model/mnist.yaml), over
`tunevlseg_torch/models/simple_dense_net.py`.

Counterpart of `scripts/train_mnist.py` with the same flags and
hyperparameters: SimpleDenseNet 64/128/64, Adam lr 1e-3 (b1 0.9, b2 0.999,
eps 1e-8, no weight decay), ReduceLROnPlateau(factor 0.1, patience 10) on
the validation loss, batch 128, 55k/5k/10k split, the batch order of each
epoch from `np.random.default_rng(seed).permutation`. As in the JAX script,
the plateau's scale multiplies the gradients before Adam, which all but
cancels it (Adam divides by the gradients' own magnitude): the port keeps
that. Runs on the CUDA card (`--device cuda`, the default; without a card it
raises, there is no fallback); `--device cpu` runs on the CPU.

    python3 scripts/torch_train_mnist.py --data-dir <dir with MNIST idx files>
    python3 scripts/torch_train_mnist.py --synthetic --epochs 3   # no data

`--data-dir` expects the standard IDX files (train-images-idx3-ubyte,
train-labels-idx1-ubyte, t10k-*), optionally .gz. One train step is the
cross-entropy, its backward (BatchNorm statistics updated in train mode) and
Adam; `main` returns {"val_loss", "val_acc", "test_loss", "test_acc",
"epoch_seconds"} (seconds of each epoch's train part, host clock, the device
drained at both ends).
"""
from __future__ import annotations

import argparse
import gzip
import struct
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def read_idx(path: Path) -> np.ndarray:
    """Parse an IDX-format array (the MNIST distribution format)."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as fp:
        zero, dtype_code, ndim = struct.unpack(">HBB", fp.read(4))
        assert zero == 0, f"bad IDX magic in {path}"
        dims = struct.unpack(">" + "I" * ndim, fp.read(4 * ndim))
        dt = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16, 0x0C: np.int32,
              0x0D: np.float32, 0x0E: np.float64}[dtype_code]
        return np.frombuffer(fp.read(), dtype=np.dtype(dt).newbyteorder(">")
                             ).reshape(dims)


def load_mnist(data_dir: Path):
    def find(stem):
        for name in (stem, stem + ".gz"):
            p = data_dir / name
            if p.exists():
                return read_idx(p)
        raise FileNotFoundError(f"{stem}[.gz] not in {data_dir}")

    xtr = find("train-images-idx3-ubyte").astype(np.float32) / 255.0
    ytr = find("train-labels-idx1-ubyte").astype(np.int32)
    xte = find("t10k-images-idx3-ubyte").astype(np.float32) / 255.0
    yte = find("t10k-labels-idx1-ubyte").astype(np.int32)
    # reference normalization (torchvision MNIST transform mean/std)
    xtr = (xtr - 0.1307) / 0.3081
    xte = (xte - 0.1307) / 0.3081
    return (xtr, ytr), (xte, yte)


def synthetic_mnist(n=2048, seed=0):
    """Class-separable fake digits: class k lights a distinct 7x7 block
    pattern + noise, so a working net overfits quickly."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n).astype(np.int32)
    x = rng.normal(0, 0.3, (n, 28, 28)).astype(np.float32)
    for k in range(10):
        r, c = divmod(k, 4)
        x[y == k, r * 7:(r + 1) * 7, c * 7:(c + 1) * 7] += 1.5
    return x, y


def train_step(net, optimizer, scale: float, xb, yb):
    """One step in train mode: the cross-entropy's gradients times `scale`
    (the plateau's, as the JAX script feeds them to optax.adam), then Adam.
    Returns the loss (a device scalar)."""
    import torch.nn.functional as F

    net.train()
    optimizer.zero_grad(set_to_none=True)
    loss = F.cross_entropy(net(xb), yb.long())
    loss.backward()
    if scale != 1.0:
        for p in net.parameters():
            p.grad.mul_(scale)
    optimizer.step()
    return loss.detach()


def eval_step(net, xb, yb):
    """(mean cross-entropy, accuracy) in eval mode, as device scalars."""
    import torch
    import torch.nn.functional as F

    net.eval()
    with torch.no_grad():
        logits = net(xb)
        ce = F.cross_entropy(logits, yb.long())
        acc = (logits.argmax(-1) == yb).float().mean()
    return ce, acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-dir", type=Path, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sizes", type=int, nargs=3, default=(64, 128, 64))
    ap.add_argument("--val-size", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from tunevlseg_torch.models.simple_dense_net import SimpleDenseNet
    from tunevlseg_torch.nn.layers import init_params
    from tunevlseg_torch.training.optim import ReduceLROnPlateau

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs on the card; pass "
                           "--device cpu to run on the CPU")

    if args.synthetic or args.data_dir is None:
        x, y = synthetic_mnist()
        xte, yte = synthetic_mnist(512, seed=1)
        val = min(args.val_size, 256)
    else:
        (x, y), (xte, yte) = load_mnist(args.data_dir)
        val = args.val_size
    xtr, ytr = x[:-val], y[:-val]

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # the whole split lives on the device; a batch is a gather from it
    xtr_d, ytr_d = on_device(xtr), on_device(ytr)
    xva_d, yva_d = on_device(x[-val:]), on_device(y[-val:])
    xte_d, yte_d = on_device(xte), on_device(yte)

    net = SimpleDenseNet(lin1_size=args.sizes[0], lin2_size=args.sizes[1],
                         lin3_size=args.sizes[2])
    init_params(net, torch.Generator().manual_seed(args.seed))
    net.to(device)
    optimizer = torch.optim.Adam(net.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    plateau = ReduceLROnPlateau(factor=0.1, patience=10, mode="min")
    lr_scale = 1.0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(args.seed)
    result = {}
    epoch_seconds = []
    for epoch in range(args.epochs):
        order = rng.permutation(len(xtr))
        sync()
        t0 = time.perf_counter()
        for lo in range(0, len(xtr) - args.batch + 1, args.batch):
            idx = on_device(order[lo:lo + args.batch])
            loss = train_step(net, optimizer, lr_scale, xtr_d[idx], ytr_d[idx])
        sync()
        epoch_seconds.append(time.perf_counter() - t0)
        vl, va = eval_step(net, xva_d, yva_d)
        lr_scale = plateau.step(float(vl), lr_scale)
        print(f"epoch {epoch}: train_loss {float(loss):.4f} "
              f"val_loss {float(vl):.4f} val_acc {float(va):.4f} "
              f"lr_scale {lr_scale:g} ({epoch_seconds[-1]:.3f} s)", flush=True)
        result = {"val_loss": float(vl), "val_acc": float(va)}
    tl, ta = eval_step(net, xte_d, yte_d)
    result.update(test_loss=float(tl), test_acc=float(ta),
                  epoch_seconds=epoch_seconds)
    print(f"test_loss {result['test_loss']:.4f} "
          f"test_acc {result['test_acc']:.4f}", flush=True)
    return result


if __name__ == "__main__":
    main()

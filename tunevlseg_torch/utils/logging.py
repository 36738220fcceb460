"""Metric logging: console + JSONL file (+ CSV), and optional backends.

The port's own copy of `tunevlseg_tpu/utils/logging.py`. One process writes
(the port runs single-process), so there is no rank check. The mlflow,
neptune, comet, aim, wandb and tensorboard backends are imported when asked
for; an absent package degrades to a warning, as in the JAX module.
`log_images` writes PNGs with numpy and zlib alone (no cv2)."""
from __future__ import annotations

import json
import logging
import struct
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np


def get_logger(name: str = "tunevlseg") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(name)s][%(levelname)s] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def _record(metrics: Mapping[str, Any], step: int, prefix: str) -> dict:
    record = {f"{prefix}{k}": (float(v) if hasattr(v, "__float__") else v)
              for k, v in metrics.items()}
    record["step"] = step
    return record


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG (filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


class MetricLogger:
    def __init__(self, output_dir: Optional[str | Path] = None,
                 name: str = "metrics"):
        self.logger = get_logger()
        self.path = None
        if output_dir is not None:
            Path(output_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(output_dir) / f"{name}.jsonl"
        self._t0 = time.time()

    def log(self, metrics: Mapping[str, Any], step: int,
            prefix: str = "") -> None:
        record = _record(metrics, step, prefix)
        record["wall_s"] = round(time.time() - self._t0, 2)
        if self.path is not None:
            with open(self.path, "a") as fp:
                fp.write(json.dumps(record) + "\n")
        pretty = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in record.items() if k != "wall_s")
        self.logger.info(pretty)


class _MLflowBackend:
    """configs/logger/mlflow.yaml: file tracking URI under log_dir."""

    def __init__(self, output_dir, project, exp_name, tags):
        import mlflow
        self._m = mlflow
        uri = Path(output_dir or ".") / "mlflow" / "mlruns"
        mlflow.set_tracking_uri(f"file:{uri}")
        mlflow.set_experiment(project or "tunevlseg")
        self._run = mlflow.start_run(run_name=exp_name)
        if tags:
            mlflow.set_tags({t: 1 for t in tags})

    def log(self, record, step):
        self._m.log_metrics({k: v for k, v in record.items()
                             if isinstance(v, (int, float)) and k != "step"},
                            step=step)

    def log_hyperparams(self, payload):
        flat = {k: str(v)[:250] for k, v in payload.get("cfg", {}).items()}
        self._m.log_params(flat)

    def close(self):
        self._m.end_run()


class _NeptuneBackend:
    """configs/logger/neptune.yaml: api token from NEPTUNE_API_TOKEN."""

    def __init__(self, output_dir, project, exp_name, tags):
        import neptune
        self._run = neptune.init_run(project=project, name=exp_name,
                                     tags=list(tags))

    def log(self, record, step):
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "step":
                self._run[k].append(v, step=step)

    def log_hyperparams(self, payload):
        self._run["hparams"] = {k: str(v) for k, v
                                in payload.get("cfg", {}).items()}

    def close(self):
        self._run.stop()


class _CometBackend:
    """configs/logger/comet.yaml: api key from COMET_API_TOKEN."""

    def __init__(self, output_dir, project, exp_name, tags):
        from comet_ml import Experiment
        self._exp = Experiment(project_name=project)
        if exp_name:
            self._exp.set_name(exp_name)
        for t in tags:
            self._exp.add_tag(str(t))

    def log(self, record, step):
        self._exp.log_metrics({k: v for k, v in record.items()
                               if isinstance(v, (int, float))}, step=step)

    def log_hyperparams(self, payload):
        self._exp.log_parameters(payload.get("cfg", {}))

    def close(self):
        self._exp.end()


class _AimBackend:
    """configs/logger/aim.yaml: .aim repo under the output dir."""

    def __init__(self, output_dir, project, exp_name, tags):
        from aim import Run
        self._run = Run(repo=str(output_dir or "."),
                        experiment=project or "default")
        for t in tags:
            self._run.add_tag(str(t))

    def log(self, record, step):
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "step":
                self._run.track(v, name=k, step=step)

    def log_hyperparams(self, payload):
        self._run["hparams"] = {k: str(v) for k, v
                                in payload.get("cfg", {}).items()}

    def close(self):
        self._run.close()


# import-gated optional backends (configs/logger/*.yaml); absent packages
# degrade to a warning at construction time
OPTIONAL_BACKENDS = {
    "mlflow": _MLflowBackend,
    "neptune": _NeptuneBackend,
    "comet": _CometBackend,
    "aim": _AimBackend,
}

# configs/logger/many_loggers.yaml: every offline-safe backend at once
MANY_LOGGERS = ("jsonl", "csv", "tensorboard", "wandb")


class MultiLogger(MetricLogger):
    """Fan-out logger over the backends of configs/logger/*:

      * "jsonl"        native stream (always useful, default)
      * "csv"          Lightning CSVLogger-style metrics.csv
      * "tensorboard"  torch.utils.tensorboard SummaryWriter
      * "wandb"/"mlflow"/"neptune"/"comet"/"aim": imported when asked for;
        absent packages degrade with a warning
      * "many_loggers" expands to every offline-safe backend

    `log_images` writes the validation panel (input / target / prediction)."""

    def __init__(self, output_dir: Optional[str | Path] = None,
                 name: str = "metrics",
                 backends: tuple = ("jsonl", "csv"),
                 project: Optional[str] = None,
                 exp_name: Optional[str] = None,
                 tags: tuple = ()):
        super().__init__(output_dir, name)
        if "many_loggers" in backends:
            backends = tuple(b for b in backends if b != "many_loggers")
            backends += tuple(b for b in MANY_LOGGERS if b not in backends)
        self.backends = tuple(backends)
        self._extra = []
        for bname in self.backends:
            cls = OPTIONAL_BACKENDS.get(bname)
            if cls is None:
                continue
            try:
                self._extra.append(cls(output_dir, project, exp_name, tags))
            except Exception as e:
                self.logger.warning("%s logger unavailable: %s", bname, e)
        self._rows: list[dict] = []
        self._csv_path = (Path(output_dir) / f"{name}.csv"
                          if output_dir and "csv" in self.backends else None)
        self._tb = None
        if output_dir and "tensorboard" in self.backends:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(str(Path(output_dir) / "tb"))
            except Exception as e:
                self.logger.warning("tensorboard unavailable: %s", e)
        self._wandb = None
        if "wandb" in self.backends:
            try:
                import wandb
                self._wandb = wandb.init(project=project or name,
                                         name=exp_name, tags=list(tags),
                                         dir=str(output_dir))
            except Exception as e:
                self.logger.warning("wandb unavailable: %s", e)

    def log_hyperparams(self, cfg: Mapping[str, Any],
                        extras: Optional[Mapping[str, Any]] = None) -> None:
        """Composed config + model stats (parameter counts) into every
        backend."""
        payload = {"cfg": dict(cfg), **(extras or {})}
        if self.path is not None:
            (self.path.parent / "hparams.json").write_text(
                json.dumps(payload, indent=2, default=str))
        if self._tb is not None:
            self._tb.add_text("hparams",
                              "```\n" + json.dumps(payload, indent=2,
                                                   default=str) + "\n```")
        if self._wandb is not None:
            self._wandb.config.update(payload, allow_val_change=True)
        for b in self._extra:
            try:
                b.log_hyperparams(payload)
            except Exception as e:
                self.logger.warning("%s log_hyperparams failed: %s",
                                    type(b).__name__, e)

    def log(self, metrics: Mapping[str, Any], step: int,
            prefix: str = "") -> None:
        super().log(metrics, step, prefix)
        record = _record(metrics, step, prefix)
        if self._csv_path is not None:
            import csv
            self._rows.append(record)
            keys: list[str] = []
            for r in self._rows:
                keys.extend(k for k in r if k not in keys)
            with open(self._csv_path, "w", newline="") as fp:
                w = csv.DictWriter(fp, fieldnames=keys)
                w.writeheader()
                w.writerows(self._rows)
        if self._tb is not None:
            for k, v in record.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(record, step=step)
        for b in self._extra:
            try:
                b.log(record, step)
            except Exception as e:
                self.logger.warning("%s log failed: %s", type(b).__name__, e)

    def log_images(self, tag: str, images, step: int = 0,
                   captions: Optional[list] = None) -> None:
        """images: list of (H, W) or (H, W, 3) float [0,1] / uint8 arrays."""
        panels = []
        for img in images:
            a = np.asarray(img)
            if a.dtype != np.uint8:
                a = (np.clip(np.nan_to_num(a), 0, 1) * 255).astype(np.uint8)
            if a.ndim == 2:
                a = np.repeat(a[..., None], 3, axis=-1)
            panels.append(a)
        if self.path is not None:
            img_dir = self.path.parent / "images"
            img_dir.mkdir(exist_ok=True)
            paths = []
            for i, a in enumerate(panels):
                p = img_dir / f"{tag}_{step}_{i}.png"
                write_png(p, a)
                paths.append(str(p))
            with open(self.path, "a") as fp:
                fp.write(json.dumps({
                    "step": step, "images": paths, "tag": tag,
                    "captions": captions}) + "\n")
        if self._tb is not None:
            for i, a in enumerate(panels):
                self._tb.add_image(f"{tag}/{i}", a, step,
                                   dataformats="HWC")
            if captions:
                self._tb.add_text(tag, " | ".join(map(str, captions)), step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        for b in self._extra:
            try:
                b.close()
            except Exception as e:
                self.logger.warning("%s close failed: %s", type(b).__name__, e)

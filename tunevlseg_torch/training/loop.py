"""The fit / test / predict loop.

The port's counterpart of `tunevlseg_tpu/training/loop.py`: an epoch loop
with validation after each train epoch, stepwise metric logging,
ReduceLROnPlateau on val_loss, early stopping, best-`val_dice`
checkpointing, interval snapshots, step-exact resume, a SIGTERM watch, the
final test and prediction masks at the original resolution.

The model owns its weights and its device: the loop runs where the model
is, moves nothing but the batches, and has no CPU fallback.
`steps_per_execution = k` runs each full group of k batches through the
task's `compile_train_multistep(k)` (on a CUDA device one captured CUDA
graph of the k steps, `training/graphs.py`), with the batches stacked on
the device, and logs the mean of their metrics at group boundaries, as the
JAX loop's fused group does; the batches left at an epoch's end run one
step at a time. With the task's
`accumulate_grad_batches`, a train step is a micro-step, counted as one step
as the JAX Trainer counts it (logging, snapshots, `steps_per_execution`
groups); a window left partial at an epoch's end carries into the next, and
a checkpoint holds it.

Data parallel: in a process group (`parallel/distributed.py`, one rank per
card) `fit` runs the task's steps from `compile_steps`: the model under
DistributedDataParallel, or sharded by `fully_shard` with `fsdp=True` (the
JAX loop's FSDP over its `data` axis). Each rank trains on its loader's
shard; the validation and test metric sums are all-reduced before they are
computed, so the plateau scheduler, early stopping and the "best"
checkpoint see the same numbers on every rank; rank 0 alone logs and
writes checkpoints; a SIGTERM on any rank stops every rank at the same
step. Under more than one rank `steps_per_execution` is 1 and no image
panel is logged, as in the JAX loop. The JAX loop's `mesh` and `seq_shard`
(GSPMD tensor and sequence parallelism) have no counterpart: asking for one
raises.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from tunevlseg_torch.data.opencv import cv2 as _cv2
from tunevlseg_torch.data.pipeline import DataLoader, device_batch
from tunevlseg_torch.ops.metrics import SegMetricState, compute
from tunevlseg_torch.parallel import data_parallel, distributed
from tunevlseg_torch.training.checkpoint import CheckpointManager
from tunevlseg_torch.training.optim import (ReduceLROnPlateau,
                                            get_learning_rate,
                                            set_learning_rate)
from tunevlseg_torch.training.task import SegmentationTask, TrainState
from tunevlseg_torch.utils.logging import MultiLogger, get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class EarlyStopping:
    """Lightning EarlyStopping semantics (configs/callbacks/default.yaml:
    monitor val_loss, patience 12, min_delta 1e-4, mode min)."""

    patience: int = 12
    min_delta: float = 1e-4
    mode: str = "min"
    best: Optional[float] = None
    count: int = 0

    def should_stop(self, value: float) -> bool:
        improved = (self.best is None
                    or (value < self.best - self.min_delta
                        if self.mode == "min"
                        else value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience


class _PreemptionWatch:
    """While installed, a SIGTERM only raises a flag: fit() finishes the
    step group in flight, writes a resumable 'last' checkpoint and returns,
    instead of dying mid-epoch with an unsaved optimizer state. Under
    several ranks the decision is the OR of every rank's flag, taken after
    each step group (`distributed.any_flag`): SIGTERM reaches ranks one at a
    time, and a rank that stops while another enters the next step's
    all-reduce would hang both."""

    def __init__(self):
        self.flag = False
        self._prev = None

    def install(self):
        import signal

        def handler(signum, frame):
            self.flag = True

        try:
            prev = signal.signal(signal.SIGTERM, handler)
            # getsignal() returns None for handlers installed from C:
            # restore SIG_DFL then (passing None back raises)
            self._prev = (signal.SIGTERM,
                          signal.SIG_DFL if prev is None else prev)
        except ValueError:  # not the main thread
            self._prev = None
        return self

    def uninstall(self):
        import signal
        if self._prev is not None:
            signal.signal(*self._prev)
            self._prev = None

    def preempted(self) -> bool:
        return distributed.any_flag(self.flag)


@dataclasses.dataclass
class Trainer:
    task: SegmentationTask
    output_dir: Path
    max_epochs: int = 20
    min_epochs: int = 1
    log_every_n_steps: int = 6
    monitor: str = "val_dice"
    scheduler: Optional[ReduceLROnPlateau] = None
    early_stopping: Optional[EarlyStopping] = None
    limit_batches: Optional[int] = None  # debug (fdr / limit configs)
    loggers: tuple = ("jsonl", "csv")    # configs/logger/* equivalents
    exp_name: Optional[str] = None       # run identity for wandb / tb
    project: Optional[str] = None
    tags: tuple = ()
    log_image_num: int = 4               # val panel size
    # >1 runs that many train steps a group through the task's
    # `compile_train_multistep` and logs their mean metrics at group
    # boundaries; leftover batches at the epoch's end run one at a time
    steps_per_execution: int = 1
    # >0 writes an exactly resumable mid-epoch 'last' snapshot every N global
    # steps (Lightning ModelCheckpoint every_n_train_steps): covers hard kills
    # that never deliver the SIGTERM the watch relies on
    ckpt_every_n_steps: int = 0
    # FSDP: parameters, AdamW moments and the frozen towers sharded over the
    # process group's ranks (`fully_shard`); needs a process group
    fsdp: bool = False
    # options of the JAX trainer without a counterpart here
    mesh: Any = None
    seq_shard: bool = False

    def __post_init__(self):
        if self.mesh is not None or self.seq_shard:
            raise NotImplementedError(
                "mesh / seq_shard (GSPMD tensor and sequence parallelism) are "
                'not ported: ROADMAP "Do not port"; data parallel over GPUs '
                "runs in a process group (fsdp / trainer.n_devices)")
        if self.fsdp:
            data_parallel.require_group("Trainer(fsdp=True)")
        if distributed.world_size() > 1:
            # one step at a time and no image panel, as the JAX loop under
            # several processes
            self.steps_per_execution = 1
            self.log_image_num = 0
        self.output_dir = Path(self.output_dir)
        self.device = next(self.task.model.parameters()).device
        self.ckpt = CheckpointManager(self.output_dir / "checkpoints",
                                      self.task.model, monitor=self.monitor)
        # rank 0 alone writes the logs
        lead = distributed.rank() == 0
        self.metrics_log = MultiLogger(self.output_dir if lead else None,
                                       backends=self.loggers if lead else (),
                                       project=self.project,
                                       exp_name=self.exp_name,
                                       tags=tuple(self.tags or ()))
        # whether `_setup` has wrapped the task's model for its process group
        self._set_up = False
        # the task's program of `steps_per_execution` steps, built by `_setup`
        self._multi = None
        # (epoch, train batches, seconds of the epoch's train part, host
        # clock, the device drained at both ends)
        self.train_times: list[tuple[int, int, float]] = []
        # the last validation's metrics (`val_loss`, `val_dice`, ...), as
        # Lightning's callback_metrics hold them after a fit
        self.val_metrics: dict[str, float] = {}

    def _on_device(self, batch: dict) -> dict:
        return device_batch(batch, self.device)

    def _log(self, *args, **kwargs) -> None:
        """A metrics record, from rank 0 alone."""
        if distributed.rank() == 0:
            self.metrics_log.log(*args, **kwargs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _setup(self, state: TrainState) -> TrainState:
        """Once, in a process group: `task.compile_steps` wraps the task's
        model in DDP, or shards it with `fsdp` (the state then gets its
        optimizer over the shards)."""
        if not self._set_up and distributed.is_initialized():
            if self.fsdp:
                state = self.task.state_fsdp_shardings(state)
            self.task.compile_steps(fsdp=self.fsdp)
        if not self._set_up and self.steps_per_execution > 1:
            self._multi = self.task.compile_train_multistep(self.steps_per_execution)
        self._set_up = True
        return state

    # ---------------------------------------------------------------

    def _run_eval(self, state: TrainState, loader: DataLoader,
                  prefix: str) -> dict:
        mstate = SegMetricState.zeros(self.device)
        loss_sum = torch.zeros((), dtype=torch.float64, device=self.device)
        n = torch.zeros((), dtype=torch.float64, device=self.device)
        for i, batch in enumerate(loader):
            if self.limit_batches is not None and i >= self.limit_batches:
                break
            mstate, extra = self.task.eval_step(mstate, self._on_device(batch),
                                                state)
            loss_sum += extra["loss_sum"].double()
            n += extra["n"].double()
        # every rank's sums (the JAX metrics' psum over the data axis)
        sums = distributed.all_reduce_sum(
            {"loss_sum": loss_sum, "n": n, **mstate._asdict()})
        loss_sum, n = sums.pop("loss_sum"), sums.pop("n")
        mstate = SegMetricState(**sums)
        result = {f"{prefix}_{k}": float(v)
                  for k, v in compute(mstate).items()}
        result[f"{prefix}_loss"] = float(loss_sum) / max(float(n), 1.0)
        return result

    def _log_val_panel(self, state: TrainState, loader: DataLoader) -> None:
        """The first validation batch as an image panel (input / target /
        prediction, with the prompt as caption)."""
        try:
            batch = next(iter(loader))
        except StopIteration:
            return
        preds = self.task.predict_step(self._on_device(batch), state)
        preds = preds.cpu().numpy()
        n = min(self.log_image_num, preds.shape[0])
        panels, captions = [], []
        for j in range(n):
            img = np.asarray(batch["image"][j])            # (C, H, W)
            if img.dtype == np.uint8:
                rgb = img.transpose(1, 2, 0)
            else:  # undo the dataset normalization for display
                mean, std = self.task.image_stats
                rgb = (img.transpose(1, 2, 0) * np.asarray(std)
                       + np.asarray(mean))
            panels.extend([rgb, np.asarray(batch["mask"][j, 0]), preds[j, 0]])
            prompts = batch.get("prompt")
            captions.append(prompts[j] if prompts is not None else f"#{j}")
        self.metrics_log.log_images("val_caption_label", panels,
                                    step=int(state.step), captions=captions)

    def _train_groups(self, loader):
        """Yield single batches, or lists of `steps_per_execution` batches
        (only full groups; stragglers run one step at a time)."""
        k = self.steps_per_execution
        pending = []
        for i, batch in enumerate(loader):
            if self.limit_batches is not None and i >= self.limit_batches:
                break
            if k <= 1:
                yield batch
                continue
            pending.append(batch)
            if len(pending) == k:
                yield pending
                pending = []
        for batch in pending:
            yield batch

    def _fit_extra(self) -> dict:
        """Host-side loop state kept in each checkpoint's meta, so that a
        resumed fit continues the scheduler and early stopping."""
        extra: dict[str, Any] = {}
        if self.scheduler is not None:
            extra["scheduler"] = {
                "best": self.scheduler.best,
                "num_bad_epochs": self.scheduler.num_bad_epochs,
                "cooldown_counter": self.scheduler.cooldown_counter}
        if self.early_stopping is not None:
            extra["early_stopping"] = {"best": self.early_stopping.best,
                                       "count": self.early_stopping.count}
        return extra

    def _resolve_resume(self, spec) -> tuple[CheckpointManager, str]:
        """`spec` is a tag of this run's own checkpoint directory ("last" /
        "best"), a checkpoints directory ("last", else "best"), or the path
        of one tag directory."""
        if spec in ("last", "best"):
            return self.ckpt, spec
        p = Path(spec)
        if (p / "last").exists() or (p / "best").exists():
            mgr = CheckpointManager(p, self.task.model, monitor=self.monitor)
            return mgr, "last" if (p / "last").exists() else "best"
        if not p.exists():
            raise FileNotFoundError(f"ckpt_path {spec} does not exist")
        return (CheckpointManager(p.parent, self.task.model,
                                  monitor=self.monitor), p.name)

    def fit(self, state: TrainState, train_loader: DataLoader,
            val_loader: Optional[DataLoader] = None,
            resume_from: Optional[str] = None) -> TrainState:
        state = self._setup(state)
        self.ckpt.save_frozen()

        start_epoch = 0
        resume_offset = 0
        if resume_from:
            mgr, tag = self._resolve_resume(resume_from)
            state = mgr.restore(tag, state)
            meta = mgr.load_meta(tag)
            start_epoch = int(meta.get("epoch", -1)) + 1
            if meta.get("preempted") or meta.get("mid_epoch"):
                # step-level resume: replay only the tail of the interrupted
                # epoch (its order is a function of (seed, epoch))
                resume_offset = int(meta.get("batch_offset", 0))
            self.ckpt.best_value = meta.get("best_value")
            if self.scheduler is not None and meta.get("scheduler"):
                for k, v in meta["scheduler"].items():
                    setattr(self.scheduler, k, v)
            if self.early_stopping is not None and meta.get("early_stopping"):
                self.early_stopping.best = meta["early_stopping"]["best"]
                self.early_stopping.count = int(
                    meta["early_stopping"]["count"])
            log.info(f"resumed from {resume_from} ({tag}) at epoch "
                     f"{start_epoch}, step {int(state.step)}")

        watch = _PreemptionWatch().install()
        try:
            state = self._fit_epochs(watch, state, train_loader, val_loader,
                                     start_epoch, int(state.step),
                                     resume_offset)
        finally:
            watch.uninstall()
        # writes are asynchronous: drain before the caller reads checkpoints
        # (test on best) or the process exits
        self.ckpt.wait()
        return state

    def _fit_epochs(self, watch, state, train_loader, val_loader,
                    start_epoch, global_step, resume_offset=0):
        for epoch in range(start_epoch, self.max_epochs):
            train_loader.set_epoch(
                epoch, resume_offset if epoch == start_epoch else 0)
            epoch_batches = resume_offset if epoch == start_epoch else 0
            self._sync()
            t_epoch, n_epoch = time.perf_counter(), 0
            for group in self._train_groups(train_loader):
                if isinstance(group, list):  # one program of k steps
                    on_device = [self._on_device(batch) for batch in group]
                    state, m = self._multi(state, {
                        k: torch.stack([b[k] for b in on_device])
                        for k in on_device[0]})
                    inc = len(group)
                else:
                    state, m = self.task.train_step(state, self._on_device(group))
                    inc = 1
                global_step += inc
                epoch_batches += inc
                n_epoch += inc
                # promote a finished background write (non-blocking)
                self.ckpt.poll()

                def crossed(n):
                    return n and (global_step // n) != (
                        (global_step - inc) // n)

                if crossed(self.log_every_n_steps):
                    self._log(m, global_step, prefix="train_")
                if crossed(self.ckpt_every_n_steps):
                    # interval snapshot, exactly resumable mid-epoch
                    self.ckpt.save("last", state,
                                   {"epoch": epoch - 1, "mid_epoch": True,
                                    "batch_offset": epoch_batches,
                                    **self._fit_extra()})
                if watch.preempted():
                    preempted = True
                    break
            else:
                preempted = False
            self._sync()
            self.train_times.append(
                (epoch, n_epoch, time.perf_counter() - t_epoch))
            if preempted:
                # epoch - 1 = the last completed epoch, batch_offset = the
                # batches of this epoch already trained: a resume from
                # .../last replays only the epoch's tail and ends where an
                # uninterrupted run would
                self.ckpt.save("last", state,
                               {"epoch": epoch - 1, "preempted": True,
                                "batch_offset": epoch_batches,
                                **self._fit_extra()})
                log.warning(
                    f"SIGTERM: saved resumable 'last' at step "
                    f"{int(state.step)} (epoch {epoch} batch "
                    f"{epoch_batches}); resume with "
                    f"ckpt_path={self.ckpt.dir / 'last'}")
                break

            epoch_metrics: dict[str, float] = {"epoch": epoch}
            if val_loader is not None:
                if self.log_image_num > 0:
                    self._log_val_panel(state, val_loader)
                epoch_metrics.update(self._run_eval(state, val_loader, "val"))
                self.val_metrics = {k: v for k, v in epoch_metrics.items()
                                    if k != "epoch"}
                self._log(epoch_metrics, global_step)

                # the scheduler and early stopping advance before the
                # checkpoint, so that its meta and learning rate describe
                # the completed epoch
                val_loss = epoch_metrics["val_loss"]
                if self.scheduler is not None:
                    lr = get_learning_rate(state.optimizer)
                    new_lr = self.scheduler.step(val_loss, lr)
                    if new_lr != lr:
                        log.info(f"plateau: lr {lr:.2e} -> {new_lr:.2e}")
                        set_learning_rate(state.optimizer, new_lr)
                stop = (self.early_stopping is not None
                        and epoch + 1 >= self.min_epochs
                        and self.early_stopping.should_stop(val_loss))
                self.ckpt.maybe_save_best(state, epoch_metrics, epoch,
                                          extra=self._fit_extra())
                if stop:
                    log.info(f"early stopping at epoch {epoch}")
                    break
            else:
                self.ckpt.save("last", state,
                               {"epoch": epoch, **self._fit_extra()})
        return state

    def test(self, state: TrainState, test_loader: DataLoader,
             use_best: bool = True) -> dict:
        if use_best and (self.ckpt.dir / "best").exists():
            state = self.ckpt.restore("best", state)
        result = self._run_eval(state, test_loader, "test")
        self._log(result, int(state.step))
        return result

    def predict(self, state: TrainState, loader: DataLoader,
                save_dir: Optional[Path] = None,
                use_best: bool = True) -> list[dict]:
        """Predict steps over `loader`; with `save_dir`, each mask is written
        at its sample's original resolution (bicubic, as the reference's
        save_utils), which needs cv2."""
        if save_dir is not None:
            cv2 = _cv2()
        if use_best and (self.ckpt.dir / "best").exists():
            state = self.ckpt.restore("best", state)
        outputs = []
        for batch in loader:
            preds = self.task.predict_step(self._on_device(batch), state)
            preds = preds.cpu().numpy()
            for j in range(len(batch["mask_name"])):
                if batch["valid"][j] == 0:
                    continue
                rec = {"pred": preds[j, 0],
                       "mask_name": batch["mask_name"][j],
                       "mask_shape": batch["mask_shape"][j]}
                outputs.append(rec)
                if save_dir is not None:
                    save_dir = Path(save_dir)
                    h, w = (int(x) for x in rec["mask_shape"])
                    resized = cv2.resize(rec["pred"], (w, h),
                                         interpolation=cv2.INTER_CUBIC)
                    out_path = save_dir / rec["mask_name"]
                    out_path.parent.mkdir(parents=True, exist_ok=True)
                    resized = np.nan_to_num(np.clip(resized, 0, 1))
                    cv2.imwrite(str(out_path),
                                (resized * 255).astype(np.uint8))
        return outputs

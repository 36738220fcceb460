"""Checkpoints: best / last management, crash-safe promotion, resume.

The port's counterpart of `tunevlseg_tpu/training/checkpoint.py`, with
torch-native files instead of orbax. A checkpoint directory holds

    <tag>/state.pt     trainable parameters (by `state_dict` name of the
                       model), the optimizer's state dict (moments, step,
                       learning rate), its accumulation window (the
                       running mean and the micro-step count, so that a
                       resume mid-window is exact), `TrainState.step` and
                       `TrainState.model_state`
    <tag>.json         the loop's meta: epoch, metrics, scheduler and
                       early-stopping state, `best_value`
    frozen/frozen.pt   everything else of the model's `state_dict` (frozen
                       parameters and buffers), written once per run

`save` copies the tensors to the host before it returns (the model's
weights change in place at the next step), then writes them in a background
thread into `.staging-<tag>`. The swap into `<tag>` and the meta write
happen only at the next drain point (`poll`, `wait`, the next `save`,
`load_meta`, `restore`), so a crash during the write keeps the old
checkpoint intact.

Under data parallel every rank calls the same methods in the same order:
the files hold full tensors whatever wrote them (FSDP's DTensor shards are
gathered, every rank taking part), rank 0 alone writes and promotes, and
every rank waits at a barrier after a drain, so that none reads a
checkpoint mid-promotion (`poll` promotes only on one process). A restore
lays the full tensors out as the live parameters are (sharded under FSDP),
so a checkpoint of one layout restores bit for bit into another. The
Under tensor parallelism the frozen file holds the whole tensors too: the
slices of `model.tp_plan` are gathered over the model group, and a restore
slices them again. The accumulation window is each rank's own under DDP
(`no_sync`): a checkpoint
taken mid-window holds every rank's running mean (`per_rank`), gathered to
rank 0, and restores only into as many ranks; under FSDP and on one device
the window is one (FSDP reduces each micro-step's gradients) and a
checkpoint holds it whole."""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import torch
from torch import nn

from tunevlseg_torch.parallel import data_parallel, distributed, tensor_parallel
from tunevlseg_torch.training.task import TrainState

STATE_FILE = "state.pt"
FROZEN_FILE = "frozen.pt"


def to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to the CPU (dicts, lists and
    tuples are walked; other leaves are returned as they are)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def trainable_names(model: nn.Module) -> list[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def full(obj: Any) -> Any:
    """A copy of `obj` with every DTensor gathered whole (a collective:
    every rank calls it on the same structure); dicts, lists and tuples are
    walked, other leaves returned as they are."""
    if isinstance(obj, torch.Tensor):
        return data_parallel.full_tensor(obj)
    if isinstance(obj, dict):
        return {k: full(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(full(v) for v in obj)
    return obj


def copy_into(target: torch.Tensor, value: torch.Tensor) -> None:
    """Copy the full tensor `value` into `target` in place, laid out as
    `target` is (a DTensor shard under FSDP)."""
    with torch.no_grad():
        target.copy_(data_parallel.to_placement(value, target))


def optimizer_state_to_params(saved: dict, params: list) -> dict:
    """A torch optimizer state dict of full tensors with every per-parameter
    tensor laid out as its parameter (under FSDP a DTensor shard), so that
    `load_state_dict` pairs the moments with their shards."""
    state = {}
    for i, entries in saved["state"].items():
        p = params[int(i)]
        state[i] = {k: (data_parallel.to_placement(v, p)
                        if isinstance(v, torch.Tensor) and v.shape == p.shape
                        and v.dim() else v)
                    for k, v in entries.items()}
    return {**saved, "state": state}


def accumulation_payload(optimizer) -> dict:
    """What a checkpoint holds of the accumulation window: the window whole
    on one device and under FSDP, every rank's own under DDP with several
    ranks (gathered to rank 0; None elsewhere), only when the window is not
    empty."""
    acc = optimizer.accumulation_state()
    window = full(acc["accumulated"])
    sharded = any(data_parallel.is_dtensor(t) for t in acc["accumulated"].values())
    if distributed.world_size() == 1 or sharded or not acc["mini_step"]:
        return {"mini_step": acc["mini_step"], "accumulated": to_host(window)}
    ranks = distributed.gather_to_rank0(to_host(window))
    return {"mini_step": acc["mini_step"], "accumulated": {}, "per_rank": ranks}


def rank_window(saved: dict) -> dict:
    """This rank's accumulation window out of a checkpoint's."""
    if "per_rank" not in saved:
        return saved
    ranks = saved["per_rank"]
    if len(ranks) != distributed.world_size():
        raise ValueError(
            f"the checkpoint was written by {len(ranks)} ranks in the middle of "
            f"an accumulation window; it resumes only into {len(ranks)} ranks "
            f"(this run has {distributed.world_size()})")
    return {"mini_step": saved["mini_step"],
            "accumulated": ranks[distributed.rank()]}


class CheckpointManager:
    def __init__(self, directory: str | Path, model: nn.Module,
                 monitor: str = "val_dice", mode: str = "max",
                 save_last: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.model = model
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.best_value: Optional[float] = None
        # (tag, staging_path, meta) for writes not yet swapped into their tag
        # directory; the thread writing the newest of them
        self._pending: list[tuple[str, Path, dict]] = []
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    def _is_better(self, value: float) -> bool:
        if self.best_value is None:
            return True
        return value > self.best_value if self.mode == "max" else \
            value < self.best_value

    def _drain(self) -> None:
        """Wait for the in-flight write, then promote every staged
        checkpoint into its tag directory and write its meta.

        Promotion order (every step a same-directory rename): old tag ->
        .old-{tag}, staging -> tag, write meta, delete .old-{tag}. A crash at
        any point leaves a recoverable layout: the one gap (tag absent,
        .old- present) is healed by the recovery sweep at the next drain."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        try:
            self._promote()
        finally:
            # a rank 0 whose write failed still lets the others go on
            distributed.barrier()

    def _promote(self) -> None:
        if self._write_error is not None:
            error, self._write_error = self._write_error, None
            self._pending.clear()
            raise RuntimeError("checkpoint write failed") from error
        for tag, staging, meta in self._pending:
            final = self.dir / tag
            old = self.dir / f".old-{tag}"
            if old.exists():          # recovery from a previous crash
                shutil.rmtree(old)
            if final.exists():
                final.rename(old)
            staging.rename(final)
            # a crash mid-write must not leave a truncated JSON behind
            meta_tmp = self.dir / f".{tag}.json.tmp"
            meta_tmp.write_text(json.dumps(meta, default=float))
            meta_tmp.rename(self.dir / f"{tag}.json")
            if old.exists():
                shutil.rmtree(old)
        # heal the crash gap: tag missing but .old- preserved
        for old in self.dir.glob(".old-*"):
            final = self.dir / old.name[len(".old-"):]
            if not final.exists():
                old.rename(final)
        self._pending.clear()

    def wait(self) -> None:
        """Finish the in-flight write and promote staged checkpoints (call
        before reading checkpoints or ending the run)."""
        self._drain()

    def _save_in_flight(self) -> bool:
        return self._writer is not None and self._writer.is_alive()

    def poll(self) -> None:
        """Non-blocking promotion: if the background write has finished,
        promote now, so that an interval snapshot becomes durable at the
        first step after its write instead of at the next save. Under
        several ranks promotion waits for the next drain, whose barrier
        every rank reaches at the same point."""
        if (distributed.world_size() == 1 and self._pending
                and not self._save_in_flight()):
            self._drain()

    def frozen_state(self) -> dict[str, torch.Tensor]:
        """The model's `state_dict` less its trainable parameters (under FSDP
        its DTensor shards)."""
        skip = set(trainable_names(self.model))
        return {k: v for k, v in self.model.state_dict().items()
                if k not in skip}

    def save_frozen(self) -> None:
        """Write the frozen parameters and buffers, once per directory (rank
        0 writes; every rank gathers FSDP's shards and waits for it)."""
        path = self.dir / "frozen"
        exists = path.exists()
        distributed.barrier()
        if exists:
            return
        frozen = tensor_parallel.full_tensors(self.model,
                                              full(self.frozen_state()))
        if distributed.rank() == 0:
            staging = self.dir / ".staging-frozen"
            if staging.exists():
                shutil.rmtree(staging)
            staging.mkdir()
            torch.save(to_host(frozen), staging / FROZEN_FILE)
            staging.rename(path)
        distributed.barrier()

    def restore_frozen(self) -> None:
        """Load the frozen parameters and buffers back into the model, in
        place."""
        saved = torch.load(self.dir / "frozen" / FROZEN_FILE,
                           map_location="cpu", weights_only=True)
        own = self.frozen_state()
        if set(saved) != set(own):
            raise KeyError(
                f"frozen checkpoint names differ from the model's: missing "
                f"{sorted(set(own) - set(saved))[:5]}, unexpected "
                f"{sorted(set(saved) - set(own))[:5]}")
        for name, value in saved.items():
            copy_into(own[name], tensor_parallel.local_part(self.model, name, value))

    def save(self, tag: str, state: TrainState, extra: dict) -> None:
        """Copy the state to the host now, write it in a background thread
        into a staging directory; the swap into `tag` and the meta write
        happen at the next drain point."""
        self._drain()
        params = dict(self.model.named_parameters())
        payload = to_host(full({
            "trainable": {n: params[n] for n in trainable_names(self.model)},
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step),
            "model_state": state.model_state}))
        payload["accumulation"] = accumulation_payload(state.optimizer)
        if distributed.rank() != 0:
            return
        staging = self.dir / f".staging-{tag}"
        if staging.exists():
            shutil.rmtree(staging)
        # best_value rides every meta so a resumed run never demotes the
        # historical best on its first validation
        meta = {"best_value": self.best_value, **extra}

        def write():
            try:
                staging.mkdir()
                torch.save(payload, staging / STATE_FILE)
            except Exception as e:       # surfaced at the next drain
                self._write_error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()
        self._pending.append((tag, staging, meta))

    def maybe_save_best(self, state: TrainState, metrics: dict, epoch: int,
                        extra: Optional[dict] = None) -> bool:
        value = float(metrics[self.monitor])
        improved = self._is_better(value)
        meta = {"epoch": epoch, **(extra or {}),
                **{k: float(v) for k, v in metrics.items()}}
        if improved:
            self.best_value = value
            self.save("best", state, meta)
        if self.save_last:
            self.save("last", state, meta)
        return improved

    def load_meta(self, tag: str) -> dict:
        self._drain()
        path = self.dir / f"{tag}.json"
        if not path.exists():
            return {}
        return json.loads(path.read_text())

    def restore(self, tag: str, state: TrainState) -> TrainState:
        """Write the checkpoint's trainable parameters back into the model in
        place, load its optimizer state into `state.optimizer`, and return
        the TrainState it describes."""
        self._drain()
        saved = torch.load(self.dir / tag / STATE_FILE, map_location="cpu",
                           weights_only=True)
        params = dict(self.model.named_parameters())
        names = trainable_names(self.model)
        if set(saved["trainable"]) != set(names):
            raise KeyError(
                f"checkpoint {self.dir / tag} holds the trainable set "
                f"{sorted(saved['trainable'])[:5]}..., the model trains "
                f"{sorted(names)[:5]}...")
        for name in names:
            copy_into(params[name], saved["trainable"][name])
        opt = state.optimizer
        opt.load_state_dict(
            optimizer_state_to_params(saved["optimizer"], opt.params()))
        # a checkpoint written before gradient accumulation holds no window
        opt.load_accumulation_state(rank_window(
            saved.get("accumulation", {"mini_step": 0, "accumulated": {}})))
        device = next(self.model.parameters()).device
        model_state = {k: v.to(device) for k, v in
                       saved["model_state"].items()}
        return TrainState(int(saved["step"]), state.optimizer, model_state)

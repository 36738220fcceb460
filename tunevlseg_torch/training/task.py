"""The segmentation task: train, eval and predict steps.

Counterpart of `tunevlseg_tpu/training/task.py:SegmentationTask`. The batch
contract is the JAX package's:

    batch = {"image": (B, C, H, W) uint8 or f32, "mask": (B, 1, H, W) f32,
             "input_ids": (B, L) or (U, L) int, "attention_mask": same,
             "valid": (B,) f32 (optional), "text_index": (B,) int (optional)}

uint8 images are ImageNet-normalised on the device. The model holds its own
weights (`torch.func.functional_call` swaps in others; see
`tunevlseg_torch/serving.py`), and the steps run where those weights are.
`init` applies the freeze spec (frozen parameters get `requires_grad=False`,
so autograd builds no graph for them and the optimizer holds no state for
them) and builds the optimizer; `train_step` is forward, loss with `valid`
masking, backward, global-norm clip and the optimizer update, and it updates
the model's weights IN PLACE. Samples with `valid == 0` contribute a
constant term to the loss and nothing to the step metrics.

Dropout (the CRIS decoder's) is on in `train_step` only. Its masks come from
a `torch.Generator` on the model's device that is seeded anew each step from
(`seed`, step) and, under data parallel, the rank, as the JAX task folds the
step into its key: two runs of the same step draw the same masks, the next
step draws others. Eval, predict and
serving apply no dropout. BatchNorm layers never look at
`nn.Module.training`: a frozen backbone normalises with its running
statistics in a train step too.

`mutable_collections=("batch_stats",)` is the JAX task's: the model's buffers
(the BatchNorm running statistics) then live in `TrainState.model_state`.
`init` splits them out of the model, a train step reads them from the state,
lets the model hand back the ones it updated (the e2e CRIS model's FPN and
projector) and returns a state that holds the new ones, and `eval_step` and
`predict_step` read them from the state they are given. No buffer of the
module is written by a step.

Data parallel: `compile_steps` puts the model under DistributedDataParallel
(or `fully_shard` with `fsdp`) in a process group (`parallel/`), and the
steps take each rank's own rows: a train step's forward goes through the
wrapper, its metrics are those of every rank's rows, and each rank draws
its own dropout masks, from (seed, step, rank). With accumulation the
micro-steps run under DDP's `no_sync` and the window's mean is all-reduced
once, at the update (`bind_reductions`). A dice over the batch
(`loss_kwargs={"batch": True}`) sums over every rank's rows
(`ops/losses.py`), in a micro-step over the global micro-batch, so every
rank's loss and, after DDP's mean, its gradient are the global batch's.

`accumulate_grad_batches = k` makes each `train_step` a micro-step:
`TrainState.step` counts micro-steps, as the JAX task does, so each draws
the masks of (seed, micro-step) and updates the BatchNorm statistics, and
the optimizer applies the mean of k micro-steps' gradients at every k-th
(`optim.ClippedOptimizer`, optax.MultiSteps' semantics). `remat=True` runs
the loss under `nn/remat.forced(True)`: the towers' layers recompute their
internals in the backward, as the JAX task's per-layer remat does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Callable, Optional

import torch
from torch import nn
from torch.func import functional_call

from tunevlseg_torch.nn import remat as remat_lib
from tunevlseg_torch.ops import image as image_lib
from tunevlseg_torch.ops import losses as losses_lib
from tunevlseg_torch.ops import metrics as metrics_lib
from tunevlseg_torch.parallel import data_parallel, distributed
from tunevlseg_torch.training import graphs
from tunevlseg_torch.training import optim as optim_lib
from tunevlseg_torch.utils import profiling


def load_partial_state(model: nn.Module, params: dict,
                       elidable: tuple[str, ...] = ()) -> None:
    """Overlay `params` (a partial `state_dict`, say a converted checkpoint)
    on the model's weights and buffers in place. An entry the model does not
    have is dropped, with a log line, when its name starts with one of
    `elidable` (the places a converter names: the vision layers an early
    exit does not build, say), as the JAX task drops checkpoint tensors its
    model elides; any other raises and names it, as does a shape mismatch."""
    own = model.state_dict()
    dropped = [k for k in params if k not in own]
    stray = [k for k in dropped if not k.startswith(tuple(elidable))]
    if stray:
        raise KeyError(f"{len(stray)} checkpoint tensors have no place in the "
                       f"model and none that the converter names: {stray[:8]}")
    if dropped:
        logging.getLogger("tunevlseg").info(
            "dropping %d checkpoint tensors the model does not build, under "
            "%s (e.g. %s)", len(dropped), "/".join(elidable), dropped[0])
    for name, value in params.items():
        if name in own and tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"checkpoint tensor {name}: shape "
                             f"{tuple(value.shape)} != {tuple(own[name].shape)}")
    with torch.no_grad():
        for name, value in params.items():
            if name in own:
                own[name].copy_(torch.as_tensor(value))


def step_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """The seed of one train step's dropout masks: a function of (seed,
    step, rank) alone; the rank is the data rank, so that the ranks of one
    model group, which hold the same rows, draw the same masks."""
    rank = distributed.data_rank() if rank is None else rank
    return (seed * 1_000_003 + step + rank * 0x9E3779B97F4A7C15) % 2 ** 63


def step_generator(model: nn.Module, seed: int, step: int,
                   rank: Optional[int] = None) -> torch.Generator:
    """The generator of one train step's dropout masks, on the model's
    device, seeded with `step_seed`: under data parallel each rank draws
    its own masks for its own rows (rank 0 those of one device), and a
    resumed run draws what the uninterrupted one would."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(step_seed(seed, step, rank))
    return gen


def forward_with_state(ddp: Optional[nn.Module], model: nn.Module,
                       model_state: Optional[dict], args: tuple, kwargs: dict):
    """`model(*args, **kwargs)`, through its DDP wrapper `ddp` where one is
    given, with the buffers of `model_state` (by the model's `state_dict`
    names) in the place of its own where it carries them."""
    module, prefix = (model, "") if ddp is None else (ddp, "module.")
    if model_state:
        return functional_call(module, {prefix + k: v
                                        for k, v in model_state.items()},
                               args, kwargs)
    return module(*args, **kwargs)


def grad_sync(ddp: Optional[nn.Module], accumulate_grad_batches: int):
    """The context of a micro-step's forward and backward: DDP's `no_sync`
    when gradients accumulate (the window's mean is all-reduced once, at
    the update), else nothing."""
    if ddp is not None and accumulate_grad_batches > 1:
        return ddp.no_sync()
    return contextlib.nullcontext()


def bind_reductions(opt: optim_lib.ClippedOptimizer, ddp: Optional[nn.Module],
                    model: nn.Module) -> None:
    """The collectives the optimizer runs itself: under DDP with
    accumulation the window's mean over the ranks at the update (its
    micro-steps run under `no_sync`), under FSDP the mean over the ranks of
    the gradients of the parameters it leaves whole, and under tensor
    parallelism the mean of the trainable gradients over the model group."""
    opt.reduce_window = (data_parallel.mean_over_ranks_
                         if ddp is not None and opt.accumulate_steps > 1
                         else None)
    fsdp = (data_parallel.replicated_gradients(model)
            if data_parallel.is_sharded(model) else None)
    # tensor parallel: the mean over the model group that `shard_model` bound
    tp = getattr(model, "tp_reduce_grads", None)
    if fsdp is None or tp is None:
        opt.reduce_grads = fsdp or tp
        return

    def reduce_grads() -> None:
        fsdp()
        tp()
    opt.reduce_grads = reduce_grads


def global_step_metrics(loss: torch.Tensor,
                        local: metrics_lib.SegMetricState) -> dict:
    """A train step's {"loss", "dice", "iou"} over every rank's rows: the
    mean of the ranks' losses (equal local batches) and the metrics of the
    summed metric states, as the JAX step computes them on its global
    batch."""
    sums = distributed.all_reduce_sum({"loss": loss, **local._asdict()})
    loss = sums.pop("loss") / distributed.data_size()
    return {"loss": loss, **metrics_lib.compute(metrics_lib.SegMetricState(**sums))}


@dataclasses.dataclass
class TrainState:
    """The step count, the optimizer (its moments and learning rate) and,
    with `mutable_collections`, the buffers a step updates (the BatchNorm
    running statistics, by `state_dict` name); the weights live in the model."""
    step: int
    optimizer: optim_lib.ClippedOptimizer
    model_state: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SegmentationTask:
    model: nn.Module
    freeze_spec: optim_lib.FreezeSpec = optim_lib.FreezeSpec()
    loss_fn: Callable = losses_lib.dice_ce_loss
    loss_kwargs: dict = dataclasses.field(default_factory=dict)
    threshold: float = 0.5
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    seed: int = 0     # of the dropout masks, with the step
    # () or ("batch_stats",): the buffers a train step updates, kept in the state
    mutable_collections: tuple = ()
    # Lightning's trainer.accumulate_grad_batches: a train step is a
    # micro-step, and every k-th applies the update (optax.MultiSteps)
    accumulate_grad_batches: int = 1
    # per-layer rematerialisation of the towers' layers (nn/remat.py)
    remat: bool = False
    # (mean, std) for the device-side normalisation of uint8 image batches
    image_stats: tuple = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

    def __post_init__(self):
        optim_lib.accumulate_steps_of(self.accumulate_grad_batches)
        # the DistributedDataParallel wrapper of the model that
        # `compile_steps` builds; train steps run their forward through it
        self.ddp: Optional[nn.Module] = None
        if tuple(self.mutable_collections) not in ((), ("batch_stats",)):
            raise ValueError(
                f"mutable_collections {self.mutable_collections!r}: the only "
                'collection a step updates is "batch_stats"')

    # -- init ---------------------------------------------------------------

    def init(self, params: Optional[dict] = None,
             variables: Optional[dict] = None,
             elidable: tuple[str, ...] = ()) -> TrainState:
        """Apply the freeze spec to the model and build the optimizer over
        what is left trainable; with `mutable_collections`, copy the model's
        buffers into the state.

        `params` (a partial `state_dict`, say a converted checkpoint) and
        the buffers of `variables["batch_stats"]` (its BatchNorm statistics,
        by `state_dict` name) are overlaid on the model's first
        (`load_partial_state`, which drops what the model lacks under
        `elidable` and raises on anything else it lacks)."""
        overlay = dict(params or {})
        overlay.update((variables or {}).get("batch_stats", {}))
        if overlay:
            load_partial_state(self.model, overlay, elidable)
        optim_lib.apply_freeze(self.model, self.freeze_spec)
        model_state = {}
        if self.mutable_collections:
            model_state = {name: buf.detach().clone()
                           for name, buf in self.model.named_buffers()}
        return TrainState(0, self.make_optimizer(), model_state)

    def make_optimizer(self) -> optim_lib.ClippedOptimizer:
        """The optimizer over the model's trainable parameters as they are
        now (FSDP's DTensors once the model is sharded)."""
        return optim_lib.make_optimizer(
            self.model, self.learning_rate, self.weight_decay,
            grad_clip_norm=self.grad_clip_norm,
            accumulate_steps=self.accumulate_grad_batches)

    # -- steps --------------------------------------------------------------

    def _prep_image(self, image: torch.Tensor) -> torch.Tensor:
        if image.dtype != torch.uint8:
            return image
        return image_lib.normalize_uint8(image, self.image_stats)

    def model_inputs(self, batch: dict) -> tuple[tuple, dict]:
        """(args, kwargs) of the model call for a batch; `text_index` is
        passed only when present."""
        kwargs = ({"text_index": batch["text_index"]}
                  if "text_index" in batch else {})
        return (batch["input_ids"], self._prep_image(batch["image"]),
                batch.get("attention_mask")), kwargs

    def _forward(self, batch: dict, model_state: Optional[dict] = None,
                 train: bool = False, **kwargs) -> torch.Tensor:
        """The model on a batch, with the buffers of `model_state` in the
        place of its own where a state carries them; a train forward goes
        through the DDP wrapper where there is one."""
        args, model_kwargs = self.model_inputs(batch)
        return forward_with_state(self.ddp if train else None, self.model,
                                  model_state, args, {**model_kwargs, **kwargs})

    def dropout_generator(self, step: int) -> torch.Generator:
        return step_generator(self.model, self.seed, step)

    def _loss(self, batch: dict, step: int = 0, model_state: Optional[dict] = None,
              stats_updates: Optional[dict] = None,
              generator: Optional[torch.Generator] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss, logits) of a train step (dropout on, masks of `step`, or
        of `generator` where one is given); with
        `valid`, padded samples are zeroed on both sides so that they
        contribute a constant (matching) term. With `mutable_collections` the
        buffers are read from `model_state` and the updated ones are put into
        `stats_updates`. With `remat` the towers' layers recompute their
        internals in the backward."""
        mutable = ({"stats_updates": stats_updates}
                   if self.mutable_collections else {})
        if generator is None:
            generator = self.dropout_generator(step)
        with remat_lib.forced(self.remat):
            logits = self._forward(batch, model_state, train=True,
                                   deterministic=False,
                                   generator=generator, **mutable)
        mask = batch["mask"]
        valid = batch.get("valid")
        if valid is not None:
            v = valid.reshape(-1, 1, 1, 1).to(logits.dtype)
            logits = logits * v + (1 - v) * 0.0
            mask = mask * v
        return self.loss_fn(logits, mask, **self.loss_kwargs), logits

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None):
        """One optimizer update on `batch`, or with `accumulate_grad_batches
        = k` one micro-step (its dropout masks and BatchNorm statistics its
        own; the update at every k-th). Returns (new state, {"loss", "dice",
        "iou"}) with the metrics as device tensors; nothing in the step waits
        for the device. With `remat` the towers' layers recompute their
        internals in the backward. `generator` (a captured group's, seeded
        with `step_seed`) stands in for the step's own."""
        opt = state.optimizer
        updates = {}
        with grad_sync(self.ddp, self.accumulate_grad_batches):
            with profiling.span("step.forward"):
                opt.zero_grad()
                bind_reductions(opt, self.ddp, self.model)
                with torch.enable_grad():
                    loss, logits = self._loss(batch, state.step, state.model_state,
                                              updates, generator)
            with profiling.span("step.backward"):
                loss.backward()
        with profiling.span("step.update"):
            opt.step()
            with torch.no_grad():
                # padded samples have zeroed logits -> sigmoid 0.5; `valid`
                # excludes them from the step metrics
                probs = torch.sigmoid(logits.detach().float())
                step_metrics = global_step_metrics(
                    loss.detach(), metrics_lib.update_state(
                        metrics_lib.SegMetricState.zeros(probs.device), probs,
                        batch["mask"], self.threshold, valid=batch.get("valid")))
        model_state = ({**state.model_state, **updates}
                       if self.mutable_collections else state.model_state)
        return TrainState(state.step + 1, opt, model_state), step_metrics

    def compile_steps(self, fsdp: bool = False):
        """(train_step, eval_step, predict_step) under data parallel over
        the process group's ranks, the counterpart of the JAX task's jit over
        its mesh: the model in DistributedDataParallel (the gradient
        all-reduce in the backward; with accumulation the window's mean
        all-reduced at the update), or with `fsdp` sharded by `fully_shard`
        (then `state_fsdp_shardings` gives the state its optimizer over the
        shards). The steps stay eager; each rank passes its own rows. Under a
        rank grid with a model axis (`parallel/mesh.py`) both run over the
        data group, and the ranks of one model group pass the same rows."""
        if fsdp:
            data_parallel.shard(self.model)
        elif self.ddp is None and not data_parallel.is_sharded(self.model):
            self.ddp = data_parallel.ddp(self.model)
        return self.train_step, self.eval_step, self.predict_step

    def state_fsdp_shardings(self, state: TrainState) -> TrainState:
        """`state` with the model sharded (`fully_shard`) and the optimizer
        built anew over the shards, so that AdamW's moments hold 1/world of
        each leaf per rank (the JAX task's FSDP placement of its state). The
        optimizer must not have stepped yet; a resume restores into the
        sharded state afterwards (`CheckpointManager.restore`)."""
        data_parallel.shard(self.model)
        opt = state.optimizer
        if opt.optimizer.state or opt.mini_step:
            raise ValueError("state_fsdp_shardings: shard a fresh state (the "
                             "optimizer has state already); restore a "
                             "checkpoint into the sharded one instead")
        new = self.make_optimizer()
        optim_lib.set_learning_rate(new, optim_lib.get_learning_rate(opt))
        return dataclasses.replace(state, optimizer=new)

    def compile_train_multistep(self, num_steps: int):
        """`multi(state, batches) -> (state, metrics)`: `num_steps` train
        steps over batches stacked on a leading (num_steps, B, ...) axis,
        the metrics averaged over the steps (the JAX task's `lax.scan`
        program). On a CUDA device one captured CUDA graph of the steps
        (`training/graphs.py`); on the CPU, and for a model that
        `compile_steps` wrapped for data parallel, the eager steps."""
        return graphs.compile_multistep(self, num_steps)

    @torch.no_grad()
    def predict_step(self, batch: dict,
                     state: Optional[TrainState] = None) -> torch.Tensor:
        """Sigmoid probabilities (B, 1, H, W) in f32, with the buffers of
        `state.model_state` where a state is given and carries them."""
        model_state = state.model_state if state is not None else None
        return torch.sigmoid(self._forward(batch, model_state).float())

    @torch.no_grad()
    def eval_step(self, metric_state: metrics_lib.SegMetricState, batch: dict,
                  state: Optional[TrainState] = None):
        """Returns (updated metric state, {"loss_sum", "n"}); samples with
        valid == 0 contribute a constant loss term and no metric counts. The
        buffers are those of `state.model_state` where a state carries them."""
        logits = self._forward(batch, state.model_state if state is not None
                               else None)
        mask = batch["mask"]
        valid = batch.get("valid")
        probs = torch.sigmoid(logits.float())
        if valid is not None:
            vv = valid.reshape(-1, 1, 1, 1).to(logits.dtype)
            loss = self.loss_fn(logits * vv, mask * vv, **self.loss_kwargs)
            n = valid.float().sum()
        else:
            loss = self.loss_fn(logits, mask, **self.loss_kwargs)
            n = torch.tensor(float(mask.shape[0]), device=mask.device)
        new_state = metrics_lib.update_state(metric_state, probs, mask,
                                             self.threshold, valid=valid)
        return new_state, {"loss_sum": loss * n, "n": n}

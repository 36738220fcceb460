"""DenseCLIP training: the train and eval steps of the mmseg recipe.

Counterpart of `tunevlseg_tpu/training/denseclip_task.py`. The recipe of
denseclip_fpn_res50_512x512_80k.py:

  * AdamW lr 1e-4, weight decay 1e-4, in four parameter groups: backbone /
    base x decay / no_decay, the backbone at lr x `backbone_lr_mult` (0.1);
    the decay labels are the port's `decay_labels` (Dense, convolution and
    transposed-convolution weights decay; biases, norms, embeddings and bare
    parameters such as `contexts`, `gamma`, the positional embeddings, the
    ViT's `proj` and `text_projection` do not), which equal the JAX
    package's `_group_label` leaf by leaf;
  * the text encoder (lr_mult 0.0 in the reference) is frozen
    (`requires_grad=False`) and holds no optimizer state; the context
    vectors still take their gradient through it;
  * mmcv's poly schedule (power 0.9, min_lr 1e-6) with a linear warm-up,
    set on the host into every group before each step (the learning rate
    of optimizer update u is `schedule(u)`, as optax's count starts at 0;
    with `accumulate_grad_batches = k` update u is micro-step
    `step // k`'s, as the JAX schedule counts updates under MultiSteps);
  * the loss: decode CE + 0.4 x the identity head's CE
    (`models/denseclip/loss.py`).

Batch contract: {"image": (B, 3, H, W) f32 (normalised) or uint8, "label":
(B, H, W) int with 255 = ignore}. uint8 images are normalised on the device
with `image_stats` where it is set.

With a `bn_train` model the backbone's BatchNorms use batch statistics in a
train step and the running statistics live in `TrainState.model_state`
(`init` copies them out of the model; a step reads them from the state and
returns a state with the updated ones; `eval_step` reads them from the
state), as the e2e CRIS task does. No buffer of the module is written by a
step. Dropout (the head's Dropout2d, the ViT's DropPath) draws its masks from
a generator seeded from (`seed`, step).

`accumulate_grad_batches = k` makes a train step a micro-step, with the
MultiSteps semantics of `optim.ClippedOptimizer`. `remat=True` runs the
loss under one `torch.utils.checkpoint` (the JAX task's `jax.checkpoint` of
its loss): the backward recomputes the whole forward, with the forward's
dropout masks (`nn/remat.checkpoint` restores the generator) and without
writing the BatchNorm statistics a second time. `compile_train_multistep(k)`
runs k steps as one captured CUDA graph and averages their metrics, the
port's steps-per-execution (`training/graphs.py`).

Data parallel over a process group (`parallel/distributed.py`):
`compile_steps` puts the model under DistributedDataParallel (or shards it
with `fully_shard`; `state_fsdp_shardings` then builds the optimizer over
the shards), the counterpart of the JAX task's jit over its mesh. Each
rank passes its own rows. The cross-entropy divides by every pixel of the
local batch, ignored ones included (mmseg's `avg_non_ignore=False`), so
with equal local batches DDP's mean of the ranks' gradients is the global
batch's; the pixel accuracy divides by the non-ignored pixels, so a step's
and an eval's accuracy is computed from the ranks' summed counts. The
`bn_train` statistics are the global batch's
(`parallel/data_parallel.synced_batch_norm`), as the JAX BatchNorm's over a
batch sharded on its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from tunevlseg_torch.models.denseclip.loss import (IGNORE_INDEX,
                                                   cross_entropy_seg,
                                                   denseclip_losses)
from tunevlseg_torch.nn import remat as remat_lib
from tunevlseg_torch.ops.image import normalize_uint8
from tunevlseg_torch.parallel import data_parallel, distributed
from tunevlseg_torch.training import graphs
from tunevlseg_torch.training import optim as optim_lib
from tunevlseg_torch.training.task import (TrainState, bind_reductions,
                                           forward_with_state, grad_sync,
                                           load_partial_state, step_generator)
from tunevlseg_torch.utils import profiling


def poly_warmup_schedule(base_lr: float, total_iters: int, power: float = 0.9,
                         min_lr: float = 1e-6, warmup_iters: int = 1500,
                         warmup_ratio: float = 1e-6) -> Callable[[int], float]:
    """mmcv's PolyLrUpdater with a linear warm-up: the poly learning rate
    (base_lr - min_lr) * (1 - step / total_iters) ** power + min_lr (the
    fraction clipped to [0, 1]), scaled during warm-up by
    1 - (1 - step / warmup_iters) * (1 - warmup_ratio)."""

    def fn(step: int) -> float:
        s = float(step)
        frac = min(max(s / total_iters, 0.0), 1.0)
        regular = (base_lr - min_lr) * (1.0 - frac) ** power + min_lr
        if s < warmup_iters:
            return regular * (1.0 - (1.0 - s / warmup_iters) * (1.0 - warmup_ratio))
        return regular

    return fn


def group_labels(model: nn.Module) -> dict[str, str]:
    """{parameter name: "backbone_decay" | "backbone_no_decay" | "base_decay"
    | "base_no_decay"} for every parameter of `model`."""
    return {name: ("backbone" if name.startswith("backbone.") else "base")
            + "_" + label for name, label in optim_lib.decay_labels(model).items()}


def make_denseclip_optimizer(model: nn.Module, base_lr: float,
                             weight_decay: float, backbone_lr_mult: float = 0.1,
                             grad_clip_norm: Optional[float] = None,
                             accumulate_steps: int = 1
                             ) -> optim_lib.ClippedOptimizer:
    """AdamW over the trainable parameters in the four paramwise groups;
    each group keeps its `lr_mult` beside its learning rate."""
    labels = group_labels(model)
    groups = []
    for group in ("backbone_decay", "backbone_no_decay", "base_decay",
                  "base_no_decay"):
        params = [p for n, p in model.named_parameters()
                  if p.requires_grad and labels[n] == group]
        if params:
            mult = backbone_lr_mult if group.startswith("backbone") else 1.0
            groups.append({"params": params, "name": group, "lr_mult": mult,
                           "lr": base_lr * mult,
                           "weight_decay": (0.0 if group.endswith("no_decay")
                                            else weight_decay)})
    opt = optim_lib.on_device_lr(torch.optim.AdamW(
        groups, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=optim_lib.on_cuda(p for g in groups for p in g["params"])))
    return optim_lib.ClippedOptimizer(opt, grad_clip_norm, accumulate_steps)


def pixel_counts(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = IGNORE_INDEX) -> dict:
    """{"correct": non-ignored pixels whose argmax class is the label,
    "valid": non-ignored pixels}."""
    pred = logits.float().argmax(dim=1)
    valid = labels != ignore_index
    return {"correct": (valid & (pred == labels)).sum(), "valid": valid.sum()}


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """mmseg's aAcc: the share of the non-ignored pixels whose argmax class is
    the label; over every rank's pixels under data parallel."""
    counts = distributed.all_reduce_sum(pixel_counts(logits, labels,
                                                     ignore_index))
    return counts["correct"] / counts["valid"].clamp(min=1)


def mean_over_ranks(metrics: dict) -> dict:
    """Each scalar's mean over the ranks (losses of equal local batches)."""
    world = distributed.data_size()
    return {k: v / world for k, v in distributed.all_reduce_sum(metrics).items()}


@dataclasses.dataclass
class DenseCLIPTask:
    model: nn.Module                    # models.denseclip.model.DenseCLIP
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    backbone_lr_mult: float = 0.1
    total_iters: int = 80_000
    warmup_iters: int = 1500
    warmup_ratio: float = 1e-6
    power: float = 0.9
    min_lr: float = 1e-6
    grad_clip_norm: Optional[float] = None
    accumulate_grad_batches: int = 1
    remat: bool = False
    # (mean, std) for the device-side normalisation of uint8 batches; None
    # means images arrive as normalised floats
    image_stats: Optional[tuple] = None
    seed: int = 0     # of the dropout masks, with the step

    def __post_init__(self):
        optim_lib.accumulate_steps_of(self.accumulate_grad_batches)
        self.schedule = poly_warmup_schedule(
            self.learning_rate, self.total_iters, self.power, self.min_lr,
            self.warmup_iters, self.warmup_ratio)
        self.mutable_collections = (("batch_stats",)
                                    if getattr(self.model, "bn_train", False) else ())
        # the DistributedDataParallel wrapper `compile_steps` builds
        self.ddp: Optional[nn.Module] = None

    # -- init ---------------------------------------------------------------

    def init(self, params: Optional[dict] = None) -> TrainState:
        """Freeze the text encoder, build the optimizer over the rest and,
        for a `bn_train` model, copy the BatchNorm running statistics into
        the state. `params` (a partial `state_dict`, say converted weights)
        is overlaid on the model's weights first (`load_partial_state`)."""
        if params is not None:
            load_partial_state(self.model, params)
        for name, p in self.model.named_parameters():
            p.requires_grad_(not name.startswith("text_encoder."))
        model_state = {}
        if self.mutable_collections:
            persistent = self.model.state_dict()
            model_state = {n: b.detach().clone()
                           for n, b in self.model.named_buffers() if n in persistent}
        return TrainState(0, self.make_optimizer(), model_state)

    def make_optimizer(self) -> optim_lib.ClippedOptimizer:
        """The four-group AdamW over the trainable parameters as they are now
        (FSDP's DTensors once the model is sharded)."""
        return make_denseclip_optimizer(
            self.model, self.schedule(0), self.weight_decay,
            self.backbone_lr_mult, self.grad_clip_norm,
            self.accumulate_grad_batches)

    # -- steps --------------------------------------------------------------

    def _prep_image(self, image: torch.Tensor) -> torch.Tensor:
        if image.dtype != torch.uint8 or self.image_stats is None:
            return image
        return normalize_uint8(image, self.image_stats)

    def _forward(self, image: torch.Tensor, model_state: Optional[dict],
                 train: bool = False, **kwargs):
        return forward_with_state(self.ddp if train else None, self.model,
                                  model_state, (image,), kwargs)

    def _loss(self, batch: dict, step: int, model_state: dict, updates: dict,
              generator: Optional[torch.Generator] = None):
        """(losses, logits) of a train step: dropout on with the masks of
        `step` (or of `generator`), batch statistics for a `bn_train` model
        (the new running statistics go into `updates`). With `remat` under
        one checkpoint, whose recompute draws the same masks and writes its
        statistics nowhere."""
        if generator is None:
            generator = step_generator(self.model, self.seed, step)
        runs = 0

        def loss_of(image):
            nonlocal runs
            runs += 1
            logits, score_map = self._forward(
                image, model_state, train=True, deterministic=False,
                with_score_map=True,
                generator=generator, stats_updates=updates if runs == 1 else {})
            c = self.model.config
            return denseclip_losses(logits, score_map, batch["label"], tau=c.tau,
                                    identity_weight=c.identity_weight), logits

        image = self._prep_image(batch["image"])
        if self.remat:
            return remat_lib.checkpoint(loss_of, image, generator=generator)
        return loss_of(image)

    def learning_rates(self, optimizer: optim_lib.ClippedOptimizer,
                       step: int) -> list[float]:
        """Each group's learning rate for micro-step `step`: schedule(u) x
        lr_mult, u = step // accumulate_grad_batches the optimizer update
        that step belongs to."""
        lr = self.schedule(step // self.accumulate_grad_batches)
        return [lr * group["lr_mult"] for group in optimizer.param_groups]

    def set_learning_rate(self, optimizer: optim_lib.ClippedOptimizer,
                          step: int) -> None:
        for group, lr in zip(optimizer.param_groups,
                             self.learning_rates(optimizer, step)):
            optim_lib.set_group_lr(group, lr)

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   learning_rates: Optional[torch.Tensor] = None):
        """One optimizer update, or one micro-step of `accumulate_grad_batches`
        (the update at every k-th). Returns (new state, {"loss", "loss_decode",
        "loss_aux_identity", "acc"}) with the metrics as device tensors.
        A captured group passes its step's `generator` (seeded with
        `step_seed`) and `learning_rates`, a device row of the groups'
        rates that it fills before each replay."""
        opt = state.optimizer
        updates = {}
        with grad_sync(self.ddp, self.accumulate_grad_batches):
            with profiling.span("step.forward"):
                if learning_rates is None:
                    self.set_learning_rate(opt, state.step)
                else:
                    for j, group in enumerate(opt.param_groups):
                        group["lr"].copy_(learning_rates[j])
                opt.zero_grad()
                bind_reductions(opt, self.ddp, self.model)
                with torch.enable_grad():
                    losses, logits = self._loss(batch, state.step, state.model_state,
                                                updates, generator)
            with profiling.span("step.backward"):
                losses["loss"].backward()
        with profiling.span("step.update"):
            opt.step()
            with torch.no_grad():
                metrics = mean_over_ranks({k: v.detach() for k, v in losses.items()})
                metrics["acc"] = pixel_accuracy(logits.detach(), batch["label"])
        model_state = ({**state.model_state, **updates}
                       if self.mutable_collections else state.model_state)
        return TrainState(state.step + 1, opt, model_state), metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict) -> dict:
        """{"loss", "acc"} of a forward without dropout, with the running
        statistics of `state.model_state`."""
        logits = self._forward(self._prep_image(batch["image"]), state.model_state)
        return {**mean_over_ranks({"loss": cross_entropy_seg(logits,
                                                             batch["label"])}),
                "acc": pixel_accuracy(logits, batch["label"])}

    def compile_train_multistep(self, num_steps: int):
        """`multi(state, batches) -> (state, metrics)`: `num_steps` train
        steps over batches stacked on a leading (num_steps, B, ...) axis,
        the metrics averaged over the steps; on a CUDA device one captured
        CUDA graph, each step at its own learning rate and with its own
        masks (`training/graphs.py`); on the CPU and under data parallel
        the eager steps."""
        return graphs.compile_multistep(self, num_steps)

    def compile_steps(self, fsdp: bool = False):
        """(train_step, eval_step) under data parallel over the process
        group's ranks (the JAX task's jit over its mesh): the model in
        DistributedDataParallel, or sharded by `fully_shard` with `fsdp`
        (then `state_fsdp_shardings` builds the state's optimizer over the
        shards)."""
        if fsdp:
            data_parallel.shard(self.model)
        elif self.ddp is None and not data_parallel.is_sharded(self.model):
            self.ddp = data_parallel.ddp(self.model)
        return self.train_step, self.eval_step

    def state_fsdp_shardings(self, state: TrainState) -> TrainState:
        """`state` with the model sharded (`fully_shard`: the backbone, the
        text encoder and the heads, parameters and AdamW moments 1/world a
        rank) and the optimizer built anew over the shards; the optimizer
        must not have stepped yet."""
        data_parallel.shard(self.model)
        if state.optimizer.optimizer.state or state.optimizer.mini_step:
            raise ValueError("state_fsdp_shardings: shard a fresh state (the "
                             "optimizer has state already)")
        return dataclasses.replace(state, optimizer=self.make_optimizer())

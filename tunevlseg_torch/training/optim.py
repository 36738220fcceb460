"""Optimizer construction: the trainable/frozen partition, the decay and
no-decay groups, and the host-side learning-rate schedulers.

Counterpart of `tunevlseg_tpu/training/optim.py`:
  * `FreezeSpec`: the learnability flags (freeze_all / freeze_encoder /
    freeze_decoder / no_freeze_last_layer / use_new_last_layer, plus the
    always-trainable context learner). `path_trainable` is a pure function
    of a JAX-style parameter path, the same for all three model families;
  * the GPT-style decay split: Dense and convolution weights and the vision
    patch projection decay; biases, embedding tables, norm weights and bare
    parameters do not;
  * AdamW (decoupled decay, torch semantics) or SGD with momentum, with a
    global-norm clip in front, and a learning rate that can be changed
    between steps; optax.MultiSteps' gradient accumulation. On a CUDA
    device AdamW is `capturable` and each group's learning rate is a device
    tensor that `set_learning_rate` writes in place, so that a captured
    group of steps (`training/graphs.py`) reads the rate of the moment;
  * `ReduceLROnPlateau` and `CosineAnnealingLR`, driven from the host.

Frozen parameters get `requires_grad=False`: autograd builds no graph for
them and the optimizer holds no state for them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from tunevlseg_torch.nn.conv import Conv2d, ConvTranspose2d
from tunevlseg_torch.nn.layers import Dense
from tunevlseg_torch.parallel import data_parallel


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FreezeSpec:
    """Which parameters train."""

    freeze_all: bool = True
    freeze_encoder: bool = False
    freeze_decoder: bool = False
    no_freeze_last_layer: bool = False
    use_new_last_layer: bool = False
    complex_head: bool = False
    family: str = "clipseg"  # "clipseg" | "cris" | "trans_segmentor"
    always_trainable: tuple = ()  # top-level param keys trained regardless

    def _last_layer_paths(self) -> tuple[tuple[str, ...], ...]:
        if self.family == "cris":
            # unfreeze proj.txt + proj.vis[-1]
            return (("proj", "txt"), ("proj", "vis_4"))
        return ((("decoder", "head_up2") if self.complex_head
                 else ("decoder", "head_up")),)

    def path_trainable(self, path: tuple[str, ...]) -> bool:
        top = path[0]
        if top == "learner" or top in self.always_trainable:
            return True
        if self.family == "trans_segmentor":
            # encoders (+ pretrained projections) gate on freeze_encoder;
            # decoder/upsampler always train
            if top in ("text_model", "vision_model", "text_projection",
                       "visual_projection"):
                return not self.freeze_encoder
            return True
        if top in ("additive_head", "additive_conv1", "additive_conv2",
                   "residual_ratio"):
            # exist only when use_new_last_layer; trainable then
            return True
        if self.freeze_all:
            if self.no_freeze_last_layer and not self.use_new_last_layer:
                return any(path[:len(p)] == p
                           for p in self._last_layer_paths())
            return False
        if self.family == "cris":
            # CRIS e2e: backbone frozen by freeze_encoder; head trains
            if top in ("visual", "text"):
                return not self.freeze_encoder
            return True
        if top == "decoder":
            return not self.freeze_decoder
        return not self.freeze_encoder  # towers + projections ("clip")


def param_path(name: str) -> tuple[str, ...]:
    """A port parameter name as the JAX-style path `FreezeSpec` reads:
    'decoder.layers.2.mlp.fc1.weight' -> ('decoder', 'layers_2', 'mlp',
    'fc1', 'weight')."""
    path: list[str] = []
    for part in name.split("."):
        if part.isdigit() and path:
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(part)
    return tuple(path)


def apply_freeze(model: nn.Module, spec: FreezeSpec) -> list[str]:
    """Set `requires_grad` on every parameter of `model` as `spec` says;
    returns the names of the trainable ones."""
    trainable = []
    for name, p in model.named_parameters():
        keep = spec.path_trainable(param_path(name))
        p.requires_grad_(keep)
        if keep:
            trainable.append(name)
    return trainable


def count_params(params: Iterable[torch.Tensor]) -> int:
    return sum(p.numel() for p in params if p is not None)


# ---------------------------------------------------------------------------
# decay / no-decay groups
# ---------------------------------------------------------------------------

def decay_label(module: nn.Module, leaf: str) -> str:
    """'decay' or 'no_decay' for the parameter `leaf` that `module` owns.

    The label goes by the owning module's type, since Dense, LayerNorm,
    BatchNorm and Embed all call their parameter `weight` here: Dense,
    Conv2d and ConvTranspose2d weights and the vision tower's `patch_proj`
    (a convolution in the reference) decay; biases, LayerNorm, BatchNorm and
    Embed weights and bare parameters (class/position embeddings, the text
    projection, context vectors, residual_ratio) do not."""
    if leaf == "patch_proj" or (leaf == "weight" and isinstance(
            module, (Dense, Conv2d, ConvTranspose2d))):
        return "decay"
    return "no_decay"


def decay_labels(model: nn.Module) -> dict[str, str]:
    """{parameter name: 'decay' | 'no_decay'} for every parameter of `model`."""
    return {f"{prefix}.{leaf}" if prefix else leaf: decay_label(module, leaf)
            for prefix, module in model.named_modules()
            for leaf, _ in module.named_parameters(recurse=False)}


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place by max_norm / max(norm, max_norm), norm the
    global l2 norm (optax.clip_by_global_norm; torch's clip_grad_norm_ adds
    1e-6 to the norm instead), over every rank's shard where the gradients
    are FSDP's DTensors. No host sync."""
    if not grads:
        return
    norm = data_parallel.global_norm(grads)
    factor = max_norm / torch.clamp(norm, min=max_norm)
    data_parallel.scale_(grads, factor)


def accumulate_steps_of(k) -> int:
    """`k` as a number of micro-steps a window: a whole number >= 1."""
    if isinstance(k, bool) or int(k) != k or k < 1:
        raise ValueError(f"accumulate_grad_batches {k!r}: a whole number of "
                         "micro-steps, at least 1")
    return int(k)


class ClippedOptimizer:
    """A torch optimizer with the global-norm clip in front of it, over the
    trainable parameters of one model. `step()` clips the gradients that are
    there and applies the update; a trainable parameter that nothing read
    has no gradient and keeps its value.

    With `accumulate_steps = k > 1` it has optax.MultiSteps' semantics
    (Lightning's `accumulate_grad_batches`): each `step()` is a micro-step
    that folds the gradients into a running mean, acc += (g - acc) / (n + 1)
    (a parameter without a gradient in a micro-step counts as zero), and
    only every k-th clips the mean and applies one update, then clears the
    mean. The other micro-steps move neither the weights nor the
    optimizer's moments and step count. The mean and the micro-step count
    are `accumulation_state()`, which a checkpoint saves beside the torch
    optimizer's state dict.

    Under DistributedDataParallel the micro-steps run without a gradient
    all-reduce (`no_sync`), each rank folding its own gradients into its
    own mean, and `reduce_window` (the mean over the ranks) makes the mean
    global once, at the update, before the clip. Under FSDP every
    micro-step's gradient is reduced already, and the mean is kept as the
    parameters' DTensor shards."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 grad_clip_norm: Optional[float] = None,
                 accumulate_steps: int = 1):
        self.optimizer = optimizer
        self.grad_clip_norm = grad_clip_norm
        self.accumulate_steps = accumulate_steps_of(accumulate_steps)
        self.mini_step = 0
        # {index in params(): running mean of the micro-steps' gradients}
        self.accumulated: dict[int, torch.Tensor] = {}
        # in place over the window's tensors, at the update (DDP: the mean
        # over the ranks); None leaves the window as it is
        self.reduce_window: Optional[Callable[[list], None]] = None
        # at every (micro-)step, before anything reads the gradients (FSDP:
        # the mean over the ranks of the parameters it leaves whole)
        self.reduce_grads: Optional[Callable[[], None]] = None

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def params(self) -> list[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The torch optimizer's state dict, each group's learning rate a
        float (as a checkpoint has always held it)."""
        saved = self.optimizer.state_dict()
        return {**saved, "param_groups": [
            {**g, "lr": float(g["lr"])} for g in saved["param_groups"]]}

    def load_state_dict(self, saved: dict) -> None:
        """Load a state dict into the torch optimizer, keeping this
        optimizer's placement: whether AdamW is capturable (its step counts
        on the device) and the learning-rate tensors, which take the saved
        values in place."""
        own = [(g["lr"], g.get("capturable")) for g in self.param_groups]
        self.optimizer.load_state_dict({**saved, "param_groups": [
            {**sg, "capturable": bool(capturable)} if capturable is not None else sg
            for (_, capturable), sg in zip(own, saved["param_groups"], strict=True)]})
        for group, (lr, _) in zip(self.param_groups, own):
            loaded = float(group["lr"])
            group["lr"] = lr
            set_group_lr(group, loaded)

    def _update(self) -> None:
        if self.grad_clip_norm is not None:
            clip_by_global_norm_(
                [p.grad for p in self.params() if p.grad is not None],
                self.grad_clip_norm)
        self.optimizer.step()

    def step(self) -> bool:
        """One (micro-)step; returns whether the weights were updated."""
        if self.reduce_grads is not None:
            with torch.no_grad():
                self.reduce_grads()
        if self.accumulate_steps == 1:
            self._update()
            return True
        n = self.mini_step
        params = self.params()
        with torch.no_grad():
            for i, p in enumerate(params):
                acc = self.accumulated.get(i)
                if p.grad is not None:
                    g = p.grad.to(p.dtype)
                    self.accumulated[i] = (g / (n + 1) if acc is None
                                           else acc + (g - acc) / (n + 1))
                elif acc is not None:
                    acc.sub_(acc / (n + 1))
        self.mini_step = n + 1
        if self.mini_step < self.accumulate_steps:
            return False
        if self.reduce_window is not None:
            with torch.no_grad():
                self.reduce_window([self.accumulated[i]
                                    for i in sorted(self.accumulated)])
        for i, p in enumerate(params):
            # a parameter that no micro-step of the window reached keeps
            # no gradient, as without accumulation
            p.grad = self.accumulated.get(i)
        self._update()
        self.accumulated = {}
        self.mini_step = 0
        self.zero_grad()
        return True

    def accumulation_state(self) -> dict:
        """The micro-step count and the running mean (by index in
        `params()`)."""
        return {"mini_step": self.mini_step, "accumulated": dict(self.accumulated)}

    def load_accumulation_state(self, state: dict) -> None:
        params = self.params()
        self.mini_step = int(state["mini_step"])
        self.accumulated = {
            int(i): data_parallel.to_placement(t, params[int(i)])
            for i, t in state["accumulated"].items()}


def make_optimizer(
    model: nn.Module,
    learning_rate: float,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    optimizer: str = "adamw",
    grad_clip_norm: Optional[float] = None,
    accumulate_steps: int = 1,
) -> ClippedOptimizer:
    """AdamW over the parameters of `model` that require a gradient, with the
    two-group decay policy (`weight_decay <= 0` builds one group), or SGD
    with momentum 0.9; `grad_clip_norm` puts optax's global-norm clip in
    front; `accumulate_steps` > 1 averages that many micro-steps'
    gradients before each update (`ClippedOptimizer`). The learning rate
    lives in the param groups, where `set_learning_rate` changes it between
    steps, mid-window too: the next update uses it. On a CUDA device AdamW
    is `capturable` over learning-rate tensors (`on_device_lr`)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if optimizer == "adamw":
        if weight_decay <= 0:
            groups = [{"params": [p for _, p in named], "weight_decay": 0.0}]
        else:
            labels = decay_labels(model)
            groups = [
                {"params": [p for n, p in named if labels[n] == "decay"],
                 "weight_decay": weight_decay},
                {"params": [p for n, p in named if labels[n] == "no_decay"],
                 "weight_decay": 0.0}]
        opt = on_device_lr(torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=learning_rate,
            betas=(b1, b2), eps=eps, capturable=on_cuda(p for _, p in named)))
    elif optimizer == "sgd":
        opt = torch.optim.SGD([p for _, p in named], lr=learning_rate,
                              momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {optimizer}")
    return ClippedOptimizer(opt, grad_clip_norm, accumulate_steps)


def on_cuda(params: Iterable[torch.Tensor]) -> bool:
    """Whether there are parameters and all of them are on a CUDA device
    (AdamW is capturable there)."""
    devices = [p.device.type for p in params]
    return bool(devices) and all(d == "cuda" for d in devices)


def on_device_lr(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """A capturable optimizer with each group's learning rate as an f32
    tensor on the parameters' device (a CUDA graph reads it where a float
    would be baked into the capture); any other is returned as it is."""
    for group in opt.param_groups:
        if group.get("capturable"):
            group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32,
                                       device=group["params"][0].device)
    return opt


def set_group_lr(group: dict, lr: float) -> None:
    """Set one param group's learning rate: in place where it is a tensor."""
    if isinstance(group["lr"], torch.Tensor):
        group["lr"].fill_(float(lr))
    else:
        group["lr"] = float(lr)


def set_learning_rate(optimizer, lr: float) -> None:
    """Set the learning rate of every param group, in place."""
    for group in optimizer.param_groups:
        set_group_lr(group, lr)


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


# ---------------------------------------------------------------------------
# host-side schedulers
# ---------------------------------------------------------------------------

class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (the reference's
    default scheduler, monitor val_loss, interval epoch)."""

    def __init__(self, factor: float = 0.2, patience: int = 5,
                 mode: str = "min", threshold: float = 1e-4,
                 threshold_mode: str = "rel", min_lr: float = 0.0,
                 cooldown: int = 0):
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float, best: float) -> bool:
        # torch rel mode is multiplicative on the SIGNED best: min compares
        # against best*(1-threshold), max against best*(1+threshold), which
        # differs from best -/+ threshold*abs(best) when best < 0
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return current < best * (1.0 - self.threshold)
            return current > best * (1.0 + self.threshold)
        if self.mode == "min":
            return current < best - self.threshold
        return current > best + self.threshold

    def step(self, metric: float, current_lr: float) -> float:
        """Feed the monitored metric; returns the (possibly reduced) lr."""
        if self.best is None or self._is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            return max(current_lr * self.factor, self.min_lr)
        return current_lr


class CosineAnnealingLR:
    """torch CosineAnnealingLR (per-step when interval='step')."""

    def __init__(self, base_lr: float, t_max: float, eta_min: float = 0.0):
        self.base_lr = base_lr
        self.t_max = t_max
        self.eta_min = eta_min

    def lr_at(self, step: int) -> float:
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * step / self.t_max))


SCHEDULER_REGISTRY = {
    "plateau": ReduceLROnPlateau,
    "cosine": CosineAnnealingLR,
    "none": None,
}

"""The model under data parallel: DistributedDataParallel, fully_shard, and
what the optimizer, the checkpoints and the BatchNorms need around them.

  * `ddp(model)`: `DistributedDataParallel` on the rank's device, buffers
    not broadcast (the BatchNorm statistics live in the train state, and
    every rank holds the same ones). `find_unused_parameters` only where
    the model names trainable parameters its forward never reads
    (`unused_parameters()`: CLIPSeg's `residual_ratio` under CoOp, CoCoOp
    and VPT, whose additive head is skipped or unscaled; the
    TransformerSegmentor's CLIP `vision_model.post_layernorm`, which only
    the unread pooled output passes through);
  * `shard(model)`: FSDP2's `fully_shard` on every block of the towers (the
    elements of the model's `nn.ModuleList`s, outermost first found) and
    then on the root, trainable and frozen parameters alike: the JAX
    package's `fsdp_shardings` over the parameters, the Adam moments and
    the frozen towers. Each parameter becomes a DTensor holding 1/world of
    dim 0 on each rank; a module's forward sees the gathered plain tensors;
  * `mean_over_ranks_`, `global_norm`, `scale_`: the gradient arithmetic
    that must see every rank (the accumulated mean's all-reduce under DDP,
    the clip's norm over DTensor shards);
  * `full_tensor` / `to_placement`: a checkpoint holds full tensors whatever
    wrote it, and a restore lays them out as the live parameter is laid out;
  * `summed_over_ranks`, `synced_batch_norm`: sums and batch statistics
    over the global batch, as the JAX package computes them on a batch
    sharded over the mesh (the batch dice's sums, the BatchNorms).

Under a rank grid with a model axis (`parallel/mesh.py`) all of it runs over
the data group (`distributed.data_group()`): DDP keeps the ranks of one
model rank in step, `fully_shard` shards over them and leaves the slices of
tensor parallelism as they are (the JAX `fsdp_specs(base_specs=)`: a leaf
the tp rules shard keeps that spec, FSDP fills the rest), and the means,
norms and statistics count each sample once.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist
from torch import nn

from tunevlseg_torch.parallel import distributed
from tunevlseg_torch.parallel.mesh import fsdp_device_mesh
from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def require_group(what: str) -> None:
    if not distributed.is_initialized():
        raise ValueError(
            f"{what} needs a process group: run through the train CLI "
            "(trainer.n_devices / trainer.multihost / torchrun) or call "
            "tunevlseg_torch.parallel.distributed.initialize_distributed first")


def unused_parameters(model: nn.Module) -> list[str]:
    """Names of the model's trainable parameters that its forward never
    reads (the model's own `unused_parameters()`, where it has one)."""
    names = getattr(model, "unused_parameters", lambda: [])()
    params = dict(model.named_parameters())
    return [n for n in names if n in params and params[n].requires_grad]


def ddp(model: nn.Module) -> nn.Module:
    """`model` under DistributedDataParallel on its device."""
    require_group("DistributedDataParallel")
    from torch.nn.parallel import DistributedDataParallel
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        process_group=distributed.data_group(), broadcast_buffers=False,
        find_unused_parameters=bool(unused_parameters(model)))


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def shard_units(model: nn.Module) -> list[nn.Module]:
    """The blocks `shard` wraps before the root: every element of an
    `nn.ModuleList` of the model that holds parameters and lies inside no
    other such element."""
    units: list[nn.Module] = []
    inside: set[int] = set()
    for module in model.modules():
        if id(module) in inside or not isinstance(module, nn.ModuleList):
            continue
        for block in module:
            if any(True for _ in block.parameters()):
                units.append(block)
                inside.update(id(m) for m in block.modules())
    return units


def shard(model: nn.Module) -> nn.Module:
    """`fully_shard` on each block of `shard_units`, then on the root, in
    place (a sharded model is returned as it is). Scalar parameters, which
    FSDP cannot shard (CLIPSeg's `residual_ratio`), stay whole on every
    rank, as the JAX FSDP rules replicate scalars; `replicated_gradients`
    averages their gradients. Under a model axis the shards are over the
    data group, and the tensor-parallel slices (`model.tp_plan`) keep their
    slice."""
    require_group("fully_shard")
    if is_sharded(model):
        return model
    from torch.distributed.fsdp import fully_shard
    device = next(model.parameters()).device
    mesh = fsdp_device_mesh(distributed.mesh(), device.type)
    params = dict(model.named_parameters())
    kept = {params[n] for n in getattr(model, "tp_plan", None) or {}}
    for p in model.parameters():
        # FSDP shards contiguous storage only: weights kept channels-last
        # for cuDNN (CRIS's and DenseCLIP's backbones) go back to NCHW, and
        # the gathered weights, and so the activations, are NCHW there
        if not p.is_contiguous():
            p.data = p.data.contiguous()
    scalars = {p for p in model.parameters() if p.dim() == 0}
    ignored = scalars | kept
    for block in shard_units(model):
        fully_shard(block, mesh=mesh, ignored_params=ignored)
    fully_shard(model, mesh=mesh, ignored_params=ignored)
    if kept:
        log.info("fsdp shard report (data axis %d): %d parameters sharded, %d "
                 "scalars whole, %d kept their tensor-parallel slice",
                 distributed.data_size(),
                 sum(is_dtensor(p) for p in model.parameters()), len(scalars),
                 len(kept))
    return model


def replicated_gradients(model: nn.Module):
    """For a sharded model: a function that replaces the gradient of each
    trainable parameter FSDP left whole by its mean over the ranks (FSDP
    reduces the others itself), or None when there is none."""
    whole = [p for p in model.parameters()
             if p.requires_grad and not is_dtensor(p)]
    if not whole:
        return None

    def reduce() -> None:
        mean_over_ranks_([p.grad for p in whole if p.grad is not None])
    return reduce


def mean_over_ranks_(tensors: Iterable[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the data group, in place (one
    collective a tensor)."""
    world = distributed.data_size()
    if world == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=distributed.data_group())
        t.div_(world)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The l2 norm of all of `grads` together: for DTensor shards the
    squares of every rank's shard, summed over the ranks."""
    if not any(is_dtensor(g) for g in grads):
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))

    def squares(ts):
        return torch.stack([torch.linalg.vector_norm(t.float()) ** 2
                            for t in ts]).sum() if ts else torch.zeros(())

    sharded = squares([g.to_local() for g in grads if is_dtensor(g)])
    dist.all_reduce(sharded, group=distributed.data_group())
    whole = squares([g for g in grads if not is_dtensor(g)])
    return (sharded + whole.to(sharded.device)).sqrt()


def scale_(grads: list[torch.Tensor], factor: torch.Tensor) -> None:
    """Multiply each gradient by `factor` in place (DTensors by their local
    shard)."""
    local = [g.to_local() if is_dtensor(g) else g for g in grads]
    torch._foreach_mul_(local, factor)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank calls it),
    any other tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def to_placement(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`value` (a full tensor) on `like`'s device and dtype, and laid out as
    `like` when that is a DTensor."""
    if is_dtensor(like):
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(value.to(like.device_mesh.device_type,
                                          like.dtype),
                                 like.device_mesh, like.placements)
    return value.to(device=like.device, dtype=like.dtype, copy=True)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the data group, whose backward is the sum over the data
    group of the gradients (each rank's output feeds that rank's loss)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, group=distributed.data_group())
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=distributed.data_group())
        return grad


def summed_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the data group, differentiable: its backward is
    the sum over the data group of the ranks' gradients, for a sum that
    every rank's loss reads (the batch dice's sums, `ops/losses.py`)."""
    return _AllReduceSum.apply(x)


def synced_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      momentum: float, epsilon: float
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm over channel axis 1 with the statistics of the GLOBAL batch
    (every rank's rows): the mean, then the biased variance, each one
    all-reduce of per-channel sums in f32 that autograd runs back through
    (`summed_over_ranks`), so every rank's input gets the gradient of all
    ranks' losses through the shared statistics; the row count is summed
    with the first. Returns (output in x's dtype, new running mean, new
    running variance with the unbiased variance), as one device's BatchNorm
    over the concatenated batch."""
    all_reduce = summed_over_ranks
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    x32 = x.float()
    count = x32.new_full((1,), float(x.numel() // x.shape[1]))
    sums = all_reduce(torch.cat([x32.sum(dims), count]))
    n = sums[-1].detach()
    mean = sums[:-1] / n
    centred = x32 - mean.reshape(shape)
    var = all_reduce((centred * centred).sum(dims)) / n
    out = centred * torch.rsqrt(var + epsilon).reshape(shape)
    out = (out * weight.reshape(shape) + bias.reshape(shape)).to(x.dtype)
    new_mean = ((1 - momentum) * running_mean.detach()
                + momentum * mean.detach())
    new_var = ((1 - momentum) * running_var.detach()
               + momentum * var.detach() * n / (n - 1).clamp(min=1))
    return out, new_mean, new_var

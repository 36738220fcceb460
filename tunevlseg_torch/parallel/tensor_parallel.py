"""Tensor parallelism of the frozen towers over the model group (Megatron-LM).

The port's counterpart of the JAX package's `model` mesh axis
(`tunevlseg_tpu/parallel/sharding_rules.py`, `ops/spmd.py`). There GSPMD
places the collectives from the parameters' shardings; here they are
explicit, on the model group of `parallel/mesh.py`, and every kernel runs
on plain local tensors:

  * column-parallel `q_proj`, `k_proj`, `v_proj` and `fc1`: each rank holds
    `1 / tp` of the output features (whole heads of the attention, a slice
    of the MLP's hidden layer) and the matching slice of the bias. In front
    of them `copy` (identity forward, all-reduce of the gradient backward):
    each rank's input gradient is its heads' share;
  * row-parallel `out_proj` and `fc2`: each rank holds the matching input
    features; its product is a partial sum, and `reduce` (all-reduce
    forward, identity backward) adds them up. The bias is added once, after
    the reduce;
  * the attention kernels (K1, K2, K3) run on the rank's local heads, at
    `num_heads / tp` heads: `MultiHeadAttention.num_heads` is the local
    count, and a bias with a head dimension is sliced to the rank's heads;
  * an attention whose output projection is no rule's (the CRIS RN50
    attention pool's `c_proj`) gathers its local heads into the whole
    attention output (`gather_whole`) and runs the projection replicated.

With sequence parallelism (`parallel/activation_sharding.py`) the stream
between blocks is each rank's rows: `gather_seq` (all-gather forward,
reduce-scatter of the gradient backward) takes `copy`'s place in front of
the column-parallel products, and `reduce_scatter_seq` (reduce-scatter
forward, all-gather backward) takes `reduce`'s after the row-parallel ones.

`shard_model(model, mesh)` slices the weights of a built and loaded model in
place, by the rules of `parallel/sharding_rules.py` (frozen blocks only),
sets each sharded block's group, and records the plan on the model
(`model.tp_plan`: parameter name -> the sliced dimension), so that a
checkpoint gathers the whole tensors (`full_tensors`) and a restore slices
them again (`local_part`).

The trainable state stays replicated over the model group; before each
update its gradients are averaged over the group (`model.tp_reduce_grads`,
bound by `training/task.bind_reductions`), which keeps the replicas bit for
bit in step where a kernel's summation order differs from run to run.

`COLLECTIVE_BYTES` counts what the collectives moved, by kind, as the bytes
one rank sends in a ring implementation: (tp - 1) / tp of the whole tensor
for an all-gather (its output) and a reduce-scatter (its input), twice that
for an all-reduce. Tensor and sequence parallelism move the same bytes a
block by that count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

# bytes a rank sent, by collective (see the module docstring)
COLLECTIVE_BYTES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def reset_bytes() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


def bytes_moved() -> int:
    return sum(COLLECTIVE_BYTES.values())


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """A rank's model group: its process group, its rank in it and its size."""

    group: Any
    rank: int
    size: int


def _count(kind: str, t: torch.Tensor, g: ModelGroup, factor: int = 1) -> None:
    COLLECTIVE_BYTES[kind] += (factor * t.numel() * t.element_size()
                               * (g.size - 1) // g.size)


def all_reduce(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    out = x.contiguous().clone()
    _count("all_reduce", out, g, 2)
    dist.all_reduce(out, group=g.group)
    return out


def all_gather(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, in rank order."""
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] * g.size, *front.shape[1:]))
    _count("all_gather", out, g)
    dist.all_gather_into_tensor(out, front, group=g.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum over the ranks of `x`."""
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // g.size, *front.shape[1:]))
    _count("reduce_scatter", front, g)
    dist.reduce_scatter_tensor(out, front, group=g.group)
    return out.movedim(0, dim)


def chunk(x: torch.Tensor, g: ModelGroup, dim: int) -> torch.Tensor:
    """This rank's chunk of `x` along `dim` (no collective)."""
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.g), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.g, ctx.dim), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return reduce_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return chunk(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.g, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return chunk(grad, ctx.g, ctx.dim), None, None


def copy(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """Identity; the gradient is summed over the model group (in front of a
    column-parallel product, whose input gradient is a rank's share)."""
    return _Copy.apply(x, g)


def reduce(x: torch.Tensor, g: ModelGroup) -> torch.Tensor:
    """The sum over the model group (after a row-parallel product); the
    gradient passes as it is."""
    return _Reduce.apply(x, g)


def gather_seq(x: torch.Tensor, g: ModelGroup, dim: int = 1) -> torch.Tensor:
    """The ranks' rows concatenated (in front of a column-parallel product
    under sequence parallelism); the gradient is reduce-scattered."""
    return _GatherSeq.apply(x, g, dim)


def reduce_scatter_seq(x: torch.Tensor, g: ModelGroup, dim: int = 1) -> torch.Tensor:
    """This rank's rows of the sum over the model group (after a
    row-parallel product under sequence parallelism); the gradient is
    all-gathered."""
    return _ReduceScatterSeq.apply(x, g, dim)


def split(x: torch.Tensor, g: ModelGroup, dim: int = 1) -> torch.Tensor:
    """This rank's rows of a replicated tensor; the gradient is gathered."""
    return _Split.apply(x, g, dim)


def gather_whole(x: torch.Tensor, g: ModelGroup, dim: int = 1) -> torch.Tensor:
    """The whole tensor from the ranks' parts, for replicated work after it
    (whose gradient every rank holds whole): the gradient's own part comes
    back."""
    return _GatherWhole.apply(x, g, dim)


def row(dense: nn.Module, x: torch.Tensor, g: Optional[ModelGroup],
        seq_sharded: bool = False) -> torch.Tensor:
    """A `Dense` that may be row-parallel: without a group its plain call;
    with one the rank's partial product, summed over the model group
    (reduce-scattered over the rows under sequence parallelism), then the
    bias, once."""
    if g is None:
        return dense(x)
    y = torch.nn.functional.linear(x.to(dense.dtype), dense.weight.to(dense.dtype))
    y = reduce_scatter_seq(y, g) if seq_sharded else reduce(y, g)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


def enter(x: torch.Tensor, g: Optional[ModelGroup],
          seq_sharded: bool = False) -> torch.Tensor:
    """The input of a block's column-parallel products: as it is without a
    group, else through `copy` (gathered over the rows under sequence
    parallelism)."""
    if g is None:
        return x
    return gather_seq(x, g) if seq_sharded else copy(x, g)


def shard_model(model: nn.Module, mesh) -> dict[str, int]:
    """Slice the frozen tensor-parallel blocks of a built and loaded model
    over `mesh`'s model group, in place, by `sharding_rules`' plan; returns
    {parameter name: sliced dimension}, which the model keeps as `tp_plan`.
    A second call, and a mesh without a model axis, change nothing."""
    from tunevlseg_torch.parallel import sharding_rules
    if getattr(model, "tp_plan", None) is not None:
        return model.tp_plan
    if mesh is None or mesh.model_size == 1:
        return {}
    dims, blocks = sharding_rules.plan(model, mesh)
    g = ModelGroup(mesh.model_group, mesh.model_rank, mesh.model_size)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, dim in dims.items():
            p = params[name]
            p.data = chunk(p.data, g, dim).clone()
    for block in blocks:
        block.tp = g
        if hasattr(block, "num_heads"):
            block.num_heads //= g.size
    model.tp_plan = dict(dims)
    model.tp_group = g
    model.tp_reduce_grads = _replicated_gradients(model, g)
    return model.tp_plan


def model_group_of(model: nn.Module) -> Optional[ModelGroup]:
    """The model group the module's blocks were sharded over, or None."""
    for m in model.modules():
        if getattr(m, "tp", None) is not None:
            return m.tp
    return None


def _replicated_gradients(model: nn.Module, g: ModelGroup):
    """A function that replaces the gradient of each trainable parameter of
    the sharded `model` by its mean over the model group (one all-reduce of
    them all), which `shard_model` keeps as `model.tp_reduce_grads` and
    `training/task.bind_reductions` binds to the optimizer. The trainable
    state is replicated over the group and every rank computes the same
    gradient; kernels that add in a run-dependent order (atomics in a cuDNN
    or scatter backward) make the ranks' last bits differ, and the mean,
    which keeps equal gradients as they are, keeps the replicas in step.
    The trainable parameters are listed at the first update, after FSDP
    has put its own in their place."""
    params: list = []

    def reduce() -> None:
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
        if not params:
            params.extend(p for p in model.parameters() if p.requires_grad)
        grads = [p.grad for p in params if p.grad is not None]
        local = [t.to_local() if hasattr(t, "to_local") else t for t in grads]
        if not local:
            return
        flat = all_reduce(_flatten_dense_tensors(local), g).div_(g.size)
        for t, mean in zip(local, _unflatten_dense_tensors(flat, local)):
            t.copy_(mean)
    return reduce


def full_tensors(model: nn.Module, tensors: dict) -> dict:
    """`tensors` (by the model's parameter names) with every tensor-parallel
    slice gathered whole over the model group (a collective: every rank of
    the group calls it with the same names)."""
    plan = getattr(model, "tp_plan", None) or {}
    return {k: (all_gather(v.detach(), model.tp_group, plan[k]) if k in plan else v)
            for k, v in tensors.items()}


def local_part(model: nn.Module, name: str, value: torch.Tensor) -> torch.Tensor:
    """The rank's slice of a whole tensor where the model's plan slices
    `name`, else the tensor as it is."""
    plan = getattr(model, "tp_plan", None) or {}
    if name not in plan:
        return value
    return chunk(value, model.tp_group, plan[name])

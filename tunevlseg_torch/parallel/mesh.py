"""The rank grid: data parallel × tensor parallel over the process group.

The port's counterpart of `tunevlseg_tpu/parallel/mesh.py:make_mesh`. The
JAX package lays its devices out as a `(data, model)` grid, consecutive
devices in one model group; here each device is a rank of the process group
(`parallel/distributed.py`), and the grid is two families of process groups
on those ranks:

  * global rank r is data rank `r // tp` and model rank `r % tp` (the JAX
    `reshape(n // mp, mp)`);
  * the model group of r is its tp peers, ranks `(r // tp) * tp + m`: they
    hold the same rows of each batch and a slice each of the frozen towers
    (`parallel/tensor_parallel.py`);
  * the data group of r is the ranks of the same model rank, `d * tp +
    r % tp`: DDP or `fully_shard`, the metric sums and the synced BatchNorm
    reduce over it (`parallel/distributed.data_group`).

`make_mesh` creates the groups (every rank creates every group, in the same
order, as `torch.distributed.new_group` asks) and makes the grid the one
`distributed.data_rank` / `data_size` / `data_group` read. With tp = 1 the
grid is the process group as it is: the data group is the default group and
there is no model group, so every helper answers as without a grid.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

from tunevlseg_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a `(data, model)` grid and its two groups (None
    for the default group where an axis spans every rank, and for an axis of
    size 1 without a group). A grid with no groups at all (`Mesh(1, tp)`)
    describes a shape: `sharding_rules.tp_param_specs` reads only sizes."""

    data_size: int
    model_size: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The `(world / model_parallel, model_parallel)` grid over the process
    group's ranks (one rank of 1 without a group). A world that
    `model_parallel` does not divide raises a ValueError naming both."""
    world, rank = distributed.world_size(), distributed.rank()
    tp = int(model_parallel)
    if tp < 1 or world % tp:
        raise ValueError(f"{world} ranks not divisible by model_parallel={tp}")
    dp = world // tp
    if tp == 1:
        grid = Mesh(dp, 1, rank, 0)
    else:
        model_groups = [dist.new_group([d * tp + m for m in range(tp)])
                        for d in range(dp)]
        data_groups = [dist.new_group([d * tp + m for d in range(dp)])
                       for m in range(tp)]
        grid = Mesh(dp, tp, rank // tp, rank % tp, data_groups[rank % tp],
                    model_groups[rank // tp])
    distributed.set_mesh(grid)
    return grid


def check(grid: Mesh) -> None:
    """Raise a ValueError unless `grid` is this rank's place in the grid
    `make_mesh(grid.model_size)` builds over the current process group,
    with that grid's groups (a `Trainer` takes its mesh from here)."""
    world, rank = distributed.world_size(), distributed.rank()
    tp = grid.model_size
    want = (world // tp, tp, rank // tp, rank % tp)
    got = (grid.data_size, grid.model_size, grid.data_rank, grid.model_rank)
    if tp < 1 or world % tp or got != want:
        raise ValueError(f"the mesh's (data size, model size, data rank, model "
                         f"rank) {got} is not rank {rank}'s of {world}: {want}")
    if tp == 1:
        return
    d = rank // tp
    for axis, group, ranks in (
            ("model", grid.model_group, [d * tp + m for m in range(tp)]),
            ("data", grid.data_group, [e * tp + rank % tp for e in range(world // tp)])):
        try:
            members = (None if group is None
                       else dist.get_process_group_ranks(group))
        except (KeyError, ValueError, RuntimeError):
            members = None      # not a group of the current process group
        if members != ranks:
            raise ValueError(f"the mesh's {axis} group {members} is not ranks "
                             f"{ranks} of the current process group: build the "
                             "mesh with make_mesh in this process group")


def fsdp_device_mesh(grid: Mesh, device_type: str):
    """The DeviceMesh `fully_shard` shards over: None (its default, every
    rank) without a model axis, else the data group's."""
    if grid is None or grid.model_size == 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh.from_group(grid.data_group, device_type)

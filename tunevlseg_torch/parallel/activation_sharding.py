"""Sequence parallelism of the towers' residual stream (Megatron-LM SP).

The port's counterpart of `tunevlseg_tpu/parallel/activation_sharding.py`.
Under tensor parallelism (`parallel/tensor_parallel.py`) every rank of a
model group holds the whole (B, S, D) residual stream between the blocks
and repeats the LayerNorms and the residual adds. With sequence parallelism
the stream between blocks is (B, S / tp, D) on each rank, its rows in rank
order: the LayerNorms and residual adds run on those rows, an all-gather
over S comes in front of the column-parallel products and a reduce-scatter
over S after the row-parallel ones takes the all-reduce's place (the same
bytes; `PreNormEncoderLayer(seq_sharded=True)`).

The JAX package constrains the stream at trace time from a module global.
Here it is an attribute of the tower, which `enable(model, mesh)` sets
(`Trainer(seq_shard=True)` calls it once the towers are sharded): a
`SequenceParallel` on each CLIP tower (`models/clip/vision.py`,
`models/clip/text.py`, the JAX package's hook places; SigLIP has none)
whose layers are tensor-parallel. A tower asks it per forward:

  * `active(x)`: whether the stream shards, the JAX `constrain`'s rule. The
    batch rows here are the rank's own, so only S decides: a stream whose
    length does not divide by tp stays replicated (logged once per shape),
    as the 485-token vision stream at 352^2 and the 77-token text do;
  * `split` enters the sharded region (the gradient is gathered back),
    `gather` leaves it for replicated work (the gradient's own rows come
    back): the hidden states CLIPSeg's decoder reads, the last state, the
    text tower's EOS pooling;
  * `write_rows` writes prompt contexts into the global rows
    `start .. start + n` of a sharded stream: each rank writes the rows it
    holds, and the contexts' gradient is summed over the model group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tunevlseg_torch.parallel import tensor_parallel as tp_lib
from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class SequenceParallel:
    group: tp_lib.ModelGroup
    # the stream shapes already logged as staying replicated
    logged: set = dataclasses.field(default_factory=set)

    def active(self, x: torch.Tensor) -> bool:
        """Whether the (B, S, D) stream `x` shards over the model group."""
        if x.dim() == 3 and x.shape[1] % self.group.size == 0:
            return True
        shape = tuple(x.shape)
        if shape not in self.logged:
            self.logged.add(shape)
            log.info("sequence parallel: a stream of shape %s stays replicated "
                     "(%d tokens do not divide by model_parallel=%d)", shape,
                     x.shape[1], self.group.size)
        return False

    def split(self, x: torch.Tensor) -> torch.Tensor:
        return tp_lib.split(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return tp_lib.gather_whole(x, self.group)

    def write_rows(self, x: torch.Tensor, start: int,
                   values: torch.Tensor) -> torch.Tensor:
        """The rank's rows `x` of a sharded stream with the global rows
        `start .. start + n` replaced by `values` (B, n, D) where they fall
        among them. Every rank keeps `values` in its graph (an empty slice
        where none of its rows is written), so that the sum of the
        contexts' gradient over the model group runs on every rank."""
        g = self.group
        rows = x.shape[1]
        lo = g.rank * rows

        def clamp(i):
            return min(max(i, lo), lo + rows)

        a, b = clamp(start), clamp(start + values.shape[1])
        if values.requires_grad:
            values = tp_lib.copy(values, g)
        part = values[:, a - start:b - start] if b > a else values[:, :0]
        return torch.cat([x[:, :a - lo], part.to(x.dtype), x[:, b - lo:]], dim=1)


def enable(model: nn.Module, mesh) -> int:
    """Give each CLIP tower of `model` whose layers are tensor-parallel a
    `SequenceParallel` over the mesh's model group; returns how many. A
    no-op without a model axis (the JAX Trainer's rule at tp = 1)."""
    from tunevlseg_torch.models.clip.text import CLIPTextTower
    from tunevlseg_torch.models.clip.vision import CLIPVisionTower
    if mesh is None or mesh.model_size == 1:
        return 0
    n = 0
    for module in model.modules():
        if isinstance(module, (CLIPVisionTower, CLIPTextTower)):
            g = tp_lib.model_group_of(module)
            if g is not None:
                module.seq_parallel = SequenceParallel(g)
                n += 1
    return n


def of(tower: nn.Module, x: torch.Tensor) -> Optional[SequenceParallel]:
    """The tower's `SequenceParallel` when the stream `x` shards, else None."""
    sp = getattr(tower, "seq_parallel", None)
    return sp if sp is not None and sp.active(x) else None

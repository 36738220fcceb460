"""Which frozen tensors tensor parallelism slices: the JAX package's rules.

The port's counterpart of `tunevlseg_tpu/parallel/sharding_rules.py:1-119`.
The rules are the JAX package's own, regular expressions over a parameter's
`/`-joined path in the JAX tree, and the port applies them to each of its
parameters through the JAX path it maps to (`convert/from_jax.py`'s map
run backwards: `layers.3` -> `layers_3`, a `Dense` weight -> `kernel`, a
norm's weight -> `scale`, an embedding's -> `embedding`):

  * `q_proj`, `k_proj`, `v_proj` and `fc1` are column-parallel: the kernel
    (in, out) on `out`, the port's weight (out, in) on dimension 0, and the
    bias with it;
  * `out_proj` and `fc2` are row-parallel: the kernel on `in`, the port's
    weight on dimension 1; the bias stays whole (added once, after the sum);
  * everything else is replicated.

They apply to the frozen tensors only (parameters and buffers that do not
train), as the JAX Trainer applies them to its frozen tree: the trainable
state stays replicated (or FSDP-sharded over the data group).

A leaf whose sliced dimension does not divide by the model axis is
replicated, with one warning per such fallback, and a shard report of the
three counts is logged, whenever the model axis is larger than 1; at tp = 1
nothing is logged.

One difference, by design: the port slices a whole block or none of it.
Its blocks (`tp_column` / `tp_row` on `MultiHeadAttention`,
`TransformerMLP`, CRIS's `MHA` and RN50 attention pool) run the attention
kernels on each rank's local heads, so the `q/k/v` columns must fall on
head boundaries: a block whose head count does not divide by tp is
replicated and reported as a fallback, where the JAX rule, leaf by leaf,
would cut it mid-head (2 heads of 8 dims at tp = 4: 16 columns divide by
4, 2 heads do not). A rule-matched leaf outside such a block, or in a block
part of which trains, is likewise replicated as a fallback.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

from torch import nn

from tunevlseg_torch.nn.layers import Dense, Embed, GroupNorm, LayerNorm
from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)

# column-parallel: shard output features; the matching bias is sharded too.
_COL = r"(q_proj|k_proj|v_proj|fc1)"
# row-parallel: shard input features; the bias stays replicated (added once
# after the sum).
_ROW = r"(out_proj|fc2)"

# (pattern over the JAX path, the JAX leaf's sharded dimension or None)
DEFAULT_TP_RULES: Sequence[tuple[str, Optional[int]]] = (
    (rf".*/{_COL}/kernel$", 1),
    (rf".*/{_COL}/bias$", 0),
    (rf".*/{_ROW}/kernel$", 0),
    (r".*", None),
)


def jax_path(module_name: str, module: nn.Module, leaf: str) -> str:
    """The JAX path of the port tensor `module_name.leaf` of `module`."""
    parts: list[str] = []
    for part in module_name.split(".") if module_name else []:
        if part.isdigit() and parts:
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    if leaf == "weight":
        if isinstance(module, Dense):
            leaf = "kernel"
        elif isinstance(module, (LayerNorm, GroupNorm)):
            leaf = "scale"
        elif isinstance(module, Embed):
            leaf = "embedding"
    return "/".join(parts + [leaf])


def _frozen_leaves(model: nn.Module) -> dict[str, tuple]:
    """{port name: (JAX path, tensor, owning module)} of every frozen
    parameter and persistent buffer."""
    out = {}
    for mname, module in model.named_modules():
        skip = getattr(module, "_non_persistent_buffers_set", set())
        leaves = [(n, t) for n, t in module.named_parameters(recurse=False)
                  if not t.requires_grad]
        leaves += [(n, t) for n, t in module.named_buffers(recurse=False)
                   if n not in skip and t is not None]
        for leaf, t in leaves:
            name = f"{mname}.{leaf}" if mname else leaf
            out[name] = (jax_path(mname, module, leaf), t, module)
    return out


def _jax_dim(path: str, rules) -> Optional[int]:
    for pattern, dim in rules:
        if re.match(pattern, path):
            return dim
    return None


def plan(model: nn.Module, mesh, rules=DEFAULT_TP_RULES
         ) -> tuple[dict[str, int], list[nn.Module]]:
    """({port parameter name: the port tensor's sliced dimension}, the
    blocks to shard) for `mesh`'s model axis, with the fallback warnings
    and the shard report when that axis is larger than 1."""
    size = mesh.model_size
    compiled = [(re.compile(p), d) for p, d in rules]
    leaves = _frozen_leaves(model)
    wants = {}
    for name, (path, t, module) in leaves.items():
        dim = _jax_dim(path, compiled)
        if dim is not None:
            # a kernel (in, out) is the port's weight (out, in) transposed
            wants[name] = 1 - dim if path.endswith("/kernel") else dim
    fallbacks: dict[str, str] = {}
    for name, dim in wants.items():
        t = leaves[name][1]
        if dim >= t.dim() or t.shape[dim] % size:
            fallbacks[name] = (f"not divisible by mesh for model axis "
                               f"{size} on dimension {dim}")

    dims: dict[str, int] = {}
    blocks: list[nn.Module] = []
    claimed: set[str] = set()
    for bname, block in model.named_modules():
        if not hasattr(block, "tp_column"):
            continue
        prefix = f"{bname}." if bname else ""
        names = [f"{prefix}{d}.{leaf}" for d in (*block.tp_column, *block.tp_row)
                 for leaf, p in getattr(block, d).named_parameters(recurse=False)]
        mine = [n for n in names if n in wants]
        claimed.update(mine)
        reason = None
        if any(n not in leaves for n in names):
            reason = "its block has trainable parameters"
        elif hasattr(block, "num_heads") and block.num_heads % size:
            reason = (f"{block.num_heads} heads do not divide by model_parallel="
                      f"{size}: the port shards whole heads")
        elif any(n in fallbacks for n in mine):
            reason = "another leaf of its block does not divide"
        if reason is None:
            dims.update((n, wants[n]) for n in mine)
            blocks.append(block)
        else:
            for n in mine:
                fallbacks.setdefault(n, reason)
    for name in set(wants) - claimed:
        fallbacks.setdefault(name, "no tensor-parallel block of the port holds it")

    if size > 1:
        for name in sorted(fallbacks, key=list(leaves).index):
            log.warning("tensor-parallel FALLBACK: %s %s %s — replicated instead",
                        name, tuple(leaves[name][1].shape), fallbacks[name])
        log.info("tp shard report (model axis %d): %d params sharded, %d "
                 "replicated by rule, %d replicated by FALLBACK", size,
                 len(dims), len(leaves) - len(wants), len(fallbacks))
    return dims, blocks


def tp_param_specs(model: nn.Module, mesh, rules=DEFAULT_TP_RULES
                   ) -> dict[str, Optional[int]]:
    """{frozen tensor name: the dimension tensor parallelism slices, or
    None}: the port's counterpart of the JAX spec tree (`plan`'s warnings
    and report included)."""
    dims, _ = plan(model, mesh, rules)
    return {name: dims.get(name) for name in _frozen_leaves(model)}

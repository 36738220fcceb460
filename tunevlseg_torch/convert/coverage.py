"""Key sets, synthetic checkpoints and the checks that a checkpoint landed.

A key set is a real checkpoint's `{key: shape}` listing:
`tunevlseg_torch/convert/keysets/*.json` (written by
`scripts/torch_dump_keysets.py`: CIDAS CLIPSeg rd64-refined, SigLIP-base,
BiomedCLIP) and `tests/fixtures/keysets/{clip_rn50,freesolo_r101}.json`
(OpenAI's RN50, FreeSOLO R101). `synthetic_state_dict` draws a checkpoint on
one at the scale an initialisation gives (norm weights 1 +- 0.02, BatchNorm
variances in [0.5, 1.5], everything else N(0, 0.02)); `shape_state_dict`
gives zero-stride numpy views instead, which cost no memory at any width.

`sources` finds, for each tensor a converter produced, the checkpoint key it
came from (the converters only take views: transposes, reshapes, slices),
and `expected_tensor` applies the documented transform to that source: the
identity (a Dense kernel is transposed by the converter and back by the
name map), the patch embedding's (D, C, p, p) -> (C*p*p, D), a packed
in-projection's q / k / v third, or a reshape (BiomedCLIP's class token and
position table). `unread_keys` lists what a conversion left unread;
`port_shapes` maps a tree's leaves to port names and shapes without copying
a value.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from tunevlseg_torch.convert.from_jax import flatten_params, port_name

REPO = Path(__file__).resolve().parents[2]
KEYSET_DIRS = (Path(__file__).resolve().parent / "keysets",
               REPO / "tests" / "fixtures" / "keysets")


def read_keyset(name: str) -> dict[str, tuple[int, ...]]:
    """{key: shape} of the key set `name` (a file stem in `KEYSET_DIRS`)."""
    for folder in KEYSET_DIRS:
        path = folder / f"{name}.json"
        if path.exists():
            return {k: tuple(v) for k, v in json.loads(path.read_text()).items()}
    raise FileNotFoundError(f"no key set {name!r} in {[str(d) for d in KEYSET_DIRS]}")


def _is_norm_weight(key: str, shape: tuple) -> bool:
    return key.endswith(".weight") and len(shape) == 1


def synthetic_state_dict(listing: Mapping[str, tuple], generator) -> dict:
    """torch tensors (f32; `num_batches_tracked` int64 zeros) on the CPU,
    drawn from `generator` in the listing's key order."""
    import torch
    out = {}
    for key, shape in listing.items():
        if key.endswith("num_batches_tracked"):
            out[key] = torch.zeros(shape, dtype=torch.int64)
        elif key.endswith("running_var"):
            out[key] = torch.rand(shape, generator=generator) + 0.5
        elif _is_norm_weight(key, shape):
            out[key] = 1.0 + 0.02 * torch.randn(shape, generator=generator)
        else:
            out[key] = 0.02 * torch.randn(shape, generator=generator)
    return out


def shape_state_dict(listing: Mapping[str, tuple]) -> dict[str, np.ndarray]:
    """Zero-stride f32 numpy views of the listing's shapes (1.0 for norm
    weights and variances, 0.02 elsewhere): names and shapes at no memory."""
    return {k: np.broadcast_to(np.float32(
        1.0 if k.endswith("running_var") or _is_norm_weight(k, s) else 0.02), s)
        for k, s in listing.items()}


def merged(trees: Mapping[str, Any]) -> dict:
    """A converter's {"params", "batch_stats"} as one tree (the collections
    hold different leaves of the same modules, under the same paths)."""
    out: dict = {}

    def put(node: dict, tree: Mapping[str, Any]) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                put(node.setdefault(key, {}), value)
            else:
                node[key] = value
    for tree in trees.values():
        put(out, tree)
    return out


def port_shapes(tree: Mapping[str, Any]) -> dict[str, tuple[int, ...]]:
    """{port name: shape} of a converted tree, no value copied."""
    out = {}
    for path, leaf in flatten_params(tree).items():
        name, transpose = port_name(path)
        shape = tuple(np.shape(leaf))
        out[name] = shape[::-1] if transpose else shape
    return out


def _start(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def _end(a: np.ndarray) -> int:
    """One past the last byte `a` holds (zero strides hold one element)."""
    return _start(a) + a.itemsize + sum((n - 1) * st for n, st in
                                        zip(a.shape, a.strides) if st > 0)


def sources(tree: Mapping[str, Any],
            sd: Mapping[str, np.ndarray]) -> dict[str, str]:
    """{port name: checkpoint key} for every leaf of `tree` converted from
    `sd`: the key whose array holds the memory the leaf views."""
    spans = sorted((_start(a), _end(a), k) for k, a in sd.items() if a.size)
    starts = [s for s, _, _ in spans]
    out = {}
    for path, leaf in flatten_params(tree).items():
        at = _start(np.asarray(leaf))
        i = bisect.bisect_right(starts, at) - 1
        if i < 0 or not spans[i][0] <= at < spans[i][1]:
            raise KeyError(f"{'/'.join(path)} views no array of the checkpoint")
        out[port_name(path)[0]] = spans[i][2]
    return out


def unread_keys(tree: Mapping[str, Any], sd, ignored: tuple = ()) -> list[str]:
    """Keys of `sd` (a `TrackingDict`) that converting it into `tree` did not
    read, outside the `ignored` suffixes: neither looked up nor the source
    of a leaf (a converter that copies a sub-dict, as the reference wrapper's
    `model.*` one, reads through the copy)."""
    read = set(sd.accessed) | set(sources(tree, sd).values())
    return sorted(k for k in sd if k not in read and not k.endswith(tuple(ignored)))


def expected_tensor(name: str, shape: tuple, source):
    """The port tensor `name` of `shape` from its checkpoint tensor `source`
    (a torch tensor) by the documented transform."""
    shape = tuple(shape)
    if tuple(source.shape) == shape:
        return source
    if source.dim() == 4 and len(shape) == 2:           # patch embedding
        return source.reshape(source.shape[0], -1).T
    for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
        if f".{proj}." in name and source.shape[0] == 3 * shape[0]:
            return source[j * shape[0]:(j + 1) * shape[0]]
    if source.numel() == int(np.prod(shape)):
        return source.reshape(shape)
    raise ValueError(f"{name} {shape}: no documented transform from a source "
                     f"of shape {tuple(source.shape)}")

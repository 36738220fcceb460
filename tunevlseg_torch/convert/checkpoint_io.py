"""Checkpoint files -> flat `{name: numpy array}` state dicts.

The readers of the JAX package's converters (`tunevlseg_tpu/convert/
clipseg.py`, `cris.py`, `solov2.py`, `biomed_clip.py`), in one place:

  * `.safetensors` files through `read_safetensors`, a reader of the format
    written from its specification (an 8-byte little-endian header length, a
    JSON header of `{name: {dtype, shape, data_offsets}}`, then the raw
    little-endian buffers), so no `safetensors` package is needed;
  * everything else through `torch.load` on the CPU, or, with
    `torchscript_first`, `torch.jit.load` first (OpenAI's `RN50.pt` is a
    TorchScript archive) and `torch.load` when that fails;
  * the payload unwrapped from the dicts that hold it (`unwrap`: Lightning's
    `state_dict`, detectron2's `model`);
  * prefixes stripped when every key carries them (`strip_prefixes`).

Values come out as numpy arrays; float64 becomes float32 (an f64 oracle
model saved in a test), bfloat16 becomes float32 (numpy has no bfloat16;
the widening is exact), every other dtype stays. `TrackingDict` records the
keys a converter reads, for the key-coverage checks.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Iterable, Mapping

import numpy as np

# safetensors dtype names -> numpy dtypes ("BF16" is widened to float32)
_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
    "BOOL": np.bool_,
}


class Tree(dict):
    """A nested dict of numpy arrays, set by "a/b/c" paths: the JAX package's
    parameter tree."""

    def set(self, path: str, value: np.ndarray) -> None:
        node = self
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value


class TrackingDict(dict):
    """A state dict that records every key read from it (`accessed`)."""

    def __init__(self, base: Mapping[str, Any]):
        super().__init__(base)
        self.accessed: set[str] = set()

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key in self:
            self.accessed.add(key)
        return super().get(key, default)


def to_numpy(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """torch tensors (or arrays) -> numpy arrays; float64 -> float32."""
    out = {}
    for key, value in state_dict.items():
        if hasattr(value, "detach"):
            value = value.detach().cpu()
            if str(value.dtype) == "torch.bfloat16":
                value = value.float()
            value = value.numpy()
        arr = np.asarray(value)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        out[key] = arr
    return out


def read_safetensors(path) -> dict[str, np.ndarray]:
    """A `.safetensors` file -> {name: array} (C order, little-endian)."""
    data = np.fromfile(path, dtype=np.uint8)
    if data.size < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
    (n,) = struct.unpack("<Q", data[:8].tobytes())
    header = json.loads(data[8:8 + n].tobytes())
    body = data[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        raw = body[start:end]
        kind = info["dtype"]
        if kind == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif kind in _SAFETENSORS_DTYPES:
            arr = raw.view(np.dtype(_SAFETENSORS_DTYPES[kind]).newbyteorder("<"))
            arr = arr.astype(arr.dtype.newbyteorder("="), copy=False)
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {kind}, which "
                             "this reader does not take")
        arr = arr.reshape(shape)
        out[name] = arr.astype(np.float32) if arr.dtype == np.float64 else arr
    return out


def read_torch(path, torchscript_first: bool = False, weights_only: bool = False):
    """The object a torch checkpoint file holds: with `torchscript_first`,
    the `state_dict()` of a TorchScript archive, or, when the file is not
    one, `torch.load`'s result (on the CPU)."""
    import torch
    if torchscript_first:
        try:
            return torch.jit.load(str(path), map_location="cpu").state_dict()
        except RuntimeError:
            pass
    return torch.load(str(path), map_location="cpu", weights_only=weights_only)


def unwrap(raw, keys: Iterable[str] = ("state_dict",)):
    """The payload under each of `keys` in turn, where `raw` is a dict that
    holds it as a dict (Lightning's `state_dict`, detectron2's `model`)."""
    for key in keys:
        if isinstance(raw, Mapping) and isinstance(raw.get(key), Mapping):
            raw = raw[key]
    return raw


def strip_prefixes(sd: Mapping[str, np.ndarray],
                   prefixes: Iterable[str]) -> dict[str, np.ndarray]:
    """Each of `prefixes` in turn removed from every key when every key
    starts with it."""
    sd = dict(sd)
    for prefix in prefixes:
        if sd and all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def read_state_dict(path, *, torchscript_first: bool = False,
                    unwrap_keys: Iterable[str] = ("state_dict",),
                    weights_only: bool = False) -> dict[str, np.ndarray]:
    """A checkpoint file -> {name: numpy array}: `.safetensors` by
    `read_safetensors`, anything else by `read_torch` and `unwrap`."""
    if Path(path).suffix == ".safetensors":
        return read_safetensors(path)
    raw = unwrap(read_torch(path, torchscript_first, weights_only), unwrap_keys)
    if not isinstance(raw, Mapping):
        raise ValueError(f"{path}: holds a {type(raw).__name__}, not a state dict")
    return to_numpy(raw)

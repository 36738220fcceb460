"""`_target_` / `_partial_` recursive instantiation (Hydra-compatible).

Mirrors `hydra.utils.instantiate` for the subset the config tree uses:
dotted-path import, recursive child instantiation, `_partial_: true` yielding
a functools.partial, and positional `_args_`. The port's own copy of
`tunevlseg_tpu/config/instantiate.py`.
"""
from __future__ import annotations

import functools
import importlib
from typing import Any, Mapping


def _locate(dotted: str) -> Any:
    parts = dotted.split(".")
    for split in range(len(parts), 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(module_name)
        except ModuleNotFoundError:
            continue
        for attr in parts[split:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"cannot locate {dotted}")


def instantiate(node: Any, **kwargs: Any) -> Any:
    if isinstance(node, Mapping):
        if "_target_" in node:
            target = _locate(node["_target_"])
            partial = bool(node.get("_partial_", False))
            args = [instantiate(a) for a in node.get("_args_", ())]
            call_kwargs = {
                k: instantiate(v) for k, v in node.items()
                if k not in ("_target_", "_partial_", "_args_")
            }
            call_kwargs.update(kwargs)
            if partial:
                return functools.partial(target, *args, **call_kwargs)
            return target(*args, **call_kwargs)
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node

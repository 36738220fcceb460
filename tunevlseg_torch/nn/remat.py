"""Per-layer activation rematerialisation.

Counterpart of `tunevlseg_tpu/nn/remat.py`. Inside `forced(True)` the layer
loops that call `layer_call` (the CLIP towers, the TransformerSegmentor's
decoder, CRIS's text tower, decoder and frozen-BatchNorm ResNet blocks) run
each layer under `torch.utils.checkpoint`: the layer keeps only its inputs
for the backward and recomputes its internals (qkv, attention, the MLP's
hidden) there, so the activations held at once drop from every layer's
internals to one layer's. Parameters are untouched, so the `state_dict`
keys and values are those of a plain run and checkpoints are
interchangeable between the two.

Dropout masks come from an explicit `torch.Generator`, which
`torch.utils.checkpoint`'s `preserve_rng_state` does not save (it saves the
default CPU and CUDA generators only): `checkpoint` snapshots the given
generator's state before the forward and restores that snapshot for the
recompute, so the recompute draws the forward's masks bit for bit.

The flag is a `contextvars.ContextVar`, read while a forward runs, so one
process can run both programs side by side; `SegmentationTask(remat=True)`
sets it around its loss.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_ENABLED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "tunevlseg_remat_layers", default=False)


def enabled() -> bool:
    """Whether `layer_call` rematerialises here."""
    return _ENABLED.get()


@contextlib.contextmanager
def forced(enable: bool = True):
    """Per-layer remat on (or off) for the forwards run inside the block."""
    token = _ENABLED.set(bool(enable))
    try:
        yield
    finally:
        _ENABLED.reset(token)


def checkpoint(fn: Callable, *tensors, generator: Optional[torch.Generator] = None):
    """`fn(*tensors)` under `torch.utils.checkpoint.checkpoint(...,
    use_reentrant=False)`: its internals are recomputed in the backward.
    With `generator`, the recompute starts from the generator state the
    forward started from, and the generator is left as the recompute found
    it."""
    if generator is None:
        return _torch_checkpoint(fn, *tensors, use_reentrant=False)
    start = generator.get_state()
    calls = 0

    def run(*args):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*args)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*args)
        finally:
            # also when the recompute stops early, once it has what the
            # backward needs
            generator.set_state(now)

    return _torch_checkpoint(run, *tensors, use_reentrant=False)


def layer_call(layer: torch.nn.Module, *tensors,
               generator: Optional[torch.Generator] = None, **static):
    """`layer(*tensors, **static)` (with `generator=` when one is given),
    recomputed in the backward when `enabled()`. `tensors` are the
    layer's tensor inputs (None allowed); `static` are Python values."""
    if generator is not None:
        static["generator"] = generator
    if not enabled():
        return layer(*tensors, **static)
    return checkpoint(functools.partial(layer, **static), *tensors,
                      generator=generator)

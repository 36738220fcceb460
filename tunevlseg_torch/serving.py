"""Serving: the pure inference function of a SegmentationTask.

Counterpart of `tunevlseg_tpu/serving.py:task_predict_fn`. The server's
function takes the weights as an argument (a mapping from the model's
`state_dict` names to tensors, parameters and buffers such as the BatchNorm
running statistics alike, e.g. `dict(model.state_dict())` or the result of
`tunevlseg_torch.convert.from_jax.state_dict_from_jax`) and a request batch
of uint8 images and token ids, and returns sigmoid probabilities. Exporting
it ahead of time (`torch.export`, in place of `jax.export`) is ROADMAP
Slice G.
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch.func import functional_call


def task_predict_fn(task) -> Callable[[Mapping[str, torch.Tensor], dict], torch.Tensor]:
    """(params, batch) -> (B, 1, H, W) f32 probabilities. `params` must name
    every parameter and every buffer of `task.model`."""

    @torch.no_grad()
    def predict(params: Mapping[str, torch.Tensor], batch: dict) -> torch.Tensor:
        args, kwargs = task.model_inputs(batch)
        logits = functional_call(task.model, dict(params), args, kwargs,
                                 strict=True)
        return torch.sigmoid(logits.float())

    return predict

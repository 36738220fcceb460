"""The program under test for a CRIS configuration: the port's
`presets.build_cris` at the configuration's widths (the `nchw` layout, the
backbone on cuDNN), bf16 compute over f32 weights, in a `SegmentationTask`
with the recipe's optimizer."""
from __future__ import annotations

import dataclasses

import torch


def port_config(config: dict):
    """The configuration's keys that `CRISConfig` has, lists as tuples."""
    from tunevlseg_torch.models.cris.model import CRISConfig
    return CRISConfig(**{f.name: tuple(config[f.name]) if isinstance(config[f.name], list)
                         else config[f.name] for f in dataclasses.fields(CRISConfig)})


def build_task(config: dict, recipe: dict, device):
    """The task, its model's weights and buffers by name, uninitialised
    by the benchmark (`build_cris`'s own seeded draw)."""
    from tunevlseg_torch.models.presets import build_cris
    from tunevlseg_torch.training.task import SegmentationTask
    model, spec = build_cris(
        recipe["strategy"], prompt_depth=recipe.get("prompt_depth", 1),
        num_context=recipe.get("num_context", 4), config=port_config(config),
        layout="nchw", dtype=getattr(torch, config["compute_dtype"]), device=device,
        seed=0)
    return SegmentationTask(model, spec, learning_rate=recipe["lr"],
                            weight_decay=recipe["weight_decay"])

"""FreeSOLO / SOLOv2 checkpoints (detectron2's layout) -> the JAX package's
SOLOv2 tree.

The port's own copy of `tunevlseg_tpu/convert/solov2.py`: the reference's
PseudoSOLOv2 state dict (`backbone.bottom_up.*` ResNet, `backbone.fpn_*`,
`ins_head.*`, `mask_head.*`; `FreeSOLO_R101_30k.pt` holds it under
`model`). The FrozenBN statistics are parameters of the tree, as they are
of the port's model.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from tunevlseg_torch.convert.checkpoint_io import (Tree, read_state_dict,
                                                   strip_prefixes)
from tunevlseg_torch.models.solov2.backbone import RESNET_STAGE_BLOCKS
from tunevlseg_torch.models.solov2.model import SOLOv2Config

# detectron2's pixel statistics (SOLOv2 normalises nothing) and its iteration
# counter: the keys no converter reads
SOLOV2_IGNORED = ("pixel_mean", "pixel_std", "_iter")


def _conv(t: Tree, dst: str, sd, src: str) -> None:
    t.set(f"{dst}/weight", sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        t.set(f"{dst}/bias", sd[f"{src}.bias"])


def _frozen_bn(t: Tree, dst: str, sd, src: str) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        t.set(f"{dst}/{name}", sd[f"{src}.{name}"])


def _gn(t: Tree, dst: str, sd, src: str) -> None:
    t.set(f"{dst}/scale", sd[f"{src}.weight"])
    t.set(f"{dst}/bias", sd[f"{src}.bias"])


def convert_solov2(sd: Mapping[str, np.ndarray],
                   cfg: SOLOv2Config) -> dict[str, Any]:
    t = Tree()
    bu = "backbone.bottom_up"
    _conv(t, "backbone/stem_conv1", sd, f"{bu}.stem.conv1")
    _frozen_bn(t, "backbone/stem_conv1_norm", sd, f"{bu}.stem.conv1.norm")
    for stage, blocks in enumerate(RESNET_STAGE_BLOCKS[cfg.depth], start=2):
        for b in range(blocks):
            src = f"{bu}.res{stage}.{b}"
            dst = f"backbone/res{stage}_{b}"
            for ci in (1, 2, 3):
                _conv(t, f"{dst}/conv{ci}", sd, f"{src}.conv{ci}")
                _frozen_bn(t, f"{dst}/conv{ci}_norm", sd, f"{src}.conv{ci}.norm")
            if f"{src}.shortcut.weight" in sd:
                _conv(t, f"{dst}/shortcut", sd, f"{src}.shortcut")
                _frozen_bn(t, f"{dst}/shortcut_norm", sd, f"{src}.shortcut.norm")

    for lvl in (2, 3, 4, 5):
        _conv(t, f"fpn/fpn_lateral{lvl}", sd, f"backbone.fpn_lateral{lvl}")
        _conv(t, f"fpn/fpn_output{lvl}", sd, f"backbone.fpn_output{lvl}")

    # the instance head's towers: Sequential [conv, GN, ReLU] triplets
    for head in ("cate", "kernel"):
        for i in range(cfg.num_instance_convs):
            dst = f"ins_head/{head}_tower_{i}"
            _conv(t, f"{dst}/conv", sd, f"ins_head.{head}_tower.{i * 3}")
            _gn(t, f"{dst}/gn", sd, f"ins_head.{head}_tower.{i * 3 + 1}")
    for pred in ("cate_pred", "kernel_pred", "emb_pred"):
        _conv(t, f"ins_head/{pred}", sd, f"ins_head.{pred}")

    for i in range(4):
        for j in range(max(1, i)):
            src = f"mask_head.convs_all_levels.{i}.conv{j}"
            dst = f"mask_head/level{i}_conv{j}"
            _conv(t, f"{dst}/conv", sd, f"{src}.0")
            _gn(t, f"{dst}/gn", sd, f"{src}.1")
    _conv(t, "mask_head/conv_pred_conv", sd, "mask_head.conv_pred.0")
    _gn(t, "mask_head/conv_pred_gn", sd, "mask_head.conv_pred.1")
    return t


def read_freesolo_state_dict(path) -> dict[str, np.ndarray]:
    """The flat state dict of a FreeSOLO checkpoint file, as the JAX
    `load_freesolo_checkpoint` reads it: `state_dict`, then detectron2's
    `model` unwrapped, `model.` stripped."""
    return strip_prefixes(read_state_dict(path, unwrap_keys=("state_dict", "model")),
                          ("model.",))


def load_freesolo_checkpoint(path, cfg: SOLOv2Config) -> dict[str, Any]:
    return convert_solov2(read_freesolo_state_dict(path), cfg)

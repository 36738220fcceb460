"""CRIS / OpenAI CLIP checkpoints -> the JAX package's CRIS trees.

The port's own copy of `tunevlseg_tpu/convert/cris.py`, for the reference's
three checkpoint kinds:
  * OpenAI CLIP TorchScript archives (`RN50.pt`: `visual.*`,
    `transformer.*`, ... at the top level);
  * whole CRIS state dicts (`backbone.*` + `neck.*` / `decoder.*` /
    `proj.*`), Lightning's included (`model.` / `net.` stripped, as the
    reference's scripts/process_cris_checkpoint.py does);
  * COOPCRIS wrapper dicts with `context_learner.*` and the additive head.

Returns {"params": tree, "batch_stats": tree}: the BatchNorm running
statistics are a collection of their own, which `convert/from_jax.py` maps
onto the port's BatchNorm buffers (its `TrainState.model_state` where a
task keeps them). An OpenAI archive fills the two towers only; the CRIS
head keeps its seeded weights. The port's CRIS builds every tensor of the
archive (`CRIS_ELIDABLE` is empty); `CRIS_IGNORED` names the keys no
converter reads (BatchNorm's `num_batches_tracked`, CLIP's `logit_scale`).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np

from tunevlseg_torch.convert.checkpoint_io import (Tree, read_state_dict,
                                                   strip_prefixes)
from tunevlseg_torch.convert.clipseg import (_dense, _packed_mha,
                                             convert_context_learner)
from tunevlseg_torch.models.cris.model import CRISConfig

CRIS_ELIDABLE: tuple[str, ...] = ()
CRIS_IGNORED = ("num_batches_tracked", "logit_scale")


def _conv(p: Tree, dst: str, sd, src: str) -> None:
    p.set(f"{dst}/weight", sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        p.set(f"{dst}/bias", sd[f"{src}.bias"])


def _bn(p: Tree, s: Tree, dst: str, sd, src: str) -> None:
    p.set(f"{dst}/weight", sd[f"{src}.weight"])
    p.set(f"{dst}/bias", sd[f"{src}.bias"])
    s.set(f"{dst}/running_mean", sd[f"{src}.running_mean"])
    s.set(f"{dst}/running_var", sd[f"{src}.running_var"])


def _ln(p: Tree, dst: str, sd, src: str) -> None:
    p.set(f"{dst}/scale", sd[f"{src}.weight"])
    p.set(f"{dst}/bias", sd[f"{src}.bias"])


def _conv_bn(p: Tree, s: Tree, dst: str, sd, src: str) -> None:
    """The reference's `conv_layer` Sequential: .0 conv, .1 BatchNorm."""
    _conv(p, f"{dst}/conv", sd, f"{src}.0")
    _bn(p, s, f"{dst}/bn", sd, f"{src}.1")


def convert_clip_backbone(sd: Mapping[str, np.ndarray], cfg: CRISConfig,
                          p: Tree, s: Tree) -> None:
    """OpenAI CLIP RN50 keys (`visual.*`, the text transformer at the top)."""
    for i in (1, 2, 3):
        _conv(p, f"visual/conv{i}", sd, f"visual.conv{i}")
        _bn(p, s, f"visual/bn{i}", sd, f"visual.bn{i}")
    for stage, blocks in enumerate(cfg.vision_layers, start=1):
        for b in range(blocks):
            src = f"visual.layer{stage}.{b}"
            dst = f"visual/layer{stage}_{b}"
            for ci in (1, 2, 3):
                _conv(p, f"{dst}/conv{ci}", sd, f"{src}.conv{ci}")
                _bn(p, s, f"{dst}/bn{ci}", sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                _conv(p, f"{dst}/downsample_conv", sd, f"{src}.downsample.0")
                _bn(p, s, f"{dst}/downsample_bn", sd, f"{src}.downsample.1")
    ap = "visual.attnpool"
    p.set("visual/attnpool/positional_embedding", sd[f"{ap}.positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(p, f"visual/attnpool/{proj}", sd, f"{ap}.{proj}")
    if f"{ap}.connect.0.weight" in sd:      # CRIS's residual, not in OpenAI's
        _conv(p, "visual/attnpool/connect_conv", sd, f"{ap}.connect.0")
        _bn(p, s, "visual/attnpool/connect_bn", sd, f"{ap}.connect.1")

    p.set("text/token_embedding/embedding", sd["token_embedding.weight"])
    p.set("text/positional_embedding", sd["positional_embedding"])
    for i in range(cfg.transformer_layers):
        src = f"transformer.resblocks.{i}"
        dst = f"text/resblocks_{i}"
        _packed_mha(p, f"{dst}/self_attn", sd, f"{src}.attn")
        _ln(p, f"{dst}/layer_norm1", sd, f"{src}.ln_1")
        _ln(p, f"{dst}/layer_norm2", sd, f"{src}.ln_2")
        _dense(p, f"{dst}/mlp/fc1", sd, f"{src}.mlp.c_fc")
        _dense(p, f"{dst}/mlp/fc2", sd, f"{src}.mlp.c_proj")
    _ln(p, "text/ln_final", sd, "ln_final")
    p.set("text/text_projection", sd["text_projection"])


def config_from_clip_state_dict(sd: Mapping[str, np.ndarray],
                                **head_kwargs) -> CRISConfig:
    """The shapes OpenAI's `build_model` infers from a state dict (RN path)."""
    vision_layers = tuple(
        len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
        for b in range(1, 5))
    vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
    output_width = round(
        (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    return CRISConfig(
        vision_layers=vision_layers, vision_width=vision_width,
        vision_heads=vision_width * 32 // 64,
        image_resolution=output_width * 32,
        embed_dim=sd["text_projection"].shape[1],
        vocab_size=sd["token_embedding.weight"].shape[0],
        context_length=sd["positional_embedding"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
        **head_kwargs)


def convert_cris(sd: Mapping[str, np.ndarray], cfg: CRISConfig,
                 strategy: Optional[str] = None) -> dict[str, Any]:
    """A CRIS state dict (with a COOPCRIS learner and head, or a bare OpenAI
    CLIP one) -> {"params", "batch_stats"}."""
    p, s = Tree(), Tree()

    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    if backbone:
        convert_clip_backbone(backbone, cfg, p, s)
    elif "visual.conv1.weight" in sd:
        convert_clip_backbone(sd, cfg, p, s)

    if any(k.startswith("neck.") for k in sd):
        for name in ("f1_v_proj", "f2_v_proj", "f2_cat", "f3_v_proj",
                     "f3_cat", "f4_proj5", "f4_proj4", "f4_proj3", "aggr"):
            _conv_bn(p, s, f"neck/{name}", sd, f"neck.{name}")
        _dense(p, "neck/txt_proj/linear", sd, "neck.txt_proj.0")
        _bn(p, s, "neck/txt_proj/bn", sd, "neck.txt_proj.1")
        _bn(p, s, "neck/norm_layer_bn", sd, "neck.norm_layer.0")
        _conv_bn(p, s, "neck/coordconv_0", sd, "neck.coordconv.0.conv1")
        _conv_bn(p, s, "neck/coordconv_1", sd, "neck.coordconv.1")

    if any(k.startswith("decoder.") for k in sd):
        n_layers = len({k.split(".")[2] for k in sd
                        if k.startswith("decoder.layers.")})
        for i in range(n_layers):
            src = f"decoder.layers.{i}"
            dst = f"decoder/layers_{i}"
            _packed_mha(p, f"{dst}/self_attn", sd, f"{src}.self_attn")
            _packed_mha(p, f"{dst}/multihead_attn", sd, f"{src}.multihead_attn")
            for norm in ("self_attn_norm", "cross_attn_norm",
                         "norm1", "norm2", "norm3"):
                _ln(p, f"{dst}/{norm}", sd, f"{src}.{norm}")
            _dense(p, f"{dst}/ffn_0", sd, f"{src}.ffn.0")
            _ln(p, f"{dst}/ffn_norm", sd, f"{src}.ffn.3")
            _dense(p, f"{dst}/ffn_1", sd, f"{src}.ffn.4")
        _ln(p, "decoder/norm", sd, "decoder.norm")

    if any(k.startswith("proj.") for k in sd):
        _conv_bn(p, s, "proj/vis_1", sd, "proj.vis.1")
        _conv_bn(p, s, "proj/vis_3", sd, "proj.vis.3")
        _conv(p, "proj/vis_4", sd, "proj.vis.4")
        _dense(p, "proj/txt", sd, "proj.txt")

    if "additive_decoder_layer.0.weight" in sd:
        _conv(p, "additive_conv1", sd, "additive_decoder_layer.0")
        _conv(p, "additive_conv2", sd, "additive_decoder_layer.2")
    if "residual_ratio" in sd:
        p.set("residual_ratio", sd["residual_ratio"])
    if strategy is not None and any(k.startswith("context_learner.") for k in sd):
        p["learner"] = convert_context_learner(sd, strategy)
    return {"params": p, "batch_stats": s}


def read_cris_state_dict(path) -> dict[str, np.ndarray]:
    """The flat state dict of a CRIS / CLIP checkpoint file, as the JAX
    `load_cris_checkpoint` reads it: a TorchScript archive first, else
    `torch.load` with Lightning's `state_dict` unwrapped; `model.` and `net.`
    stripped."""
    return strip_prefixes(read_state_dict(path, torchscript_first=True),
                          ("model.", "net."))


def load_cris_checkpoint(path, cfg: CRISConfig,
                         strategy: Optional[str] = None) -> dict[str, Any]:
    return convert_cris(read_cris_state_dict(path), cfg, strategy)

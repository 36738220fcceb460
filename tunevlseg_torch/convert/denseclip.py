"""DenseCLIP state dicts (the reference's denseclip/models.py layout) -> the
JAX package's DenseCLIP trees.

The port's own copy of `tunevlseg_tpu/convert/denseclip.py`: library
functions for the backbone (RN, with its BatchNorm statistics apart), the
text encoder, the context decoder and the ViT backbone. No entry point
reads a pretrained DenseCLIP file, in the JAX package as here.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from tunevlseg_torch.convert.checkpoint_io import Tree
from tunevlseg_torch.convert.clipseg import _dense, _packed_mha
from tunevlseg_torch.convert.cris import _bn, _conv, _ln
from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig


def convert_backbone(sd: Mapping[str, np.ndarray], cfg: DenseCLIPConfig,
                     prefix: str = "") -> dict[str, Any]:
    p, s = Tree(), Tree()
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    for i in (1, 2, 3):
        _conv(p, f"conv{i}", sd, g(f"conv{i}"))
        _bn(p, s, f"bn{i}", sd, g(f"bn{i}"))
    for stage, blocks in enumerate(cfg.vision_layers, start=1):
        for b in range(blocks):
            src = g(f"layer{stage}.{b}")
            dst = f"layer{stage}_{b}"
            for ci in (1, 2, 3):
                _conv(p, f"{dst}/conv{ci}", sd, f"{src}.conv{ci}")
                _bn(p, s, f"{dst}/bn{ci}", sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                _conv(p, f"{dst}/downsample_conv", sd, f"{src}.downsample.0")
                _bn(p, s, f"{dst}/downsample_bn", sd, f"{src}.downsample.1")
    ap = g("attnpool")
    p.set("attnpool/positional_embedding", sd[f"{ap}.positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _dense(p, f"attnpool/{proj}", sd, f"{ap}.{proj}")
    return {"params": p, "batch_stats": s}


def convert_text_encoder(sd: Mapping[str, np.ndarray], cfg: DenseCLIPConfig,
                         prefix: str = "") -> dict[str, Any]:
    p = Tree()
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    p.set("token_embedding/embedding", sd[g("token_embedding.weight")])
    p.set("positional_embedding", sd[g("positional_embedding")])
    p.set("text_projection", sd[g("text_projection")])
    for i in range(cfg.transformer_layers):
        src = g(f"transformer.resblocks.{i}")
        dst = f"resblocks_{i}"
        _packed_mha(p, f"{dst}/self_attn", sd, f"{src}.attn")
        _ln(p, f"{dst}/layer_norm1", sd, f"{src}.ln_1")
        _ln(p, f"{dst}/layer_norm2", sd, f"{src}.ln_2")
        _dense(p, f"{dst}/mlp/fc1", sd, f"{src}.mlp.c_fc")
        _dense(p, f"{dst}/mlp/fc2", sd, f"{src}.mlp.c_proj")
    _ln(p, "ln_final", sd, g("ln_final"))
    return p


def convert_context_decoder(sd: Mapping[str, np.ndarray],
                            cfg: DenseCLIPConfig,
                            prefix: str = "") -> dict[str, Any]:
    p = Tree()
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    _ln(p, "memory_proj_0", sd, g("memory_proj.0"))
    _dense(p, "memory_proj_1", sd, g("memory_proj.1"))
    _ln(p, "memory_proj_2", sd, g("memory_proj.2"))
    _ln(p, "text_proj_0", sd, g("text_proj.0"))
    _dense(p, "text_proj_1", sd, g("text_proj.1"))
    for i in range(cfg.decoder_layers):
        src = g(f"decoder.{i}")
        dst = f"decoder_{i}"
        for attn in ("self_attn", "cross_attn"):
            for proj in ("q_proj", "k_proj", "v_proj"):
                _dense(p, f"{dst}/{attn}/{proj}", sd, f"{src}.{attn}.{proj}")
            _dense(p, f"{dst}/{attn}/proj", sd, f"{src}.{attn}.proj")
        for norm in ("norm1", "norm2", "norm3"):
            _ln(p, f"{dst}/{norm}", sd, f"{src}.{norm}")
        _dense(p, f"{dst}/mlp_0", sd, f"{src}.mlp.0")
        _dense(p, f"{dst}/mlp_3", sd, f"{src}.mlp.3")
    _ln(p, "out_proj_0", sd, g("out_proj.0"))
    _dense(p, "out_proj_1", sd, g("out_proj.1"))
    return p


def _gn(p: Tree, dst: str, sd, src: str) -> None:
    p.set(f"{dst}/scale", sd[f"{src}.weight"])
    p.set(f"{dst}/bias", sd[f"{src}.bias"])


def _deconv(p: Tree, dst: str, sd, src: str) -> None:
    # torch's ConvTranspose2d weight (I, O, k, k) is the tree's layout
    p.set(f"{dst}/weight", sd[f"{src}.weight"])
    p.set(f"{dst}/bias", sd[f"{src}.bias"])


def convert_vit_backbone(sd: Mapping[str, np.ndarray], cfg: DenseCLIPConfig,
                         prefix: str = "",
                         get_embeddings: bool = True) -> dict[str, Any]:
    """The reference's CLIPVisionTransformer (models.py:530) -> trees."""
    p, s = Tree(), Tree()
    g = lambda k: f"{prefix}{k}"  # noqa: E731
    _conv(p, "conv1", sd, g("conv1"))
    p.set("class_embedding", sd[g("class_embedding")])
    p.set("positional_embedding", sd[g("positional_embedding")])
    _ln(p, "ln_pre", sd, g("ln_pre"))
    for i in range(cfg.vit_layers):
        src = g(f"transformer.resblocks.{i}")
        dst = f"resblocks_{i}"
        _packed_mha(p, f"{dst}/self_attn", sd, f"{src}.attn")
        _ln(p, f"{dst}/layer_norm1", sd, f"{src}.ln_1")
        _ln(p, f"{dst}/layer_norm2", sd, f"{src}.ln_2")
        _dense(p, f"{dst}/mlp/fc1", sd, f"{src}.mlp.c_fc")
        _dense(p, f"{dst}/mlp/fc2", sd, f"{src}.mlp.c_proj")
    if cfg.patch_size == 16:
        _gn(p, "fpn1_gn", sd, g("fpn1.0"))
        _deconv(p, "fpn1_deconv1", sd, g("fpn1.1"))
        _bn(p, s, "fpn1_bn", sd, g("fpn1.2"))
        _deconv(p, "fpn1_deconv2", sd, g("fpn1.4"))
        _gn(p, "fpn2_gn", sd, g("fpn2.0"))
        _deconv(p, "fpn2_deconv", sd, g("fpn2.1"))
        _gn(p, "fpn3_gn", sd, g("fpn3"))
        _gn(p, "fpn4_gn", sd, g("fpn4.0"))
    else:  # patch 8
        _gn(p, "fpn1_gn", sd, g("fpn1.0"))
        _deconv(p, "fpn1_deconv", sd, g("fpn1.1"))
        _gn(p, "fpn2_gn", sd, g("fpn2"))
        _gn(p, "fpn3_gn", sd, g("fpn3.0"))
        _gn(p, "fpn4_gn", sd, g("fpn4.0"))
    if get_embeddings:
        _ln(p, "ln_post", sd, g("ln_post"))
        p.set("proj", sd[g("proj")])
    return {"params": p, "batch_stats": s}

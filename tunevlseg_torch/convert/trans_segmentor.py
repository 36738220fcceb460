"""HF CLIPModel / SiglipModel and the reference's TransformerSegmentor
checkpoints -> the JAX package's TransformerSegmentor tree.

The port's own copy of `tunevlseg_tpu/convert/trans_segmentor.py`. A
checkpoint may hold more than the port's model builds: SigLIP's vision
attention-pooling head (`vision_model.head.*`), which the segmentor does
not run, and CLIP's `visual_projection` where the model takes a fresh text
projection (`use_existing_proj: false`). `TRANS_SEGMENTOR_ELIDABLE` names
these places; `load_partial_state` drops what the model lacks there and
nothing else. `TRANS_SEGMENTOR_IGNORED`: the keys no converter reads.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from tunevlseg_torch.convert.checkpoint_io import Tree, read_state_dict
from tunevlseg_torch.convert.clipseg import (_dense, _encoder_layer,
                                             _layer_norm, _packed_mha,
                                             _torch_transformer_layer)
from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig

TRANS_SEGMENTOR_ELIDABLE = ("vision_model.probe", "vision_model.head_",
                            "visual_projection.")
TRANS_SEGMENTOR_IGNORED = ("position_ids", "logit_scale", "logit_bias")


def convert_hf_clip_model(sd: Mapping[str, np.ndarray],
                          cfg: TransSegmentorConfig, t: Tree) -> None:
    """`transformers.CLIPModel` keys (`text_model.` / `vision_model.` at the
    top) into `t`."""
    tm = "text_model"
    t.set("text_model/token_embedding/embedding",
          sd[f"{tm}.embeddings.token_embedding.weight"])
    t.set("text_model/position_embedding/embedding",
          sd[f"{tm}.embeddings.position_embedding.weight"])
    for i in range(cfg.text.num_layers):
        _encoder_layer(t, f"text_model/layers_{i}", sd, f"{tm}.encoder.layers.{i}")
    _layer_norm(t, "text_model/final_layer_norm", sd, f"{tm}.final_layer_norm")

    vm = "vision_model"
    t.set("vision_model/class_embedding", sd[f"{vm}.embeddings.class_embedding"])
    t.set("vision_model/position_embedding",
          sd[f"{vm}.embeddings.position_embedding.weight"])
    pw = sd[f"{vm}.embeddings.patch_embedding.weight"]
    t.set("vision_model/patch_proj", pw.reshape(pw.shape[0], -1).T)
    # CLIPModel names it pre_layrnorm (the same typo as CLIPSeg's)
    pre = (f"{vm}.pre_layrnorm" if f"{vm}.pre_layrnorm.weight" in sd
           else f"{vm}.pre_layernorm")
    _layer_norm(t, "vision_model/pre_layernorm", sd, pre)
    for i in range(cfg.vision.num_layers):
        _encoder_layer(t, f"vision_model/layers_{i}", sd, f"{vm}.encoder.layers.{i}")
    _layer_norm(t, "vision_model/post_layernorm", sd, f"{vm}.post_layernorm")
    if "text_projection.weight" in sd:
        _dense(t, "text_projection", sd, "text_projection")
    if "visual_projection.weight" in sd:
        _dense(t, "visual_projection", sd, "visual_projection")


def convert_hf_siglip_model(sd: Mapping[str, np.ndarray],
                            cfg: TransSegmentorConfig, t: Tree) -> None:
    """`transformers.SiglipModel` keys into `t`: no class embedding, a biased
    patch convolution, a text `head` Dense and, where the checkpoint has it,
    the vision attention-pooling head."""
    tm = "text_model"
    t.set("text_model/token_embedding/embedding",
          sd[f"{tm}.embeddings.token_embedding.weight"])
    t.set("text_model/position_embedding/embedding",
          sd[f"{tm}.embeddings.position_embedding.weight"])
    for i in range(cfg.text.num_layers):
        _encoder_layer(t, f"text_model/layers_{i}", sd, f"{tm}.encoder.layers.{i}")
    _layer_norm(t, "text_model/final_layer_norm", sd, f"{tm}.final_layer_norm")
    _dense(t, "text_model/head", sd, f"{tm}.head")

    vm = "vision_model"
    pw = sd[f"{vm}.embeddings.patch_embedding.weight"]   # (D, C, p, p)
    t.set("vision_model/patch_proj", pw.reshape(pw.shape[0], -1).T)
    t.set("vision_model/patch_bias", sd[f"{vm}.embeddings.patch_embedding.bias"])
    t.set("vision_model/position_embedding",
          sd[f"{vm}.embeddings.position_embedding.weight"])
    for i in range(cfg.vision.num_layers):
        _encoder_layer(t, f"vision_model/layers_{i}", sd, f"{vm}.encoder.layers.{i}")
    _layer_norm(t, "vision_model/post_layernorm", sd, f"{vm}.post_layernorm")
    if f"{vm}.head.probe" in sd:
        t.set("vision_model/probe", sd[f"{vm}.head.probe"])
        _packed_mha(t, "vision_model/head_attn", sd, f"{vm}.head.attention")
        _layer_norm(t, "vision_model/head_layernorm", sd, f"{vm}.head.layernorm")
        _dense(t, "vision_model/head_mlp_fc1", sd, f"{vm}.head.mlp.fc1")
        _dense(t, "vision_model/head_mlp_fc2", sd, f"{vm}.head.mlp.fc2")


def convert_encoder(sd: Mapping[str, np.ndarray],
                    cfg: TransSegmentorConfig) -> dict[str, Any]:
    """A bare CLIPModel / SiglipModel state dict (`cfg.encoder_family`) ->
    tree (the reference's `from_pretrained` encoder)."""
    t = Tree()
    if cfg.encoder_family == "siglip":
        convert_hf_siglip_model(sd, cfg, t)
    else:
        convert_hf_clip_model(sd, cfg, t)
    return t


def convert_trans_segmentor(sd: Mapping[str, np.ndarray],
                            cfg: TransSegmentorConfig) -> dict[str, Any]:
    """The reference's whole `TransformerSegmentor`: `encoder.model.*`,
    `encoder.text_projection` (when fresh), `decoder.transformer_decoder.
    layers.*`, `decoder.upsampler.*`."""
    enc = {k[len("encoder.model."):]: v for k, v in sd.items()
           if k.startswith("encoder.model.")}
    t = convert_encoder(enc, cfg)
    if "encoder.text_projection.weight" in sd:
        _dense(t, "text_projection", sd, "encoder.text_projection")

    for i in range(cfg.decoder_num_layers):
        src = f"decoder.transformer_decoder.layers.{i}"
        dst = f"decoder_layers_{i}"
        _torch_transformer_layer(t, dst, sd, src)
        _packed_mha(t, f"{dst}/multihead_attn", sd, f"{src}.multihead_attn")
        _layer_norm(t, f"{dst}/norm3", sd, f"{src}.norm3")
    _layer_norm(t, "decoder_norm", sd, "decoder.transformer_decoder.norm")

    # the upsampler: blocks [Upsample, Conv2d, norm?, act?], conv at index 1
    n = cfg.num_upsampler_layers
    for i in range(n - 1):
        t.set(f"upsampler/block{i}_conv/weight", sd[f"decoder.upsampler.{i}.1.weight"])
        if f"decoder.upsampler.{i}.1.bias" in sd:
            t.set(f"upsampler/block{i}_conv/bias", sd[f"decoder.upsampler.{i}.1.bias"])
        if f"decoder.upsampler.{i}.2.weight" in sd:
            _layer_norm(t, f"upsampler/block{i}_norm", sd, f"decoder.upsampler.{i}.2")
    t.set("upsampler/out_conv/weight", sd[f"decoder.upsampler.{n - 1}.1.weight"])
    if f"decoder.upsampler.{n - 1}.1.bias" in sd:
        t.set("upsampler/out_conv/bias", sd[f"decoder.upsampler.{n - 1}.1.bias"])
    return t


def load_trans_segmentor_checkpoint(path, cfg: TransSegmentorConfig
                                    ) -> dict[str, Any]:
    """A checkpoint file (Lightning's `state_dict` unwrapped) -> tree: the
    reference's whole TransformerSegmentor when keys start with
    `encoder.model.`, else a bare CLIPModel / SiglipModel."""
    sd = read_state_dict(path)
    if any(k.startswith("encoder.model.") for k in sd):
        return convert_trans_segmentor(sd, cfg)
    return convert_encoder(sd, cfg)

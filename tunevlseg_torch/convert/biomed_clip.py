"""open_clip BiomedCLIP (CustomTextCLIP) checkpoints -> the JAX package's
BiomedCLIP tree.

The port's own copy of `tunevlseg_tpu/convert/biomed_clip.py`. The source
is the state dict of open_clip's `hf-hub:microsoft/BiomedCLIP-PubMedBERT_
256-vit_base_patch16_224`:

  visual.trunk.*      timm vit_base_patch16_224 (fused qkv in each block)
  visual.head.proj.*  open_clip's TimmModel linear projection (no bias)
  text.transformer.*  HF BERT encoder (PubMedBERT)
  text.proj.{0,2}.*   open_clip's HFTextEncoder MLP projection (no bias)

The conventions of `convert/clipseg.py`; timm's fused `attn.qkv` splits into
q / k / v.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from tunevlseg_torch.convert.checkpoint_io import Tree, read_state_dict
from tunevlseg_torch.convert.clipseg import _dense, _layer_norm, _split_qkv
from tunevlseg_torch.models.zero_shot_ris.biomed_clip import BiomedCLIPConfig

# BERT's buffers and the contrastive temperature: the keys no converter reads
BIOMED_CLIP_IGNORED = ("position_ids", "token_type_ids", "logit_scale")


def _timm_block(tree: Tree, dst: str, sd: Mapping[str, np.ndarray],
                src: str) -> None:
    _layer_norm(tree, f"{dst}/layer_norm1", sd, f"{src}.norm1")
    _layer_norm(tree, f"{dst}/layer_norm2", sd, f"{src}.norm2")
    _split_qkv(tree, f"{dst}/self_attn", sd[f"{src}.attn.qkv.weight"],
               sd.get(f"{src}.attn.qkv.bias"))
    _dense(tree, f"{dst}/self_attn/out_proj", sd, f"{src}.attn.proj")
    _dense(tree, f"{dst}/mlp/fc1", sd, f"{src}.mlp.fc1")
    _dense(tree, f"{dst}/mlp/fc2", sd, f"{src}.mlp.fc2")


def _bert_layer(tree: Tree, dst: str, sd: Mapping[str, np.ndarray],
                src: str) -> None:
    for proj, name in (("q_proj", "query"), ("k_proj", "key"),
                       ("v_proj", "value")):
        _dense(tree, f"{dst}/self_attn/{proj}", sd, f"{src}.attention.self.{name}")
    _dense(tree, f"{dst}/self_attn/out_proj", sd, f"{src}.attention.output.dense")
    _layer_norm(tree, f"{dst}/layer_norm1", sd, f"{src}.attention.output.LayerNorm")
    _dense(tree, f"{dst}/mlp/fc1", sd, f"{src}.intermediate.dense")
    _dense(tree, f"{dst}/mlp/fc2", sd, f"{src}.output.dense")
    _layer_norm(tree, f"{dst}/layer_norm2", sd, f"{src}.output.LayerNorm")


def convert_biomed_clip(sd: Mapping[str, np.ndarray],
                        config: BiomedCLIPConfig) -> dict[str, Any]:
    """An open_clip CustomTextCLIP state dict (numpy values) -> tree."""
    t = Tree()
    vt = "visual.trunk"
    t.set("visual/cls_token", sd[f"{vt}.cls_token"].reshape(-1))
    pos = sd[f"{vt}.pos_embed"]
    t.set("visual/position_embedding", pos.reshape(pos.shape[-2], -1))
    pw = sd[f"{vt}.patch_embed.proj.weight"]   # (D, C, p, p)
    t.set("visual/patch_proj", pw.reshape(pw.shape[0], -1).T)
    t.set("visual/patch_bias", sd[f"{vt}.patch_embed.proj.bias"])
    for i in range(config.vision.num_layers):
        _timm_block(t, f"visual/blocks_{i}", sd, f"{vt}.blocks.{i}")
    _layer_norm(t, "visual/norm", sd, f"{vt}.norm")
    t.set("visual_head/kernel", sd["visual.head.proj.weight"].T)

    te = "text.transformer.embeddings"
    t.set("text_model/word_embedding/embedding", sd[f"{te}.word_embeddings.weight"])
    t.set("text_model/position_embedding", sd[f"{te}.position_embeddings.weight"])
    t.set("text_model/token_type_embedding",
          sd[f"{te}.token_type_embeddings.weight"])
    _layer_norm(t, "text_model/embed_norm", sd, f"{te}.LayerNorm")
    for i in range(config.text.num_layers):
        _bert_layer(t, f"text_model/layers_{i}", sd,
                    f"text.transformer.encoder.layer.{i}")
    t.set("text_proj_fc1/kernel", sd["text.proj.0.weight"].T)
    t.set("text_proj_fc2/kernel", sd["text.proj.2.weight"].T)
    return dict(t)


def read_biomedclip_state_dict(path) -> dict[str, np.ndarray]:
    """The flat state dict of a torch-saved open_clip checkpoint, as the JAX
    `load_biomedclip_checkpoint` reads it: `torch.load(weights_only=True)`,
    Lightning's `state_dict` unwrapped, `module.` removed from each key."""
    sd = read_state_dict(path, weights_only=True)
    return {k.removeprefix("module."): v for k, v in sd.items()}


def load_biomedclip_checkpoint(path, config: BiomedCLIPConfig) -> dict[str, Any]:
    return convert_biomed_clip(read_biomedclip_state_dict(path), config)

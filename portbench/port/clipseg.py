"""The program under test for a CLIPSeg configuration: the port's
`presets.build_clipseg` at the configuration's widths, bf16 compute over
f32 weights, in a `SegmentationTask` with the recipe's optimizer."""
from __future__ import annotations

import torch


def port_config(config: dict):
    from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                    CLIPVisionConfig)
    t, v = config["text_config"], config["vision_config"]
    return CLIPSegConfig(
        text=CLIPTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
            intermediate_size=t["intermediate_size"],
            max_position_embeddings=t["max_position_embeddings"],
            eos_token_id=t["eos_token_id"], hidden_act=t["hidden_act"],
            layer_norm_eps=t["layer_norm_eps"]),
        vision=CLIPVisionConfig(
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"],
            intermediate_size=v["intermediate_size"], patch_size=v["patch_size"],
            image_size=v["image_size"], hidden_act=v["hidden_act"],
            layer_norm_eps=v["layer_norm_eps"]),
        projection_dim=config["projection_dim"],
        extract_layers=tuple(config["extract_layers"]),
        reduce_dim=config["reduce_dim"],
        decoder_num_heads=config["decoder_num_attention_heads"],
        decoder_intermediate_size=config["decoder_intermediate_size"],
        conditional_layer=config["conditional_layer"],
        complex_transposed_convolution=config["use_complex_transposed_convolution"])


def build_task(config: dict, recipe: dict, device):
    """The task, its model's weights and buffers by name, uninitialised
    by the benchmark (the builder's own seeded draw)."""
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.task import SegmentationTask
    model, spec = build_clipseg(
        recipe["strategy"], prompt_depth=recipe.get("prompt_depth", 1),
        num_context=recipe.get("num_context", 4), config=port_config(config),
        dtype=getattr(torch, config["compute_dtype"]), device=device, seed=0)
    return SegmentationTask(model, spec, learning_rate=recipe["lr"],
                            weight_decay=recipe["weight_decay"])

"""Model hyperparameter dataclasses for the CLIP/CLIPSeg family.

The port's own copy of `tunevlseg_tpu/models/clip/config.py` (same fields,
same defaults, same `tiny()`): the port imports nothing of the JAX package.
Mirrors the capability surface of HF `CLIPSegConfig` (CIDAS/clipseg-rd64) as
plain frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 77
    eos_token_id: int = 2
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 224  # pretraining grid; inputs may differ (pos-emb resized)
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPSegConfig:
    text: CLIPTextConfig = CLIPTextConfig()
    vision: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512
    extract_layers: Sequence[int] = (3, 6, 9)
    reduce_dim: int = 64
    decoder_num_heads: int = 4
    decoder_intermediate_size: int = 2048
    conditional_layer: int = 0
    # "rd64-refined" checkpoints use the 3-stage transposed-conv head,
    # plain "rd64" a single ConvTranspose(patch, stride=patch).
    complex_transposed_convolution: bool = False

    @staticmethod
    def tiny(**kw) -> "CLIPSegConfig":
        """A scaled-down config for fast tests (same topology). The vocabulary
        keeps its real size, so tiny models still take real BPE ids."""
        base = dict(
            text=CLIPTextConfig(
                vocab_size=49408, hidden_size=16, num_layers=4, num_heads=2,
                intermediate_size=32, max_position_embeddings=77),
            vision=CLIPVisionConfig(
                hidden_size=24, num_layers=4, num_heads=2, intermediate_size=48,
                patch_size=16, image_size=32),
            projection_dim=20,
            extract_layers=(1, 2, 3),
            reduce_dim=8,
            decoder_num_heads=2,
            decoder_intermediate_size=16,
        )
        base.update(kw)
        return CLIPSegConfig(**base)

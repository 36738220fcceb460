"""Named model presets.

Counterpart of `tunevlseg_tpu/models/presets.py` for the CLIPSeg family. The
flagship model is CLIPSeg ViT-B/16 ("CIDAS/clipseg-rd64") with CoOp prompts.
Weights are random, drawn from one seeded `torch.Generator` on the CPU (so a
seed gives the same weights on every device), until converted weights are
loaded over them (`tunevlseg_torch/convert/from_jax.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from tunevlseg_tpu.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                              CLIPVisionConfig)
from tunevlseg_torch.models.clipseg.model import (CLIPSegForSegmentation,
                                                  strategy_additive_mode)
from tunevlseg_torch.models.prompt.learners import CoOpLearner
from tunevlseg_torch.nn.layers import init_params


def clipseg_rd64_config(complex_head: bool = False) -> CLIPSegConfig:
    """CIDAS/clipseg-rd64(-refined): CLIP ViT-B/16 + 512-wide text tower."""
    return CLIPSegConfig(
        text=CLIPTextConfig(),          # 512 hidden, 12 layers, 8 heads
        vision=CLIPVisionConfig(),      # ViT-B/16: 768 hidden, 12 layers
        projection_dim=512,
        extract_layers=(3, 6, 9),
        reduce_dim=64,
        decoder_num_heads=4,
        decoder_intermediate_size=2048,
        conditional_layer=0,
        complex_transposed_convolution=complex_head,
    )


def build_clipseg(strategy: Optional[str] = "coop", prompt_depth: int = 1,
                  num_context: int = 4, config: Optional[CLIPSegConfig] = None,
                  use_new_last_layer: bool = True,
                  dtype: torch.dtype = torch.float32, device=None,
                  seed: int = 0) -> CLIPSegForSegmentation:
    """Build a CLIPSeg model for a strategy ("coop", or None / "e2e" for the
    stock model) with seeded random f32 weights on `device`; `dtype` is the
    compute dtype."""
    cfg = config or clipseg_rd64_config()
    learner = None
    if strategy == "coop":
        learner = CoOpLearner(prompt_depth=prompt_depth, num_context=num_context,
                              context_dim=cfg.text.hidden_size, dtype=dtype)
        learner.check_depth(prompt_depth,
                            min(cfg.text.num_layers, cfg.vision.num_layers))
    elif strategy not in (None, "e2e"):
        raise NotImplementedError(
            f"strategy {strategy!r} comes with ROADMAP Slice B; the port has "
            "coop and e2e")
    model = CLIPSegForSegmentation(
        cfg, learner=learner,
        additive_mode=strategy_additive_mode(strategy, use_new_last_layer),
        dtype=dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(device)

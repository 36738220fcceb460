"""Named model presets.

Counterpart of `tunevlseg_tpu/models/presets.py` for the CLIPSeg and CRIS
families. The flagship model is CLIPSeg ViT-B/16 ("CIDAS/clipseg-rd64") with
CoOp prompts; CRIS is CLIP RN50 with the FPN / decoder / projector head.
Weights are random, drawn from one seeded `torch.Generator` on the CPU (so a
seed gives the same weights on every device), until converted weights are
loaded over them (`tunevlseg_torch/convert/from_jax.py`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                CLIPVisionConfig)
from tunevlseg_torch.models.clipseg.model import (CLIPSegForSegmentation,
                                                  strategy_additive_mode)
from tunevlseg_torch.models.cris.model import CRISConfig, CRISForSegmentation
from tunevlseg_torch.models.prompt.learners import CoOpLearner
from tunevlseg_torch.nn.layers import init_params
from tunevlseg_torch.training.optim import FreezeSpec


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
                  use_new_last_layer: bool = True, freeze_all: bool = True,
                  no_freeze_last_layer: bool = False,
                  freeze_encoder: Optional[bool] = None,
                  freeze_decoder: bool = False,
                  dtype: torch.dtype = torch.float32, device="cuda",
                  seed: int = 0) -> tuple[CLIPSegForSegmentation, FreezeSpec]:
    """Build the model and its freeze spec for a strategy ("coop", or None /
    "e2e" for the stock model, a full fine-tune) with seeded random f32
    weights on `device`; `dtype` is the compute dtype. The model goes to the
    CUDA card unless the caller names another device (the CPU parity tests
    pass "cpu"); without a card the default raises, it never falls back to
    the CPU. The spec is applied by `SegmentationTask.init`."""
    cfg = config or clipseg_rd64_config()
    e2e = strategy in (None, "e2e")
    learner = None
    if strategy == "coop":
        learner = CoOpLearner(prompt_depth=prompt_depth, num_context=num_context,
                              context_dim=cfg.text.hidden_size, dtype=dtype)
        learner.check_depth(prompt_depth,
                            min(cfg.text.num_layers, cfg.vision.num_layers))
    elif not e2e:
        raise NotImplementedError(
            f"strategy {strategy!r} comes with ROADMAP Slice B; the port has "
            "coop and e2e")
    model = CLIPSegForSegmentation(
        cfg, learner=learner,
        additive_mode=strategy_additive_mode(strategy, use_new_last_layer),
        dtype=dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    spec = FreezeSpec(
        freeze_all=False if e2e else freeze_all,
        # zero-shot surface: stock net with frozen CLIP towers, trainable decoder
        freeze_encoder=bool(freeze_encoder),
        freeze_decoder=freeze_decoder,
        no_freeze_last_layer=no_freeze_last_layer,
        use_new_last_layer=use_new_last_layer and not e2e,
        complex_head=cfg.complex_transposed_convolution)
    return model.to(device), spec


def cris_rn50_config(img_size: int = 416) -> CRISConfig:
    """The canonical CRIS recipe: CLIP RN50 + FPN / decoder / projector head."""
    return CRISConfig(img_size=img_size)


def build_cris(strategy: Optional[str] = "coop", prompt_depth: int = 1,
               num_context: int = 4, config: Optional[CRISConfig] = None,
               use_new_last_layer: bool = True, freeze_all: bool = True,
               no_freeze_last_layer: bool = False,
               freeze_encoder: Optional[bool] = None,
               layout: str = "nchw",
               flat_stages: Sequence[str] = ("stem", "1", "2", "3", "4"),
               dtype: torch.dtype = torch.float32, device="cuda",
               seed: int = 0) -> tuple[CRISForSegmentation, FreezeSpec]:
    """CRIS with CoOp prompts ("coop") or the stock model (None / "e2e"),
    with seeded random f32 weights on `device`, and its freeze spec. The
    device rule is `build_clipseg`'s: the CUDA card unless the caller names
    another device, and no fallback to the CPU. The learner's context width
    is the text transformer's width. `layout="flat"` runs the backbone stages
    named in `flat_stages` through the flat convolution K4
    (`ops/conv_flat.py`; the JAX package's TUNEVLSEG_PALLAS_CONV); the default
    "nchw" runs them through cuDNN. The e2e model trains the BatchNorms of
    its FPN and projector: give its `SegmentationTask`
    `mutable_collections=("batch_stats",)`. With `freeze_encoder=False` the
    towers train too (on the flat layout through K4's backward). "cocoop"
    raises (ROADMAP Slice B)."""
    cfg = config or cris_rn50_config()
    e2e = strategy in (None, "e2e")
    learner = None
    if strategy == "coop":
        learner = CoOpLearner(prompt_depth=prompt_depth, num_context=num_context,
                              context_dim=cfg.transformer_width, dtype=dtype)
        learner.check_depth(prompt_depth, cfg.transformer_layers)
    elif strategy == "cocoop":
        raise NotImplementedError(
            "CoCoOp on CRIS comes with ROADMAP Slice B; the port has coop and e2e")
    elif not e2e:
        raise ValueError(f"CRIS supports coop/cocoop, got {strategy}")
    model = CRISForSegmentation(
        cfg, learner=learner,
        additive_mode="residual" if use_new_last_layer and not e2e else "none",
        bn_train=e2e, layout=layout, flat_stages=flat_stages, dtype=dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    spec = FreezeSpec(
        freeze_all=False if e2e else freeze_all,
        # CRIS default: frozen CLIP towers in the e2e fine-tune
        freeze_encoder=e2e if freeze_encoder is None else freeze_encoder,
        no_freeze_last_layer=no_freeze_last_layer,
        use_new_last_layer=use_new_last_layer and not e2e,
        family="cris")
    # the backbone's convolution weights channels-last, as it stores its
    # tensors (models/cris/resnet.py); shapes and state_dict names stay
    model.to(device).visual.to(memory_format=torch.channels_last)
    return model, spec

"""Named model presets.

Counterpart of `tunevlseg_tpu/models/presets.py` for the CLIPSeg and CRIS
families, and of the TransformerSegmentor's build in `tunevlseg_tpu/train.py`.
The flagship model is CLIPSeg ViT-B/16 ("CIDAS/clipseg-rd64") with CoOp
prompts; CRIS is CLIP RN50 with the FPN / decoder / projector head; the
TransformerSegmentor is CLIP ViT-B/16 (or SigLIP) towers with a transformer
decoder and a convolutional upsampler, fine-tuned whole; DenseCLIP (RN50,
RN101 or ViT-B/16 with the context decoder and the FPN head) trains end to
end through its own task (`training/denseclip_task.py`).
Weights are random, drawn from one seeded `torch.Generator` on the CPU (so a
seed gives the same weights on every device), until converted weights are
loaded over them (`tunevlseg_torch/convert/`: a checkpoint's converter, then
`from_jax.py`'s name map; `train.load_pretrained`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                CLIPVisionConfig)
from tunevlseg_torch.models.clipseg.model import (CLIPSegForSegmentation,
                                                  strategy_additive_mode)
from tunevlseg_torch.models.cris.model import CRISConfig, CRISForSegmentation
from tunevlseg_torch.models.denseclip.model import DenseCLIP, DenseCLIPConfig
from tunevlseg_torch.models.prompt.learners import (LEARNER_REGISTRY,
                                                    CoCoOpLearner, CoOpLearner)
from tunevlseg_torch.models.trans_segmentor.model import (TransformerSegmentor,
                                                          TransSegmentorConfig)
from tunevlseg_torch.nn.layers import init_params
from tunevlseg_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
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


def default_learner_kwargs(strategy: str, cfg: CLIPSegConfig) -> dict:
    """Per-strategy widths wired from the model config, and the projector
    settings of the reference's model configs."""
    t, v, p = cfg.text.hidden_size, cfg.vision.hidden_size, cfg.projection_dim
    return {
        "coop": dict(context_dim=t),
        "cocoop": dict(context_dim=t, visual_dim=p, norm_image_features=False,
                       use_unified_projection=False, intermediate_dims=(64,),
                       use_proj_norm=True),
        "vpt": dict(context_dim=v),
        "maple": dict(context_dim=t, visual_dim=v,
                      use_unified_projection=False, intermediate_dims=(64,),
                      use_proj_norm=True),
        "shared_separate": dict(context_dim=64, textual_dim=t, visual_dim=v,
                                use_unified_projection=False,
                                use_proj_norm=True),
        "shared_attn": dict(context_dim=t + v, textual_dim=t, visual_dim=v,
                            use_unified_projection=False, proj_num_heads=16,
                            proj_dim_feedforward=1536, proj_dropout=0.25),
    }[strategy]


def build_clipseg(strategy: Optional[str] = "coop", prompt_depth: int = 1,
                  num_context: int = 4, config: Optional[CLIPSegConfig] = None,
                  use_new_last_layer: bool = True, freeze_all: bool = True,
                  no_freeze_last_layer: bool = False,
                  freeze_encoder: Optional[bool] = None,
                  freeze_decoder: bool = False,
                  learner_overrides: Optional[dict] = None,
                  initializer_embeddings=None,
                  dtype: torch.dtype = torch.float32, device="cuda",
                  seed: int = 0) -> tuple[CLIPSegForSegmentation, FreezeSpec]:
    """Build the model and its freeze spec for a strategy ("coop", "cocoop",
    "vpt", "maple", "shared_separate", "shared_attn", or None / "e2e" for
    the stock model, a full fine-tune) with seeded random f32 weights on
    `device`; `dtype` is the compute dtype. `learner_overrides` replaces
    entries of `default_learner_kwargs`; `initializer_embeddings` (the
    embedded initializer text) goes to the learners whose parameters are
    textual contexts. The model goes to the CUDA card unless the caller names
    another device (the CPU parity tests pass "cpu"); without a card the
    default raises, it never falls back to the CPU. The spec is applied by
    `SegmentationTask.init`."""
    cfg = config or clipseg_rd64_config()
    e2e = strategy in (None, "e2e")
    learner = None
    if not e2e:
        if strategy not in LEARNER_REGISTRY:
            raise ValueError(f"unknown strategy {strategy!r}: one of "
                             f"{sorted(LEARNER_REGISTRY)}, or None / 'e2e'")
        kwargs = default_learner_kwargs(strategy, cfg)
        kwargs.update(learner_overrides or {})
        if (strategy in ("coop", "cocoop", "maple")
                and initializer_embeddings is not None):
            kwargs["initializer_embeddings"] = initializer_embeddings
        learner = LEARNER_REGISTRY[strategy](
            prompt_depth=prompt_depth, num_context=num_context, dtype=dtype,
            **kwargs)
        learner.check_depth(prompt_depth,
                            min(cfg.text.num_layers, cfg.vision.num_layers))
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
               learner_overrides: Optional[dict] = None,
               initializer_embeddings=None,
               dtype: torch.dtype = torch.float32, device="cuda",
               seed: int = 0) -> tuple[CRISForSegmentation, FreezeSpec]:
    """CRIS with CoOp or CoCoOp prompts ("coop", "cocoop": the strategies the
    reference wires to CRIS) or the stock model (None / "e2e"), with seeded
    random f32 weights on `device`, and its freeze spec. CoCoOp's meta-net
    reads the mean of the last backbone feature (`embed_dim` wide), and its
    text stack is per image (no prompt dedup). The
    device rule is `build_clipseg`'s: the CUDA card unless the caller names
    another device, and no fallback to the CPU. The learner's context width
    is the text transformer's width. `layout="flat"` runs the backbone stages
    named in `flat_stages` through the flat convolution K4
    (`ops/conv_flat.py`; the JAX package's TUNEVLSEG_PALLAS_CONV); the default
    "nchw" runs them through cuDNN. The e2e model trains the BatchNorms of
    its FPN and projector: give its `SegmentationTask`
    `mutable_collections=("batch_stats",)`. With `freeze_encoder=False` the
    towers train too (on the flat layout through K4's backward)."""
    cfg = config or cris_rn50_config()
    e2e = strategy in (None, "e2e")
    learner = None
    if not e2e:
        common = dict(prompt_depth=prompt_depth, num_context=num_context,
                      context_dim=cfg.transformer_width, dtype=dtype,
                      initializer_embeddings=initializer_embeddings)
        if strategy == "coop":
            learner = CoOpLearner(**common)
        elif strategy == "cocoop":
            learner = CoCoOpLearner(
                **{**dict(visual_dim=cfg.embed_dim, norm_image_features=False,
                          use_unified_projection=False, intermediate_dims=(64,),
                          use_proj_norm=True),
                   **common, **(learner_overrides or {})})
        else:
            raise ValueError(f"CRIS supports coop/cocoop, got {strategy}")
        learner.check_depth(prompt_depth, cfg.transformer_layers)
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


def trans_segmentor_head_dims(config: TransSegmentorConfig) -> dict[str, int]:
    """The head dim of each attention of the model: the two towers' and the
    decoder's (its width over `decoder_num_heads`)."""
    c = config
    return {"text tower": c.text.hidden_size // c.text.num_heads,
            "vision tower": c.vision.hidden_size // c.vision.num_heads,
            "decoder": c.effective_projection_dim // c.decoder_num_heads}


def unbuilt_head_dims(config: TransSegmentorConfig) -> dict[str, int]:
    """The attentions of the model whose head dim K1, K2 and K3 are not
    built for (`SUPPORTED_HEAD_DIMS`), by name; empty for every
    configuration in `configs/model/`."""
    return {k: d for k, d in trans_segmentor_head_dims(config).items()
            if d not in SUPPORTED_HEAD_DIMS}


def build_trans_segmentor(config: Optional[TransSegmentorConfig] = None,
                          freeze_encoders: bool = False,
                          upsampler_layout: str = "nchw",
                          dtype: torch.dtype = torch.float32, device="cuda",
                          seed: int = 0
                          ) -> tuple[TransformerSegmentor, FreezeSpec]:
    """The TransformerSegmentor (by default the CLIP ViT-B/16 one of
    `bench.py`'s trans_seg row) with seeded random f32 weights on `device`,
    and its freeze spec: `freeze_encoders` freezes the towers and the
    existing projections; a fresh text projection (`use_existing_proj`
    False) always trains; the decoder and the upsampler always train. The
    device rule is `build_clipseg`'s. `upsampler_layout="flat"` runs the
    upsampler's convolutions through K4 (channels padded to multiples of 8);
    the default "nchw" through cuDNN.

    On a CUDA device every attention of the model runs on K1 / K3 (and K2),
    which are built for head dims 16, 32, 64 and 96 (`model=trans_seg_siglip`,
    whose decoder is 768 wide with 8 heads: 96): a model with another head
    dim raises here, before anything is built."""
    cfg = config or TransSegmentorConfig()
    if torch.device(device).type == "cuda":
        unbuilt = unbuilt_head_dims(cfg)
        if unbuilt:
            raise NotImplementedError(
                f"head dims {unbuilt}: K1, K2 and K3 are built for "
                f"{SUPPORTED_HEAD_DIMS}; a TransformerSegmentor with another "
                "head dim builds and runs on the CPU only")
    model = TransformerSegmentor(cfg, upsampler_layout=upsampler_layout,
                                 dtype=dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    spec = FreezeSpec(
        freeze_all=False, freeze_encoder=freeze_encoders,
        family="trans_segmentor",
        always_trainable=(() if cfg.use_existing_proj else ("text_projection",)))
    return model.to(device), spec


def build_denseclip(config: Optional[DenseCLIPConfig] = None,
                    class_token_ids=None, *, bn_train: bool = False,
                    backbone_layout: str = "nchw",
                    dtype: torch.dtype = torch.float32, device="cuda",
                    seed: int = 0) -> DenseCLIP:
    """DenseCLIP (by default the ADE-150 RN50 512^2 recipe,
    `DenseCLIPConfig()`) with seeded random f32 weights on `device`, and
    `class_token_ids` (K, text_context_length) as its classes (or give them
    to each call). `bn_train` normalises the backbone with batch statistics
    in a train step (`DenseCLIPTask` keeps the running ones in its state).
    `backbone_layout="flat"` runs the ResNet's stem tail and stages through
    K4 whenever the BatchNorms use running statistics (serving, eval; a
    `bn_train` train step runs "nchw"); the default "nchw" through cuDNN, its
    convolution weights stored channels-last as CRIS's are. The device rule
    is `build_clipseg`'s: the CUDA card unless the caller names another
    device, no fallback to the CPU. Every published DenseCLIP configuration
    has heads of 64, which K1 and K3 take (a bf16 model with heads of 8, as
    the tiny test configs have, raises at its first kernel call on the
    card). The text encoder's freezing and the paramwise groups are the
    task's (`training/denseclip_task.py`)."""
    cfg = config or DenseCLIPConfig()
    model = DenseCLIP(cfg, class_token_ids, bn_train=bn_train,
                      backbone_layout=backbone_layout, dtype=dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    model.to(device)
    if cfg.backbone_type == "resnet":
        model.backbone.to(memory_format=torch.channels_last)
    return model

"""CRIS referring-segmentation model with CoOp / CoCoOp prompt support.

Counterpart of `tunevlseg_tpu/models/cris/model.py`:

  * CLIP RN50 backbone: the ModifiedResNet pyramid and a causal text
    transformer with the key-padding mask threaded into every block;
  * text prompt surgery: splice at the embedding, then a per-block overwrite
    AFTER block i while the 0-BASED block index i < prompt_depth (the CLIPSeg
    tower's loop is 1-based: here depth 1 re-injects ctx[0] after block 0);
  * EOS pooling at argmax(input_ids) + num_context, clamped to
    context_length - 1;
  * pad mask = 1 - attention_mask (or ids == 0), extended with ZEROS for the
    context slots, used for the text self-attention and the decoder's
    cross-attention alike;
  * FPN fusion -> cross-attention decoder -> dynamic-conv projector ->
    bicubic (align_corners=True) upsample to img_size;
  * the additive head over the decoder output ("residual"): conv 1x1
    (no bias) -> bilinear resize to img_size -> conv k5 with replicate
    padding, blended by `residual_ratio`.

Spans (`utils/profiling.py`): the forward times its five stages as
`cris.visual` (the ResNet and its attention pool), `cris.text` (the prompt
learner, the text tower and the `text_index` gather), `cris.neck`,
`cris.decoder` and `cris.head` (the projector, the bicubic upsample and the
additive head): host spans when eager, pairs of timing events inside a
captured train step.

`text_index` deduplicates prompts as in the CLIPSeg model. Dropout (the
decoder's) is applied only with `deterministic=False` and draws its masks
from the `generator` it is given.

BatchNorm: the backbone always normalises with its running statistics (which
is why `layout="flat"` can fold them into the flat convolution K4). A
`bn_train` model (the e2e fine-tune) normalises the FPN and the projector with
batch statistics when `deterministic=False` and with the running ones
otherwise, and puts the updated running statistics into the caller's
`stats_updates` dict under their `state_dict` names instead of writing its
buffers (the JAX `mutable=["batch_stats"]`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from tunevlseg_torch.models.clip.text import extend_text_mask, splice_text_context
from tunevlseg_torch.models.cris.layers import (CRISTransformerDecoder, FPN,
                                                Projector)
from tunevlseg_torch.models.cris.resnet import ModifiedResNet, name_stats_updates
from tunevlseg_torch.models.prompt.learners import BasePromptLearner
from tunevlseg_torch.nn import remat
from tunevlseg_torch.nn.attention import causal_bias, padding_bias
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.nn.layers import Embed, LayerNorm, PreNormEncoderLayer
from tunevlseg_torch.ops.image import resize_2d
from tunevlseg_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class CRISConfig:
    # vision (RN50)
    vision_layers: Sequence[int] = (3, 4, 6, 3)
    vision_width: int = 64
    vision_heads: int = 32
    image_resolution: int = 224
    embed_dim: int = 1024              # CLIP joint dim == word_dim
    # text
    vocab_size: int = 49408
    context_length: int = 77
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # head
    fpn_in: Sequence[int] = (512, 1024, 1024)
    fpn_out: Sequence[int] = (256, 512, 1024)
    vis_dim: int = 512
    num_layers: int = 3
    num_head: int = 8
    dim_ffn: int = 2048
    dropout: float = 0.2
    img_size: int = 416

    @staticmethod
    def tiny(**kw) -> "CRISConfig":
        # transformer_width == embed_dim so that a randomly initialised
        # context learner is usable; vision_heads = width * 32 // 64
        base = dict(
            vision_layers=(1, 1, 1, 1), vision_width=16, vision_heads=8,
            image_resolution=64, embed_dim=24, vocab_size=49408,
            context_length=77, transformer_width=24, transformer_heads=2,
            transformer_layers=3,
            fpn_in=(128, 256, 24), fpn_out=(16, 24, 32),
            vis_dim=24, num_layers=2, num_head=2, dim_ffn=16,
            dropout=0.0, img_size=64)
        base.update(kw)
        return CRISConfig(**base)


class CLIPTextTransformer(nn.Module):
    """OpenAI-layout CLIP text encoder with CRIS's prompt hooks."""

    def __init__(self, config: CRISConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.token_embedding = Embed(c.vocab_size, c.transformer_width, dtype)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.context_length, c.transformer_width))
        self.resblocks = nn.ModuleList(
            PreNormEncoderLayer(c.transformer_width, c.transformer_heads,
                                c.transformer_width * 4, "quick_gelu", 1e-5, dtype)
            for _ in range(c.transformer_layers))
        self.ln_final = LayerNorm(c.transformer_width, 1e-5, dtype)
        self.text_projection = nn.Parameter(
            torch.empty(c.transformer_width, c.embed_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        self.positional_embedding.normal_(0.0, 0.01, generator=generator)
        self.text_projection.normal_(0.0, self.config.transformer_width ** -0.5,
                                     generator=generator)

    def forward(self, input_ids: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None,   # (B, L') True = pad
                text_ctx: Optional[torch.Tensor] = None,
                prompt_depth: int = 0, max_length: Optional[int] = None):
        """Returns (tokens (B, L', W), pooled state (B, embed_dim))."""
        c = self.config
        max_length = max_length or c.context_length
        x = self.token_embedding(input_ids)
        num_ctx = 0
        if text_ctx is not None:
            num_ctx = text_ctx.shape[-2]
            x = splice_text_context(x, text_ctx[0], max_length)
        seq = x.shape[1]
        x = x + self.positional_embedding[:seq].to(x.dtype)

        bias = causal_bias(seq, torch.float32, device=x.device)
        if pad_mask is not None:
            bias = bias + padding_bias(1 - pad_mask.to(torch.int32), torch.float32)

        for i, block in enumerate(self.resblocks):
            x = remat.layer_call(block, x, bias)
            # 0-based overwrite AFTER block i
            if text_ctx is not None and i < prompt_depth:
                ctx_i = text_ctx[i].to(x.dtype)
                x = torch.cat([x[:, :1], ctx_i.expand(x.shape[0], *ctx_i.shape[-2:]),
                               x[:, 1 + num_ctx:]], dim=1)

        x = self.ln_final(x)
        pool_idx = torch.argmax(input_ids.to(torch.int32), dim=-1)
        if num_ctx:
            pool_idx = (pool_idx + num_ctx).clamp(max=max_length - 1)
        pooled = x[torch.arange(x.shape[0], device=x.device), pool_idx]
        return x, pooled @ self.text_projection.to(pooled.dtype)


class CRISForSegmentation(nn.Module):
    def __init__(self, config: CRISConfig,
                 learner: Optional[BasePromptLearner] = None,
                 additive_mode: str = "none", additive_kernel_size: int = 5,
                 residual_ratio_init: float = 0.5, bn_train: bool = False,
                 layout: str = "nchw",
                 flat_stages: Sequence[str] = ("stem", "1", "2", "3", "4"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if additive_mode not in ("none", "residual"):
            raise ValueError('additive_mode must be "none" or "residual"')
        c = self.config = config
        self.additive_mode = additive_mode
        self.residual_ratio_init = residual_ratio_init
        self.bn_train = bn_train           # train-mode BN of the e2e fine-tune
        self.visual = ModifiedResNet(tuple(c.vision_layers), c.embed_dim,
                                     c.vision_heads, c.image_resolution,
                                     c.vision_width, use_running_average=True,
                                     layout=layout, flat_stages=flat_stages,
                                     dtype=dtype)
        self.text = CLIPTextTransformer(c, dtype)
        self.neck = FPN(tuple(c.fpn_in), tuple(c.fpn_out), dtype)
        self.decoder = CRISTransformerDecoder(c.num_layers, c.vis_dim, c.num_head,
                                              c.dim_ffn, c.dropout, dtype)
        self.proj = Projector(c.embed_dim, c.vis_dim // 2, 3, dtype)
        self.learner = learner
        if additive_mode == "residual":
            self.additive_conv1 = Conv2d(c.vis_dim, 64, 1, bias=False, dtype=dtype)
            self.additive_conv2 = Conv2d(64, 1, additive_kernel_size,
                                         padding="same", pad_mode="replicate",
                                         dtype=dtype)
            self.residual_ratio = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.additive_mode == "residual":
            self.residual_ratio.fill_(self.residual_ratio_init)

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                text_index: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                stats_updates: Optional[dict] = None) -> torch.Tensor:
        """input_ids (B, L), or (U, L) with text_index (B,) into its rows;
        pixel_values (B, 3, H, W). Returns logits (B, 1, img_size, img_size).
        A `bn_train` model called with `deterministic=False` needs the
        `stats_updates` dict, which it fills with the new running statistics
        of the FPN's and the projector's BatchNorms."""
        c = self.config
        learner = self.learner
        num_ctx = learner.num_context if learner is not None else 0
        prompt_depth = learner.prompt_depth if learner is not None else 0
        need_pooled = learner is not None and learner.needs_image_features
        if need_pooled and text_index is not None:
            raise ValueError(
                "text_index (prompt dedup) is incompatible with image-"
                "conditioned prompt learners (CoCoOp)")
        # batch statistics while training, running statistics in eval (torch's
        # train() / eval()); a frozen model always uses the running ones
        bn_ura = (not self.bn_train) or deterministic
        if not bn_ura and stats_updates is None:
            raise ValueError(
                "a bn_train model in a train step updates its BatchNorm "
                "running statistics: pass stats_updates (SegmentationTask with "
                'mutable_collections=("batch_stats",))')
        updates = None if bn_ura else {}

        # pad mask (True = pad), extended with zeros for the context slots
        if attention_mask is not None:
            pad = 1 - attention_mask.to(torch.int32)
        else:
            pad = (input_ids == 0).to(torch.int32)
        if num_ctx:
            pad = extend_text_mask(pad, num_ctx, c.context_length, 0)
        pad_mask = pad.bool()

        # vision first: CoCoOp's meta-net reads the pooled last feature
        with profiling.span("cris.visual"):
            vis = self.visual(pixel_values)
        with profiling.span("cris.text"):
            text_ctx = None
            if learner is not None:
                image_features = vis[-1].mean(dim=(2, 3)) if need_pooled else None
                text_ctx = learner(image_features=image_features,
                                   deterministic=deterministic,
                                   generator=generator).text
            tokens, state = self.text(input_ids, pad_mask=pad_mask, text_ctx=text_ctx,
                                      prompt_depth=prompt_depth,
                                      max_length=c.context_length)
            if text_index is not None:
                idx = text_index.long()
                tokens, state, pad_mask = tokens[idx], state[idx], pad_mask[idx]

        with profiling.span("cris.neck"):
            fq = self.neck(vis, state, use_running_average=bn_ura, updates=updates)
        with profiling.span("cris.decoder"):
            fq = self.decoder(fq, tokens, pad_mask, deterministic=deterministic,
                              generator=generator)
        with profiling.span("cris.head"):
            pred = self.proj(fq, state, use_running_average=bn_ura, updates=updates)
            if updates:
                name_stats_updates(self, updates, stats_updates)
            logits = resize_2d(pred, (c.img_size, c.img_size), "bicubic",
                               align_corners=True)
            if self.additive_mode == "residual":
                head = resize_2d(self.additive_conv1(fq), (c.img_size, c.img_size),
                                 "bilinear")
                head = self.additive_conv2(head)
                r = self.residual_ratio.to(logits.dtype)
                logits = (1 - r) * logits + r * head
        return logits

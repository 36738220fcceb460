"""DenseCLIP: language-guided semantic segmentation.

Counterpart of `tunevlseg_tpu/models/denseclip/model.py` (the reference's
DenseCLIP, trained through mmseg there):

  * `CLIPResNetWithAttention`: the CLIP ModifiedResNet pyramid (four stages)
    and the attention pool, which returns the (global, spatial) pair: a
    mean-prepended CLS token and the positions bilinearly resized in f32.
    At 512^2 the pool attends over 16^2 + 1 = 257 tokens with 32 heads of
    64 dims;
  * `CLIPTextContextEncoder`: the causal CLIP text transformer over
    [BOS, learned context, class tokens], positions truncated to the
    sequence, EOS pooling at argmax(ids) + the context length. The learned
    contexts have batch 1, so the encoder runs once on the K class rows a
    forward (K rows of 13 tokens in the ADE-150 recipe) and its output is
    broadcast over the image batch, as in the JAX package;
  * `ContextDecoder`: the class embeddings attending to the visual context
    (global + spatial tokens) through pre-norm layers with bias-free q / k /
    v; no dropout is applied there (the JAX layer ignores it too);
  * the glue: a per-class score map from the normalised embeddings,
    concatenated onto the `score_concat_index` stage, `text + gamma *
    text_diff` with gamma initialised to 1e-4;
  * mmseg's FPN neck (nearest top-down by repeat and crop) and FPNHead
    (3x3 conv, GroupNorm(32) with f32 statistics, ReLU, bilinear resize to
    the finest level, Dropout2d while training, 1x1 classifier);
  * `CLIPVisionTransformerBackbone`: the ViT-B/16 variant, with DropPath, the
    CLS-position quirk (the class embedding added to the CLS position again)
    and the patch-16 / patch-8 pyramids;
  * `CLIPFPNBaseline`: backbone -> neck -> head without the text branch.

Submodule names follow the JAX param tree (`layer{s}` and `resblocks` and the
context decoder's `decoder` are ModuleLists: `layer1.0` is the JAX
`layer1_0`; the flattened torch Sequentials keep their JAX names,
`memory_proj_0`, `mlp_3`, `lateral_2`, `scale_gn_1`, ...), so that
`tunevlseg_torch/convert/from_jax.py` maps the JAX tree one to one.

BatchNorm: the ResNet normalises with batch statistics only in a train step
of a `bn_train` model (`deterministic=False`), and then puts the updated
running statistics into the caller's `stats_updates` dict under their
`state_dict` names (the JAX `mutable=["batch_stats"]`); otherwise it uses the
running statistics. The ViT's one BatchNorm always uses the running ones.

`backbone_layout="flat"` runs the ResNet's stem tail and its four stages
through the flat convolution K4 (`ops/conv_flat.py`, through CRIS's
`run_flat_stem_tail` / `run_flat_stage`) with the BatchNorms folded into the
epilogues. That needs the running statistics, so the dispatch rule is the
JAX package's (`use_flat = use_running_average and TUNEVLSEG_PALLAS_CONV`):
a call that normalises with batch statistics (the train step of a
`bn_train` model) runs the NCHW path whatever the layout; every other call
of a flat model runs K4.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.models.cris.resnet import (BatchNorm2d, Bottleneck,
                                                avg_pool_nchw, name_stats_updates,
                                                run_flat_stage,
                                                run_flat_stem_tail)
from tunevlseg_torch.nn.attention import causal_bias, dot_product_attention
from tunevlseg_torch.nn.conv import Conv2d, ConvTranspose2d
from tunevlseg_torch.nn.layers import (Dense, Embed, GroupNorm, LayerNorm,
                                       PreNormEncoderLayer, dropout)
from tunevlseg_torch.ops.image import resize_2d

BACKBONE_LAYOUTS = ("nchw", "flat")


@dataclasses.dataclass(frozen=True)
class DenseCLIPConfig:
    """The port's own copy of the JAX package's config (same fields, same
    defaults: the ADE-150 RN50 512^2 80k recipe; same presets)."""

    # backbone (RN50)
    vision_layers: Sequence[int] = (3, 4, 6, 3)
    vision_width: int = 64
    input_resolution: int = 512
    embed_dim: int = 1024              # text / visual joint dim
    # text encoder: class names in a 5-token budget, 13 - 5 = 8 learned
    # context tokens
    vocab_size: int = 49408
    text_context_length: int = 5       # class-token budget
    context_length: int = 8            # learned context tokens
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # context decoder
    decoder_width: int = 256
    decoder_heads: int = 4
    decoder_layers: int = 3
    decoder_dropout: float = 0.1
    # segmentation glue
    num_classes: int = 150
    score_concat_index: int = 3
    fpn_out_channels: int = 256
    head_channels: int = 256
    head_dropout: float = 0.1          # decode_head dropout_ratio
    # training
    tau: float = 0.07
    identity_weight: float = 0.4
    # ViT backbone variant
    backbone_type: str = "resnet"      # "resnet" | "vit"
    patch_size: int = 16
    vit_width: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_out_indices: Sequence[int] = (3, 5, 7, 11)
    drop_path_rate: float = 0.0

    @property
    def total_context(self) -> int:
        return self.text_context_length + self.context_length

    @staticmethod
    def tiny(**kw) -> "DenseCLIPConfig":
        base = dict(vision_layers=(1, 1, 1, 1), vision_width=16,
                    input_resolution=64, embed_dim=32, vocab_size=99,
                    text_context_length=5, context_length=3,
                    transformer_width=16, transformer_heads=2,
                    transformer_layers=2, decoder_width=16, decoder_heads=2,
                    decoder_layers=2, decoder_dropout=0.0, num_classes=4,
                    fpn_out_channels=16, head_channels=16)
        base.update(kw)
        return DenseCLIPConfig(**base)

    @staticmethod
    def tiny_vit(**kw) -> "DenseCLIPConfig":
        base = dict(backbone_type="vit", patch_size=16, vit_width=16,
                    vit_layers=4, vit_heads=2, vit_out_indices=(0, 1, 2, 3),
                    score_concat_index=2)
        base.update(kw)
        return DenseCLIPConfig.tiny(**base)

    @staticmethod
    def rn101(**kw) -> "DenseCLIPConfig":
        """The ResNet-101 512^2 ADE-150 recipe: layers (3, 4, 23, 3) and a
        512 joint dim; everything else as RN50."""
        base = dict(vision_layers=(3, 4, 23, 3), embed_dim=512)
        base.update(kw)
        return DenseCLIPConfig(**base)

    @staticmethod
    def vitb16(**kw) -> "DenseCLIPConfig":
        """The ViT-B/16 640^2 ADE-150 recipe: width 768, 12 layers, stages
        from blocks (3, 5, 7, 11), drop_path 0.1, joint dim 512, score map on
        stage 2; text encoder and token budgets as RN50."""
        base = dict(backbone_type="vit", patch_size=16, vit_width=768,
                    vit_layers=12, vit_heads=12,
                    vit_out_indices=(3, 5, 7, 11), drop_path_rate=0.1,
                    input_resolution=640, embed_dim=512,
                    score_concat_index=2)
        base.update(kw)
        return DenseCLIPConfig(**base)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    return x.unflatten(-1, (num_heads, -1))


class DenseCLIPAttentionPool(nn.Module):
    """OpenAI AttentionPool2d returning (global, spatial): the mean of the
    map prepended as the CLS token, the positions (f32) bilinearly resized to
    the map, self-attention over the 1 + HW tokens, `c_proj`."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spacial_dim, self.embed_dim = spacial_dim, embed_dim
        self.num_heads, self.output_dim = num_heads, output_dim
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.c_proj = Dense(embed_dim, output_dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.positional_embedding.normal_(0.0, self.embed_dim ** -0.5,
                                          generator=generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, c, h, w = x.shape
        seq = x.reshape(b, c, h * w).transpose(1, 2)            # (B, HW, C)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        pos = self.positional_embedding.float()
        grid = pos[1:].reshape(self.spacial_dim, self.spacial_dim,
                               self.embed_dim).permute(2, 0, 1)
        spatial = resize_2d(grid, (h, w), "bilinear").reshape(
            self.embed_dim, h * w).T
        seq = seq + torch.cat([pos[:1], spatial])[None].to(seq.dtype)
        out = dot_product_attention(
            *(_split_heads(p(seq), self.num_heads)
              for p in (self.q_proj, self.k_proj, self.v_proj)))
        out = self.c_proj(out.flatten(-2))
        feature_map = out[:, 1:].transpose(1, 2).reshape(b, self.output_dim, h, w)
        return out[:, 0], feature_map


class CLIPResNetWithAttention(nn.Module):
    """The CLIP ModifiedResNet pyramid (stride 4, 8, 16, 32 outputs) and, with
    `with_attnpool`, the attention pool's (global, spatial) pair as a fifth
    output; `with_attnpool=False` is the plain `CLIPResNet` of the FPN
    baseline. `layout="flat"`: see the module docstring."""

    def __init__(self, config: DenseCLIPConfig, with_attnpool: bool = True,
                 layout: str = "nchw", dtype: torch.dtype = torch.float32):
        super().__init__()
        if layout not in BACKBONE_LAYOUTS:
            raise ValueError(f"backbone_layout {layout!r}: one of {BACKBONE_LAYOUTS}")
        c = self.config = config
        self.layout, self.with_attnpool = layout, with_attnpool
        w = c.vision_width
        for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                         (w // 2, w)), start=1):
            setattr(self, f"conv{i}", Conv2d(cin, cout, 3, stride=2 if i == 1 else 1,
                                             padding=1, bias=False, dtype=dtype))
            setattr(self, f"bn{i}", BatchNorm2d(cout))
        inplanes = w
        for stage, (planes, blocks) in enumerate(
                zip((w, w * 2, w * 4, w * 8), c.vision_layers), start=1):
            stage_blocks = []
            for b in range(blocks):
                stride = 2 if b == 0 and stage > 1 else 1
                stage_blocks.append(Bottleneck(inplanes, planes, stride, dtype=dtype))
                inplanes = planes * Bottleneck.EXPANSION
            setattr(self, f"layer{stage}", nn.ModuleList(stage_blocks))
        if with_attnpool:
            self.attnpool = DenseCLIPAttentionPool(
                c.input_resolution // 32, w * 32, w * 32 // 64, c.embed_dim, dtype)

    def forward(self, x: torch.Tensor, use_running_average: bool = True,
                updates: Optional[dict] = None):
        """(B, 3, H, W) -> (C2, C3, C4, C5[, (global, spatial)])."""
        if self.conv1.weight.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous(memory_format=torch.channels_last)
        ura = use_running_average
        flat = self.layout == "flat" and ura
        x = F.relu(self.bn1(self.conv1(x), ura, updates))
        if flat:
            x = run_flat_stem_tail(x, self)
        else:
            for i in (2, 3):
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x),
                                                   ura, updates))
        x = avg_pool_nchw(x, 2)
        outs = []
        for stage in (1, 2, 3, 4):
            blocks = getattr(self, f"layer{stage}")
            if flat:
                x = run_flat_stage(x, blocks)
            else:
                for block in blocks:
                    x = block(x, ura, updates)
            outs.append(x)
        if not self.with_attnpool:
            return tuple(outs)
        return (*outs, self.attnpool(outs[-1]))


class DropPath(nn.Module):
    """Stochastic depth: a whole sample's residual branch dropped with
    probability `rate`, the kept ones scaled by 1 / (1 - rate); the mask is
    drawn from the `generator` it is given."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, deterministic, generator,
                       (x.shape[0],) + (1,) * (x.dim() - 1))


class ViTBlock(PreNormEncoderLayer):
    """The CLIP residual attention block with DropPath on both residuals
    (the parameter names of `PreNormEncoderLayer`)."""

    def __init__(self, dim: int, num_heads: int, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dim, num_heads, dim * 4, "quick_gelu", 1e-5, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + self.drop_path(self.self_attn(self.layer_norm1(x)),
                               deterministic, generator)
        return x + self.drop_path(self.mlp(self.layer_norm2(x)), deterministic,
                                  generator)


def max_pool_nchw(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.max_pool2d(x, k, k)


class CLIPVisionTransformerBackbone(nn.Module):
    """The CLIP ViT trunk tapped at `vit_out_indices`, each tap as a 2-D map
    through the fpn1..fpn4 pyramid ops (4x / 2x / 1x / 0.5x for patch 16,
    2x / 1x / 0.5x / 0.25x for patch 8), and with `get_embeddings` the
    projected (global, spatial) embedding pair. Keeps the reference's quirk:
    the CLS position gets `class_embedding` added again on top of a CLS
    token that already is `class_embedding`."""

    def __init__(self, config: DenseCLIPConfig, get_embeddings: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        if c.patch_size not in (8, 16):
            raise ValueError(f"unsupported patch size {c.patch_size}")
        self.get_embeddings, self.dtype = get_embeddings, dtype
        w = c.vit_width
        spatial = c.input_resolution // c.patch_size
        self.conv1 = Conv2d(3, w, c.patch_size, stride=c.patch_size, bias=False,
                            dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(spatial ** 2 + 1, w))
        self.ln_pre = LayerNorm(w, 1e-5, dtype)
        rates = np.linspace(0.0, c.drop_path_rate, c.vit_layers)
        self.resblocks = nn.ModuleList(
            ViTBlock(w, c.vit_heads, float(rates[i]), dtype)
            for i in range(c.vit_layers))
        if c.patch_size == 16:
            self.fpn1_gn = GroupNorm(1, w, dtype=dtype)
            self.fpn1_deconv1 = ConvTranspose2d(w, w, 2, dtype=dtype)
            self.fpn1_bn = BatchNorm2d(w)
            self.fpn1_deconv2 = ConvTranspose2d(w, w, 2, dtype=dtype)
            self.fpn2_gn = GroupNorm(1, w, dtype=dtype)
            self.fpn2_deconv = ConvTranspose2d(w, w, 2, dtype=dtype)
        else:
            self.fpn1_gn = GroupNorm(1, w, dtype=dtype)
            self.fpn1_deconv = ConvTranspose2d(w, w, 2, dtype=dtype)
            self.fpn2_gn = GroupNorm(1, w, dtype=dtype)
        self.fpn3_gn = GroupNorm(1, w, dtype=dtype)
        self.fpn4_gn = GroupNorm(1, w, dtype=dtype)
        if get_embeddings:
            self.ln_post = LayerNorm(w, 1e-5, dtype)
            self.proj = nn.Parameter(torch.empty(w, c.embed_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        scale = self.config.vit_width ** -0.5
        for p in (self.class_embedding, self.positional_embedding) + (
                (self.proj,) if self.get_embeddings else ()):
            p.normal_(0.0, scale, generator=generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        c = self.config
        w = c.vit_width
        spatial = c.input_resolution // c.patch_size
        x = self.conv1(x)
        b, _, h, wd = x.shape
        tokens = x.reshape(b, w, h * wd).transpose(1, 2)         # (B, HW, w)
        cls = self.class_embedding.to(tokens.dtype).expand(b, 1, w)
        x = torch.cat([cls, tokens], dim=1)
        pos = self.positional_embedding
        cls_pos = (pos[0] + self.class_embedding)[None, None]   # the quirk
        spatial_pos = pos[1:].reshape(1, spatial, spatial, w).permute(0, 3, 1, 2)
        spatial_pos = resize_2d(spatial_pos, (h, wd), "bilinear")
        spatial_pos = spatial_pos.reshape(1, w, h * wd).transpose(1, 2)
        x = x + torch.cat([cls_pos, spatial_pos], dim=1).to(x.dtype)
        x = self.ln_pre(x)
        taps = []
        out_indices = tuple(c.vit_out_indices)
        for i, block in enumerate(self.resblocks):
            x = block(x, deterministic, generator)
            if i in out_indices:
                taps.append(x[:, 1:].transpose(1, 2).reshape(b, w, h, wd))
        if c.patch_size == 16:
            f = self.fpn1_deconv1(self.fpn1_gn(taps[0]))
            f = F.gelu(self.fpn1_bn(f))
            feats = [self.fpn1_deconv2(f),
                     self.fpn2_deconv(self.fpn2_gn(taps[1])),
                     self.fpn3_gn(taps[2]),
                     max_pool_nchw(self.fpn4_gn(taps[3]), 2)]
        else:
            feats = [self.fpn1_deconv(self.fpn1_gn(taps[0])),
                     self.fpn2_gn(taps[1]),
                     max_pool_nchw(self.fpn3_gn(taps[2]), 2),
                     max_pool_nchw(self.fpn4_gn(taps[3]), 4)]
        if not self.get_embeddings:
            return tuple(feats)
        y = self.ln_post(x) @ self.proj.to(self.dtype)
        visual = y[:, 1:].reshape(b, h, wd, -1).permute(0, 3, 1, 2)
        return (*feats, (y[:, 0], visual))


class CLIPTextContextEncoder(nn.Module):
    """The causal text encoder over [BOS, context, class tokens]."""

    def __init__(self, config: DenseCLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.token_embedding = Embed(c.vocab_size, c.transformer_width, dtype)
        self.positional_embedding = nn.Parameter(
            torch.empty(c.total_context, c.transformer_width))
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

    def forward(self, text: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """text (K, N1) token ids; context (B, N2, width). Returns
        (B, K, embed_dim)."""
        emb = self.token_embedding(text)                      # (K, N1, C)
        k_cls, n1, width = emb.shape
        b, n2, _ = context.shape
        eos = (text.to(torch.int32).argmax(dim=-1) + n2).repeat(b)   # (B*K,)
        emb_b = emb[None].expand(b, k_cls, n1, width)
        ctx_b = context[:, None].to(self.dtype).expand(b, k_cls, n2, width)
        x = torch.cat([emb_b[:, :, :1], ctx_b, emb_b[:, :, 1:]], dim=2)
        x = x.reshape(b * k_cls, n1 + n2, width)
        x = x + self.positional_embedding[:x.shape[1]].to(x.dtype)
        bias = causal_bias(x.shape[1], torch.float32, x.device)
        for block in self.resblocks:
            x = block(x, bias)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        out = pooled @ self.text_projection.to(pooled.dtype)
        return out.reshape(b, k_cls, -1)


class BiasFreeMHA(nn.Module):
    """Multi-head attention with bias-free q / k / v and a biased output
    projection `proj`."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.k_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.v_proj = Dense(dim, dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        out = dot_product_attention(_split_heads(self.q_proj(q), h),
                                    _split_heads(self.k_proj(k), h),
                                    _split_heads(self.v_proj(v), h))
        return self.proj(out.flatten(-2))


class ContextDecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.self_attn = BiasFreeMHA(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.cross_attn = BiasFreeMHA(dim, num_heads, dtype)
        self.norm3 = LayerNorm(dim, 1e-5, dtype)
        self.mlp_0 = Dense(dim, dim * 4, dtype=dtype)
        self.mlp_3 = Dense(dim * 4, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mem: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h)
        x = x + self.cross_attn(self.norm2(x), mem, mem)
        return x + self.mlp_3(F.gelu(self.mlp_0(self.norm3(x))))


class ContextDecoder(nn.Module):
    def __init__(self, config: DenseCLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        d, e = c.decoder_width, c.embed_dim
        self.memory_proj_0 = LayerNorm(e, 1e-5, dtype)
        self.memory_proj_1 = Dense(e, d, dtype=dtype)
        self.memory_proj_2 = LayerNorm(d, 1e-5, dtype)
        self.text_proj_0 = LayerNorm(e, 1e-5, dtype)
        self.text_proj_1 = Dense(e, d, dtype=dtype)
        self.decoder = nn.ModuleList(ContextDecoderLayer(d, c.decoder_heads, dtype)
                                     for _ in range(c.decoder_layers))
        self.out_proj_0 = LayerNorm(d, 1e-5, dtype)
        self.out_proj_1 = Dense(d, e, dtype=dtype)

    def forward(self, text: torch.Tensor, visual: torch.Tensor) -> torch.Tensor:
        mem = self.memory_proj_2(self.memory_proj_1(self.memory_proj_0(visual)))
        x = self.text_proj_1(self.text_proj_0(text))
        for layer in self.decoder:
            x = layer(x, mem)
        return self.out_proj_1(self.out_proj_0(x))


class FPNNeck(nn.Module):
    """mmseg's FPN: 1x1 laterals, nearest top-down (repeat by 2, crop), 3x3
    outputs."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(in_channels)
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral_{i}", Conv2d(cin, out_channels, 1, dtype=dtype))
            setattr(self, f"output_{i}", Conv2d(out_channels, out_channels, 3,
                                                padding=1, dtype=dtype))

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        laterals = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.n - 1, 0, -1):
            h, w = laterals[i - 1].shape[2:]
            up = laterals[i].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        return [getattr(self, f"output_{i}")(lat) for i, lat in enumerate(laterals)]


class FPNHead(nn.Module):
    """mmseg FPNHead: per level a 3x3 conv (no bias), GroupNorm(min(32, C))
    with f32 statistics and ReLU, bilinearly resized to the finest level and
    summed; Dropout2d (whole channels of a sample, rate `dropout_ratio`)
    while training; the 1x1 classifier `cls_seg`."""

    def __init__(self, num_classes: int, in_channels: int, channels: int,
                 num_levels: int = 4, dropout_ratio: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_levels, self.dropout_ratio = num_levels, dropout_ratio
        for i in range(num_levels):
            setattr(self, f"scale_head_{i}", Conv2d(in_channels, channels, 3,
                                                    padding=1, bias=False,
                                                    dtype=dtype))
            setattr(self, f"scale_gn_{i}", GroupNorm(min(32, channels), channels,
                                                     1e-5, dtype))
        self.cls_seg = Conv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        target = tuple(feats[0].shape[2:])
        total = None
        for i, f in enumerate(feats):
            h = getattr(self, f"scale_head_{i}")(f)
            h = F.relu(getattr(self, f"scale_gn_{i}")(h))
            if tuple(h.shape[2:]) != target:
                h = resize_2d(h, target, "bilinear")
            total = h if total is None else total + h
        total = dropout(total, self.dropout_ratio, deterministic, generator,
                        total.shape[:2] + (1, 1))
        return self.cls_seg(total)


def _stage_channels(c: DenseCLIPConfig) -> list[int]:
    if c.backbone_type == "vit":
        return [c.vit_width] * 4
    w = c.vision_width
    return [w * 4, w * 8, w * 16, w * 32]


class DenseCLIP(nn.Module):
    """Backbone -> text / context fusion -> score-map concat -> FPN neck ->
    FPN head -> class logits at the input resolution.

    `class_token_ids` (K, text_context_length) become a non-persistent
    buffer (they move with the model, and are in no `state_dict`); a call
    may pass others."""

    def __init__(self, config: DenseCLIPConfig, class_token_ids=None,
                 bn_train: bool = False, backbone_layout: str = "nchw",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.bn_train, self.dtype = bn_train, dtype
        if c.backbone_type == "vit":
            if backbone_layout != "nchw":
                raise ValueError("backbone_layout='flat' runs the ResNet backbones")
            self.backbone = CLIPVisionTransformerBackbone(c, dtype=dtype)
        else:
            self.backbone = CLIPResNetWithAttention(c, layout=backbone_layout,
                                                    dtype=dtype)
        self.text_encoder = CLIPTextContextEncoder(c, dtype)
        self.context_decoder = ContextDecoder(c, dtype)
        self.contexts = nn.Parameter(torch.empty(1, c.context_length,
                                                 c.transformer_width))
        self.gamma = nn.Parameter(torch.empty(c.embed_dim))
        channels = _stage_channels(c)
        channels[c.score_concat_index] += c.num_classes
        self.neck = FPNNeck(channels, c.fpn_out_channels, dtype)
        self.decode_head = FPNHead(c.num_classes, c.fpn_out_channels,
                                   c.head_channels, dropout_ratio=c.head_dropout,
                                   dtype=dtype)
        ids = None if class_token_ids is None else torch.as_tensor(
            np.asarray(class_token_ids), dtype=torch.long)
        self.register_buffer("class_token_ids", ids, persistent=False)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.trunc_normal_(self.contexts, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        self.gamma.fill_(1e-4)

    def forward(self, images: torch.Tensor,
                class_token_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True, with_score_map: bool = False,
                generator: Optional[torch.Generator] = None,
                stats_updates: Optional[dict] = None):
        """images (B, 3, H, W) -> logits (B, K, H, W) (and the raw score map
        (B, K, h, w) at stride 32 with `with_score_map`). A `bn_train` model
        called with `deterministic=False` needs the `stats_updates` dict."""
        c = self.config
        ids = class_token_ids if class_token_ids is not None else self.class_token_ids
        if ids is None:
            raise ValueError("no class_token_ids: give them to the model or the call")
        ura = (not self.bn_train) or deterministic
        if not ura and stats_updates is None:
            raise ValueError(
                "a bn_train model in a train step updates its BatchNorm running "
                "statistics: pass stats_updates (DenseCLIPTask)")
        updates = None if ura else {}
        if c.backbone_type == "vit":
            feats = self.backbone(images, deterministic, generator)
        else:
            feats = self.backbone(images, ura, updates)
        x_orig = list(feats[:4])
        global_feat, visual = feats[4]
        b, ch, h, w = visual.shape
        visual_context = torch.cat([global_feat[:, :, None],
                                    visual.reshape(b, ch, h * w)], dim=2).transpose(1, 2)
        text = self.text_encoder(ids.to(images.device), self.contexts.to(self.dtype))
        text = text.expand(b, *text.shape[1:])
        text_diff = self.context_decoder(text, visual_context)
        text = text + self.gamma.to(text.dtype) * text_diff

        v_norm = visual / torch.linalg.vector_norm(visual, dim=1, keepdim=True)
        t_norm = text / torch.linalg.vector_norm(text, dim=2, keepdim=True)
        score_map = torch.einsum("bchw,bkc->bkhw", v_norm, t_norm)
        idx = c.score_concat_index
        x_orig[idx] = torch.cat([x_orig[idx], score_map], dim=1)
        logits = self.decode_head(self.neck(x_orig), deterministic, generator)
        logits = resize_2d(logits, tuple(images.shape[2:]), "bilinear")
        if updates:
            name_stats_updates(self, updates, stats_updates)
        if with_score_map:
            return logits, score_map
        return logits


class CLIPFPNBaseline(nn.Module):
    """The fpn_clip* baselines: a CLIP backbone's pyramid -> FPN neck -> FPN
    head (no dropout), no text branch."""

    def __init__(self, config: DenseCLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        if c.backbone_type == "vit":
            self.backbone = CLIPVisionTransformerBackbone(c, get_embeddings=False,
                                                          dtype=dtype)
        else:
            self.backbone = CLIPResNetWithAttention(c, with_attnpool=False,
                                                    dtype=dtype)
        self.neck = FPNNeck(_stage_channels(c), c.fpn_out_channels, dtype)
        self.decode_head = FPNHead(c.num_classes, c.fpn_out_channels,
                                   c.head_channels, dtype=dtype)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.config.backbone_type == "vit":
            feats = self.backbone(images, deterministic, generator)
        else:
            feats = self.backbone(images)
        logits = self.decode_head(self.neck(list(feats)))
        return resize_2d(logits, tuple(images.shape[2:]), "bilinear")

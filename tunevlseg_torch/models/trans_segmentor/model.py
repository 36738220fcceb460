"""TransformerSegmentor: CLIP or SigLIP towers, a transformer decoder of image
queries over the text memory, and a staged convolutional upsampler.

Counterpart of `tunevlseg_tpu/models/trans_segmentor/model.py` (the
reference's `TransformerSegmentor`):

  * token-level features: the towers' last hidden states; with
    `use_existing_proj` through the (bias-free) text and visual projections
    to `projection_dim`, otherwise the text through a fresh Linear to the
    image width (when the widths differ) and the image as it is;
  * optionally the 1e-4-base sincos position encoding on both streams;
  * torch `TransformerDecoder` semantics with the reference's pre-cross-
    attention layer: norm_first, cross-attention BEFORE self-attention, and
    a memory bias at f32 dtype-min on padded text keys, (B, 1, 1, T);
  * the CLS token stripped when the token count is not a square (CLIP's 485
    -> 484 at 352^2; SigLIP has no CLS and keeps its 576);
  * the upsampler: `num_upsampler_layers` stages of [bilinear resize,
    3x3 convolution with replicate padding, norm, activation], the channel
    count falling by projection // n a stage and the side growing by
    patch ** (1 / n) (ceiling); the last stage maps to
    `num_output_channels` with the optional fixed `output_bias` init.

The decoder's activation defaults to ReLU although the reference configures
GELU: torch's `TransformerDecoder` clones its layers through a path that
resets a module activation to ReLU, and the JAX package mirrors that on
purpose. LayerNorm eps is 1e-5 in the decoder and the upsampler.

`text_index` (B,) deduplicates prompts as in the other models: the text
tower runs on the U unique rows, and its features and the attention mask are
gathered back to B rows. Dropout (the decoder's) is applied only with
`deterministic=False` and draws its masks from the `generator` it is given.

`upsampler_layout` picks the upsampler's convolutions: "nchw" (the default)
runs each as the resize's replicate-padded output (`resize_2d(...,
out_pad=1)`, the JAX package's fused pad, bitwise the same as an explicit
pad) into a VALID `F.conv2d`; "flat" runs them through the flat convolution
K4 (`ops/conv_flat.py`; the JAX package's TUNEVLSEG_PALLAS_CONV), with the
bias as its fused offset. K4 takes channel counts that are multiples of 8
and the upsampler's are not (512 -> 410 -> 308 -> 206 -> 104 -> 1 at full
width), so C and Cout are zero-padded up to the next multiple of 8 around
each K4 call (416, 312, 208, 104 and 8 for the output) and the result is
sliced back before the norm: the padded output channels are exact zeros (zero
weights, zero offset) and never reach the sample LayerNorm. "nhwc" (a TPU
layout experiment of the JAX package) raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPTextConfig, CLIPVisionConfig
from tunevlseg_torch.models.clip.text import CLIPTextTower
from tunevlseg_torch.models.clip.vision import CLIPVisionTower
from tunevlseg_torch.models.cris.layers import _pos_tensor
from tunevlseg_torch.models.trans_segmentor.siglip import (SiglipTextTower,
                                                           SiglipVisionTower)
from tunevlseg_torch.nn import remat
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.nn.layers import (ACT2FN, Dense, GroupNorm, LayerNorm,
                                       MultiHeadAttention, dropout)
from tunevlseg_torch.ops.image import resize_2d

UPSAMPLER_LAYOUTS = ("nchw", "flat")


@dataclasses.dataclass(frozen=True)
class TransSegmentorConfig:
    """The port's own copy of the JAX package's config (same fields, same
    defaults, same `siglip_base()` and `tiny()`)."""

    text: CLIPTextConfig = CLIPTextConfig()
    vision: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512
    encoder_family: str = "clip"          # "clip" | "siglip"
    use_existing_proj: bool = True
    add_pos_enc: bool = False
    # decoder
    decoder_num_layers: int = 4
    decoder_num_heads: int = 8
    decoder_dim_feedforward: int = 2048
    decoder_dropout: float = 0.1
    decoder_activation: str = "relu"      # the reference's quirk, see above
    decoder_norm_first: bool = True
    cross_attn_first: bool = True
    # upsampler
    num_upsampler_layers: int = 5
    upsampler_act: str = "relu"
    upsampler_norm: Optional[str] = "layer"
    upsampler_group_channels: int = 64
    image_size: Optional[int] = None
    num_output_channels: int = 1
    output_bias: Optional[float] = None

    @property
    def effective_projection_dim(self) -> int:
        """The decoder and upsampler width: `projection_dim` with the existing
        projections, else the image hidden size."""
        return (self.projection_dim if self.use_existing_proj
                else self.vision.hidden_size)

    @staticmethod
    def siglip_base(**kw) -> "TransSegmentorConfig":
        """google/siglip-base-patch16-224's towers: 768 wide, 12 layers,
        vocabulary 32000, 64 text positions, gelu_pytorch_tanh, LayerNorm eps
        1e-6, no CLS and no projections (use_existing_proj False)."""
        base = dict(
            text=CLIPTextConfig(vocab_size=32000, hidden_size=768,
                                num_layers=12, num_heads=12,
                                intermediate_size=3072,
                                max_position_embeddings=64,
                                hidden_act="gelu_pytorch_tanh",
                                layer_norm_eps=1e-6),
            vision=CLIPVisionConfig(hidden_size=768, num_layers=12,
                                    num_heads=12, intermediate_size=3072,
                                    patch_size=16, image_size=224,
                                    hidden_act="gelu_pytorch_tanh",
                                    layer_norm_eps=1e-6),
            encoder_family="siglip",
            use_existing_proj=False)
        base.update(kw)
        return TransSegmentorConfig(**base)

    @staticmethod
    def tiny(**kw) -> "TransSegmentorConfig":
        """Scaled-down towers, decoder and upsampler for fast tests; the
        vocabulary keeps its real size."""
        base = dict(
            text=CLIPTextConfig(vocab_size=49408, hidden_size=16, num_layers=2,
                                num_heads=2, intermediate_size=32),
            vision=CLIPVisionConfig(hidden_size=24, num_layers=2, num_heads=2,
                                    intermediate_size=48, patch_size=16,
                                    image_size=32),
            projection_dim=20,
            decoder_num_layers=2, decoder_num_heads=2,
            decoder_dim_feedforward=16, decoder_dropout=0.0,
            num_upsampler_layers=2)
        base.update(kw)
        return TransSegmentorConfig(**base)


class TorchTransformerDecoderLayer(nn.Module):
    """torch.nn.TransformerDecoderLayer (batch_first) with the reference's
    pre-cross-attention order; parameter names are torch's."""

    def __init__(self, dim: int, num_heads: int, dim_feedforward: int,
                 dropout_rate: float = 0.1, activation: str = "gelu",
                 norm_first: bool = True, cross_attn_first: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.act = ACT2FN[activation]
        self.norm_first = norm_first
        self.cross_attn_first = cross_attn_first
        self.norm1 = LayerNorm(dim, 1e-5, dtype)
        self.norm2 = LayerNorm(dim, 1e-5, dtype)
        self.norm3 = LayerNorm(dim, 1e-5, dtype)
        self.self_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.multihead_attn = MultiHeadAttention(dim, num_heads, dtype)
        self.linear1 = Dense(dim, dim_feedforward, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, dim, dtype=dtype)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                memory_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def drop(h):
            return dropout(h, self.dropout_rate, deterministic, generator)

        def sa(x):
            return drop(self.self_attn(x))

        def mha(x):
            return drop(self.multihead_attn(x, memory_bias, kv_states=memory))

        def ff(x):
            return drop(self.linear2(drop(self.act(self.linear1(x)))))

        blocks = ([(self.norm2, mha), (self.norm1, sa)] if self.cross_attn_first
                  else [(self.norm1, sa), (self.norm2, mha)])
        x = tgt
        if self.norm_first:
            for norm, block in blocks:
                x = x + block(norm(x))
            return x + ff(self.norm3(x))
        for norm, block in blocks:
            x = norm(x + block(x))
        return self.norm3(x + ff(x))


def upsampler_stages(config: TransSegmentorConfig) -> list[tuple[int, int, int]]:
    """(C, Cout, side) of each convolution of the upsampler, the output
    convolution last: at full width (512 -> 410, 39), (410 -> 308, 68),
    (308 -> 206, 119), (206 -> 104, 208), (104 -> 1, 352)."""
    c = config
    n = c.num_upsampler_layers
    final = c.image_size or c.vision.image_size
    step = c.effective_projection_dim // n
    up = c.vision.patch_size ** (1.0 / n)
    in_ch, size = c.effective_projection_dim, final // c.vision.patch_size
    stages = []
    for _ in range(n - 1):
        size = math.ceil(size * up)
        stages.append((in_ch, in_ch - step, size))
        in_ch -= step
    return stages + [(in_ch, c.num_output_channels, final)]


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def flat_operands(x: torch.Tensor, conv: Conv2d):
    """K4's operands for the VALID 3x3 convolution of `conv` on the
    replicate-padded x (B, C, s+2, s+2): (the (s+2)^2 plane in flat space with
    C zero-padded to a multiple of 8, its FlatSpec, the weight with C and Cout
    zero-padded likewise, the bias likewise as K4's f32 offset or None)."""
    from tunevlseg_torch.ops import conv_flat as cf
    _, c, hp, wp = x.shape
    cout = conv.weight.shape[0]
    cp, coutp = _ceil8(c), _ceil8(cout)
    spec = cf.make_flat_spec(hp, wp, 1, max_k2c=9 * c, itemsize=x.element_size())
    flat = cf.flat_begin(x.permute(0, 2, 3, 1), spec, channels=cp)
    weight = F.pad(conv.weight, (0, 0, 0, 0, 0, cp - c, 0, coutp - cout))
    offset = (None if conv.bias is None
              else F.pad(conv.bias.float(), (0, coutp - cout)))
    return flat, spec, weight, offset


def conv3_flat(x: torch.Tensor, conv: Conv2d) -> torch.Tensor:
    """The VALID 3x3 convolution of `conv` on the replicate-padded x (B, C,
    s+2, s+2) through K4 on `flat_operands`: the result's interior, sliced
    back to Cout channels, as (B, Cout, s, s)."""
    from tunevlseg_torch.ops import conv_flat as cf
    flat, spec, weight, offset = flat_operands(x, conv)
    y = cf.flat_end(cf.conv_flat(flat, spec, weight, offset=offset), spec)
    return y[:, 1:-1, 1:-1, :conv.weight.shape[0]].permute(0, 3, 1, 2)


class Upsampler(nn.Module):
    def __init__(self, config: TransSegmentorConfig, layout: str = "nchw",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layout not in UPSAMPLER_LAYOUTS:
            raise ValueError(
                f'upsampler layout {layout!r}: one of {UPSAMPLER_LAYOUTS} ("nhwc" '
                "is a TPU layout experiment of the JAX package, not ported)")
        c = self.config = config
        self.layout, self.dtype = layout, dtype
        self.act = ACT2FN[c.upsampler_act]
        stages = upsampler_stages(c)
        *blocks, (in_ch, out_ch, _) = stages
        self.sizes = [size for _, _, size in stages]
        for i, (ci, co, size) in enumerate(blocks):
            setattr(self, f"block{i}_conv",
                    Conv2d(ci, co, 3, bias=c.upsampler_norm is None, dtype=dtype))
            if c.upsampler_norm == "layer":
                # torch `nn.LayerNorm((C, H, W))`: statistics over each
                # sample, a (C, H, W) affine
                setattr(self, f"block{i}_norm",
                        LayerNorm((co, size, size), 1e-5, dtype))
            elif c.upsampler_norm == "group":
                setattr(self, f"block{i}_norm",
                        GroupNorm(co // c.upsampler_group_channels, co, 1e-5,
                                  dtype))
            elif c.upsampler_norm is not None:
                raise ValueError(f"upsampler_norm {c.upsampler_norm!r}: "
                                 '"layer", "group" or None')
        # `output_bias` fixes the bias init (PhraseCut's prior logit); it trains
        self.out_conv = Conv2d(in_ch, out_ch, 3, bias_init_value=c.output_bias,
                               dtype=dtype)

    def _conv(self, x: torch.Tensor, conv: Conv2d) -> torch.Tensor:
        if self.layout == "flat":
            return conv3_flat(x.to(self.dtype), conv)
        return conv(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, C, s, s)
        for i, size in enumerate(self.sizes[:-1]):
            x = resize_2d(x, (size, size), "bilinear", out_pad=1)
            x = self._conv(x, getattr(self, f"block{i}_conv"))
            if self.config.upsampler_norm is not None:
                x = getattr(self, f"block{i}_norm")(x)
            x = self.act(x)
        final = self.sizes[-1]
        x = resize_2d(x, (final, final), "bilinear", out_pad=1)
        return self._conv(x, self.out_conv)


class TransformerSegmentor(nn.Module):
    def __init__(self, config: TransSegmentorConfig,
                 upsampler_layout: str = "nchw",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        if c.encoder_family == "clip":
            self.text_model = CLIPTextTower(c.text, dtype)
            self.vision_model = CLIPVisionTower(c.vision, dtype=dtype)
        elif c.encoder_family == "siglip":
            self.text_model = SiglipTextTower(c.text, dtype=dtype)
            self.vision_model = SiglipVisionTower(c.vision, dtype=dtype)
        else:
            raise ValueError(f"encoder_family {c.encoder_family!r}: "
                             '"clip" or "siglip"')
        t, v = c.text.hidden_size, c.vision.hidden_size
        self.text_projection = self.visual_projection = None
        if c.use_existing_proj:
            self.text_projection = Dense(t, c.projection_dim, bias=False,
                                         dtype=dtype)
            self.visual_projection = Dense(v, c.projection_dim, bias=False,
                                           dtype=dtype)
        elif t != v:
            self.text_projection = Dense(t, v, dtype=dtype)
        d = c.effective_projection_dim
        self.decoder_layers = nn.ModuleList(
            TorchTransformerDecoderLayer(
                d, c.decoder_num_heads, c.decoder_dim_feedforward,
                c.decoder_dropout, c.decoder_activation, c.decoder_norm_first,
                c.cross_attn_first, dtype)
            for _ in range(c.decoder_num_layers))
        self.decoder_norm = LayerNorm(d, 1e-5, dtype)
        self.upsampler = Upsampler(c, upsampler_layout, dtype)

    def unused_parameters(self) -> list[str]:
        """The parameters no loss reaches (data parallel sets DDP's
        `find_unused_parameters` by them): the CLIP vision tower's
        `post_layernorm`, which only its pooled output, unread here, passes
        through."""
        if self.config.encoder_family != "clip":
            return []
        return ["vision_model.post_layernorm.weight",
                "vision_model.post_layernorm.bias"]

    def forward(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                text_index: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids (B, L), or (U, L) with text_index (B,) into its rows;
        pixel_values (B, 3, H, W). Returns logits (B, num_output_channels,
        H', H') with H' = image_size or the vision config's."""
        c = self.config
        b = pixel_values.shape[0]
        text, _ = self.text_model(input_ids, attention_mask=attention_mask)
        if self.text_projection is not None:
            text = self.text_projection(text)
        if text_index is not None:
            idx = text_index.long()
            text = text[idx]
            if attention_mask is not None:
                attention_mask = attention_mask[idx]

        _, image, _ = self.vision_model(pixel_values)
        if self.visual_projection is not None:
            image = self.visual_projection(image)

        if c.add_pos_enc:
            text = text + self._pos(text)
            image = image + self._pos(image)

        memory_bias = None
        if attention_mask is not None:
            memory_bias = torch.where(attention_mask[:, None, None, :] == 0,
                                      torch.finfo(torch.float32).min, 0.0)

        x = image
        for layer in self.decoder_layers:
            x = remat.layer_call(layer, x, text, memory_bias,
                                 deterministic=deterministic, generator=generator)
        x = self.decoder_norm(x)

        seq = x.shape[1]
        side = math.isqrt(seq)
        if side * side != seq:        # strip CLS
            x = x[:, 1:]
            side = math.isqrt(x.shape[1])
        x = x.transpose(1, 2).reshape(b, -1, side, side)
        logits = self.upsampler(x)
        h = logits.shape[-1]
        return logits.reshape(b, c.num_output_channels, h, h)

    @staticmethod
    def _pos(x: torch.Tensor) -> torch.Tensor:
        """The 1-d sin-cos encoding of x's positions, cached on x's device
        (no host-to-device copy in a step)."""
        return _pos_tensor("1d", (x.shape[-1], x.shape[1]), x.device, x.dtype)

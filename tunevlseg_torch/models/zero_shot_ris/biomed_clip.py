"""BiomedCLIP (open_clip CustomTextCLIP) dual encoder for zero-shot RIS.

Counterpart of `tunevlseg_tpu/models/zero_shot_ris/biomed_clip.py` (the
reference's CustomOpenCLIP wrapper around
`open_clip.create_model("hf-hub:microsoft/BiomedCLIP-...")`):

  * vision: a timm `vit_base_patch16_224` trunk (pre-LN blocks, GELU, LN eps
    1e-6, the cls token and the learned position embedding added AFTER the
    cls concat, final LN, then the cls token) and open_clip's linear
    projection head (`visual.head.proj`, no bias);
  * text: a BERT-base encoder (post-LN blocks, GELU, LN eps 1e-12, learned
    position and token-type embeddings) with open_clip's
    `cls_last_hidden_state_pooler` (the raw last_hidden_state[:, 0], not
    BERT's tanh pooler) and a 2-layer MLP projection without biases, hidden
    (d + proj) // 2;
  * the masked-feature path of `MaskedCLIP` on the timm trunk (no pre-LN;
    the final LN before the pooling).

The text tower's padding bias sends its attention to K3 on the card in
bf16; the ViT's 197 tokens stay on the plain path (the gate's 256).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from tunevlseg_torch.models.zero_shot_ris.model import run_masked_layers
from tunevlseg_torch.nn.attention import padding_bias
from tunevlseg_torch.nn.layers import (ACT2FN, Dense, Embed, LayerNorm,
                                       PostNormEncoderLayer, PreNormEncoderLayer,
                                       lecun_normal_)
from tunevlseg_torch.ops.image import resize_2d


@dataclasses.dataclass(frozen=True)
class TimmViTConfig:
    """timm vit_base_patch16_224 trunk geometry."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 224
    num_channels: int = 3
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    """BERT-base (PubMedBERT / BiomedBERT) encoder geometry."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class BiomedCLIPConfig:
    vision: TimmViTConfig = TimmViTConfig()
    text: BertTextConfig = BertTextConfig()
    projection_dim: int = 512

    @property
    def text_proj_hidden(self) -> int:
        # open_clip HFTextEncoder's MLP projection width
        return (self.text.hidden_size + self.projection_dim) // 2

    @staticmethod
    def tiny() -> "BiomedCLIPConfig":
        return BiomedCLIPConfig(
            vision=TimmViTConfig(hidden_size=24, num_layers=3, num_heads=2,
                                 intermediate_size=48, patch_size=8,
                                 image_size=32),
            text=BertTextConfig(vocab_size=120, hidden_size=16, num_layers=2,
                                num_heads=2, intermediate_size=32,
                                max_position_embeddings=64),
            projection_dim=20)


class TimmViTTower(nn.Module):
    """timm VisionTransformer trunk: the patch convolution as a space-to-depth
    product, the cls token, positions over [cls; patches], pre-LN blocks, a
    final LN."""

    def __init__(self, config: TimmViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        num_positions = (c.image_size // c.patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.empty(c.hidden_size))
        self.position_embedding = nn.Parameter(torch.empty(num_positions,
                                                           c.hidden_size))
        self.patch_proj = nn.Parameter(
            torch.empty(c.patch_size * c.patch_size * c.num_channels,
                        c.hidden_size))
        self.patch_bias = nn.Parameter(torch.empty(c.hidden_size))
        self.blocks = nn.ModuleList(
            PreNormEncoderLayer(c.hidden_size, c.num_heads, c.intermediate_size,
                                "gelu", c.layer_norm_eps, dtype)
            for _ in range(c.num_layers))
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.cls_token.zero_()
        self.position_embedding.normal_(0.0, 0.02, generator=generator)
        lecun_normal_(self.patch_proj, self.patch_proj.shape[0], generator)
        self.patch_bias.zero_()

    def embed_patches(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, 1 + hw, D); timm's `_pos_embed` adds the
        positions AFTER the cls concat, bicubic-resized from the pretraining
        grid where the input's grid differs (cls position kept)."""
        c = self.config
        b, ch, h, w = pixel_values.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        x = pixel_values.to(self.dtype).reshape(b, ch, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, ch * p * p)
        patches = x @ self.patch_proj.to(self.dtype) + self.patch_bias.to(self.dtype)
        cls = self.cls_token.to(self.dtype).expand(b, 1, -1)
        embeds = torch.cat([cls, patches], dim=1)
        pos = self.position_embedding.float()
        grid = c.image_size // p
        if (gh, gw) != (grid, grid):
            patch_pos = pos[1:].reshape(grid, grid, -1).permute(2, 0, 1)
            patch_pos = resize_2d(patch_pos, (gh, gw), "bicubic")
            pos = torch.cat([pos[:1], patch_pos.permute(1, 2, 0).reshape(gh * gw, -1)])
        return embeds + pos[None].to(self.dtype)


class BertTextTower(nn.Module):
    """BERT encoder (embeddings + post-LN blocks); returns the whole last
    hidden state (open_clip pools [:, 0])."""

    def __init__(self, config: BertTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.word_embedding = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embedding = nn.Parameter(
            torch.empty(c.max_position_embeddings, c.hidden_size))
        self.token_type_embedding = nn.Parameter(
            torch.empty(c.type_vocab_size, c.hidden_size))
        self.embed_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.layers = nn.ModuleList(
            PostNormEncoderLayer(c.hidden_size, c.num_heads, c.intermediate_size,
                                 "gelu", c.layer_norm_eps, dtype)
            for _ in range(c.num_layers))

    def init_weights(self, generator: torch.Generator) -> None:
        self.position_embedding.normal_(0.0, 0.02, generator=generator)
        self.token_type_embedding.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        seq = input_ids.shape[1]
        x = self.word_embedding(input_ids)
        x = x + self.position_embedding[:seq].to(self.dtype)[None]
        x = x + self.token_type_embedding[0].to(self.dtype)
        x = self.embed_norm(x)
        bias = None if attention_mask is None else padding_bias(attention_mask)
        for layer in self.layers:
            x = layer(x, bias)
        return x


class BiomedCLIP(nn.Module):
    """open_clip's CustomTextCLIP layout with the masked-vision path; the
    call surface of `MaskedCLIP`."""

    def __init__(self, config: BiomedCLIPConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.visual = TimmViTTower(c.vision, dtype)
        self.visual_head = Dense(c.vision.hidden_size, c.projection_dim,
                                 bias=False, dtype=dtype)
        self.text_model = BertTextTower(c.text, dtype)
        self.text_proj_fc1 = Dense(c.text.hidden_size, c.text_proj_hidden,
                                   bias=False, dtype=dtype)
        self.text_proj_fc2 = Dense(c.text_proj_hidden, c.projection_dim,
                                   bias=False, dtype=dtype)

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None):
        if attention_mask is None:
            # HFTextEncoder.forward derives the mask from the pad id
            attention_mask = (input_ids != self.config.text.pad_token_id).int()
        pooled = self.text_model(input_ids, attention_mask)[:, 0]
        return self.text_proj_fc2(ACT2FN["gelu"](self.text_proj_fc1(pooled)))

    def get_image_features(self, pixel_values: torch.Tensor,
                           pred_masks: Optional[torch.Tensor] = None,
                           masking_block_idx: Optional[int] = None):
        """pred_masks: (P, g, g) {0, 1} masks at the patch grid."""
        vt = self.visual
        x = run_masked_layers(vt.embed_patches(pixel_values), vt.blocks,
                              pred_masks, masking_block_idx)
        # timm: the final norm, then the cls token ('token' pooling)
        return self.visual_head(vt.norm(x[:, 0]))

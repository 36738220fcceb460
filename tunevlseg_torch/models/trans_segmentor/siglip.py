"""SigLIP towers, the TransformerSegmentor's second encoder family.

Counterpart of `tunevlseg_tpu/models/trans_segmentor/siglip.py` (HF
`modeling_siglip` semantics). What differs from the CLIP towers:

  * vision: the patch projection has a bias, there is no CLS token, the
    learned position embeddings cover the patch grid and are resized
    bilinearly (`ops/image.resize_2d`) when the input grid differs from the
    pretraining one (224 -> 384 for PhraseCut: 14^2 -> 24^2 positions), and
    `post_layernorm` normalises the whole last hidden state; with
    `use_head`, a learned probe attention-pools it
    (SiglipMultiheadAttentionPoolingHead);
  * text: a padding bias and no causal mask, `final_layer_norm`, and the
    pooled output is the last token through the `head` Linear;
  * both: `gelu_pytorch_tanh` and the config's LayerNorm eps (1e-6 for the
    real towers).

On a CUDA device in bf16 the vision tower's self-attention (576 tokens at
384^2) goes to K1, the text tower's padded 64 tokens and the probe's one
query to K3 (`nn/attention.py`). The TransformerSegmentor builds the vision
tower without the head, and reads neither tower's pooled output: the text
`head` exists (the JAX package creates it) and gets no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPTextConfig, CLIPVisionConfig
from tunevlseg_torch.nn.attention import padding_bias
from tunevlseg_torch.nn.layers import (Dense, Embed, LayerNorm,
                                       MultiHeadAttention, PreNormEncoderLayer,
                                       lecun_normal_)
from tunevlseg_torch.ops.image import resize_2d

ACT = "gelu_pytorch_tanh"


class SiglipVisionTower(nn.Module):
    def __init__(self, config: CLIPVisionConfig, use_head: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        self.use_head = use_head
        d = c.hidden_size
        self.position_embedding = nn.Parameter(
            torch.empty((c.image_size // c.patch_size) ** 2, d))
        self.patch_proj = nn.Parameter(
            torch.empty(c.patch_size * c.patch_size * c.num_channels, d))
        self.patch_bias = nn.Parameter(torch.empty(d))
        self.layers = nn.ModuleList(
            PreNormEncoderLayer(d, c.num_heads, c.intermediate_size, ACT,
                                c.layer_norm_eps, dtype)
            for _ in range(c.num_layers))
        self.post_layernorm = LayerNorm(d, c.layer_norm_eps, dtype)
        if use_head:
            self.probe = nn.Parameter(torch.empty(1, 1, d))
            self.head_attn = MultiHeadAttention(d, c.num_heads, dtype)
            self.head_layernorm = LayerNorm(d, c.layer_norm_eps, dtype)
            self.head_mlp_fc1 = Dense(d, c.intermediate_size, dtype=dtype)
            self.head_mlp_fc2 = Dense(c.intermediate_size, d, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.position_embedding.normal_(0.0, 0.02, generator=generator)
        lecun_normal_(self.patch_proj, self.patch_proj.shape[0], generator)
        self.patch_bias.zero_()
        if self.use_head:
            self.probe.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values: torch.Tensor):
        """pixel_values (B, C, H, W) -> (hidden_states, last_hidden_state
        after post_layernorm, pooled output or None)."""
        c = self.config
        b, ch, h, w = pixel_values.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        # channel-major space-to-depth, the stride-p Conv2d as one matmul
        x = pixel_values.to(self.dtype).reshape(b, ch, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, ch * p * p)
        x = x @ self.patch_proj.to(self.dtype) + self.patch_bias.to(self.dtype)

        pos = self.position_embedding.float()
        grid = c.image_size // p
        if (gh, gw) != (grid, grid):
            pos = pos.reshape(grid, grid, -1).permute(2, 0, 1)
            pos = resize_2d(pos, (gh, gw), "bilinear")
            pos = pos.permute(1, 2, 0).reshape(gh * gw, -1)
        x = x + pos[None].to(x.dtype)

        hidden_states = [x]
        for layer in self.layers:
            x = layer(x)
            hidden_states.append(x)
        x = self.post_layernorm(x)

        pooled = None
        if self.use_head:
            probe = self.probe.to(x.dtype).expand(b, 1, -1)
            attn = self.head_attn(probe, kv_states=x)
            mlp = self.head_mlp_fc2(F.gelu(self.head_mlp_fc1(
                self.head_layernorm(attn)), approximate="tanh"))
            pooled = (attn + mlp)[:, 0]
        return hidden_states, x, pooled


class SiglipTextTower(nn.Module):
    def __init__(self, config: CLIPTextConfig,
                 projection_size: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        d = c.hidden_size
        self.token_embedding = Embed(c.vocab_size, d, dtype)
        self.position_embedding = Embed(c.max_position_embeddings, d, dtype)
        self.layers = nn.ModuleList(
            PreNormEncoderLayer(d, c.num_heads, c.intermediate_size, ACT,
                                c.layer_norm_eps, dtype)
            for _ in range(c.num_layers))
        self.final_layer_norm = LayerNorm(d, c.layer_norm_eps, dtype)
        self.head = Dense(d, projection_size or d, dtype=dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        """input_ids (B, L) -> (last_hidden_state, pooled output)."""
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding(
            torch.arange(x.shape[1], device=x.device))[None]
        bias = (None if attention_mask is None
                else padding_bias(attention_mask, torch.float32))
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        return x, self.head(x[:, -1])

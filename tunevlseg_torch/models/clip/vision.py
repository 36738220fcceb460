"""CLIP ViT vision tower.

Counterpart of `tunevlseg_tpu/models/clip/vision.py:CLIPVisionTower`
(HF `CLIPSegVisionTransformer` semantics):

  * patch embedding as a channel-major space-to-depth and one matmul against
    `patch_proj` (C*p*p, D), equivalent to the stride-p Conv2d;
  * the CLS token, and position embeddings bicubic-resized from the
    pretraining grid to the input grid (HF `interpolate_pos_encoding`);
  * the early exit after max(extract_layers);
  * visual prompt contexts (VPT, MaPLe, the shared learners): `visual_ctx[0]`
    appended after the embeddings and BEFORE `pre_layernorm`, and the
    trailing `num_ctx` slots overwritten with `visual_ctx[i]` after layer i
    (1-based) while i < prompt_depth. Every hidden state handed out includes
    the context tokens.

The JAX package creates parameters only for the layers it runs, so with an
early exit the tower holds layers 0..max(extract_layers) and no
`post_layernorm`; this tower is built with the same set. Without the early
exit (CoCoOp reads the pooled output) it holds all the layers and
`post_layernorm`. The TPU sequence padding (485 -> 512 tokens) is not ported;
`kv_valid` still reaches the attention kernel through `MultiHeadAttention`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPVisionConfig
from tunevlseg_torch.nn import remat
from tunevlseg_torch.nn.layers import LayerNorm, PreNormEncoderLayer, lecun_normal_
from tunevlseg_torch.ops.image import resize_2d


class CLIPVisionTower(nn.Module):
    def __init__(self, config: CLIPVisionConfig,
                 extract_layers: Optional[Sequence[int]] = None,
                 early_exit: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        # the JAX loop runs layer i (1-based) and stops once i > max(extract)
        self.early_exit = bool(early_exit and extract_layers
                               and max(extract_layers) < c.num_layers)
        n_layers = max(extract_layers) + 1 if self.early_exit else c.num_layers
        num_positions = (c.image_size // c.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.empty(c.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.empty(num_positions, c.hidden_size))
        self.patch_proj = nn.Parameter(
            torch.empty(c.patch_size * c.patch_size * c.num_channels,
                        c.hidden_size))
        self.pre_layernorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.layers = nn.ModuleList(
            PreNormEncoderLayer(c.hidden_size, c.num_heads, c.intermediate_size,
                                c.hidden_act, c.layer_norm_eps, dtype)
            for _ in range(n_layers))
        self.post_layernorm = (None if self.early_exit else
                               LayerNorm(c.hidden_size, c.layer_norm_eps, dtype))

    def init_weights(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 1.0, generator=generator)
        self.position_embedding.normal_(0.0, 0.02, generator=generator)
        lecun_normal_(self.patch_proj, self.patch_proj.shape[0], generator)

    def embed_patches(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, 1 + hw, D) with CLS token and resized pos-emb."""
        c = self.config
        b, ch, h, w = pixel_values.shape
        p = c.patch_size
        gh, gw = h // p, w // p
        # space-to-depth (B, C, gh, p, gw, p) -> (B, gh*gw, C*p*p): the
        # channel-major flatten matches the Conv2d weight (out, in, kh, kw)
        x = pixel_values.to(self.dtype).reshape(b, ch, gh, p, gw, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, ch * p * p)
        patches = x @ self.patch_proj.to(self.dtype)

        cls = self.class_embedding.to(self.dtype).expand(b, 1, -1)
        embeds = torch.cat([cls, patches], dim=1)

        pos = self.position_embedding.float()
        grid = c.image_size // p
        if (gh, gw) != (grid, grid):
            patch_pos = pos[1:].reshape(grid, grid, -1).permute(2, 0, 1)
            patch_pos = resize_2d(patch_pos, (gh, gw), "bicubic")
            patch_pos = patch_pos.permute(1, 2, 0).reshape(gh * gw, -1)
            pos = torch.cat([pos[:1], patch_pos], dim=0)
        return embeds + pos[None].to(self.dtype)

    def forward(self, pixel_values: torch.Tensor,
                visual_ctx: Optional[torch.Tensor] = None,
                prompt_depth: int = 0):
        """pixel_values (B, C, H, W); visual_ctx (depth, n, D) or None.
        Returns (hidden_states, last_hidden_state, pooled_output).

        `hidden_states[i]` is the input of layer i (index 0 is the embedding
        output), matching HF `output_hidden_states=True`. With the early exit
        (last, pooled) are None."""
        x = self.embed_patches(pixel_values)
        num_ctx = 0
        if visual_ctx is not None:
            num_ctx = visual_ctx.shape[-2]
            ctx0 = visual_ctx[0].to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([x, ctx0], dim=1)
        x = self.pre_layernorm(x)
        hidden_states = [x]
        for i, layer in enumerate(self.layers, start=1):
            x = remat.layer_call(layer, x)
            if visual_ctx is not None and i < prompt_depth:
                ctx_i = visual_ctx[i].to(x.dtype).expand(x.shape[0], -1, -1)
                x = torch.cat([x[:, :x.shape[1] - num_ctx], ctx_i], dim=1)
            hidden_states.append(x)
        if self.early_exit:
            return hidden_states, None, None
        return hidden_states, x, self.post_layernorm(x[:, 0])

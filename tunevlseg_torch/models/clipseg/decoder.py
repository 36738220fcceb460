"""CLIPSeg FiLM decoder.

Counterpart of `tunevlseg_tpu/models/clipseg/decoder.py:CLIPSegDecoder`:
reversed extract-layer activations, each reduced to reduce_dim and summed;
FiLM conditioning (film_mul(cond) * x + film_add(cond)) at
`conditional_layer`; post-norm ReLU blocks; the CLS token (and trailing
visual prompt tokens) stripped AFTER the blocks; the transposed-convolution
head: one ConvTranspose(patch, stride=patch), or, with
`complex_transposed_convolution` (the CIDAS rd64-refined head), a 3x3
convolution 64 -> 64 with ReLU, ConvTranspose(patch/4) 64 -> 32 with ReLU and
ConvTranspose(patch/4) 32 -> 1. The three blocks run self-attention at 485 tokens, or 485 + num_ctx
with visual prompts (4 heads x 16 dims at rd64), which goes through kernel K1
on the card. `AdditiveHead` is the `use_new_last_layer` head over the
pre-head feature: a bilinear upsample by the patch size and a k5 convolution
with replicate padding.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.nn.conv import Conv2d, ConvTranspose2d
from tunevlseg_torch.nn.layers import Dense, PostNormEncoderLayer
from tunevlseg_torch.ops.image import resize_2d


class CLIPSegDecoder(nn.Module):
    def __init__(self, config: CLIPSegConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        n = len(c.extract_layers)
        self.reduces = nn.ModuleList(
            Dense(c.vision.hidden_size, c.reduce_dim, dtype=dtype) for _ in range(n))
        self.film_mul = Dense(c.projection_dim, c.reduce_dim, dtype=dtype)
        self.film_add = Dense(c.projection_dim, c.reduce_dim, dtype=dtype)
        self.layers = nn.ModuleList(
            PostNormEncoderLayer(c.reduce_dim, c.decoder_num_heads,
                                 c.decoder_intermediate_size, act="relu",
                                 dtype=dtype)
            for _ in range(n))
        if c.complex_transposed_convolution:
            k = c.vision.patch_size // 4
            self.head_conv = Conv2d(c.reduce_dim, c.reduce_dim, 3, padding=1,
                                    dtype=dtype)
            self.head_up1 = ConvTranspose2d(c.reduce_dim, c.reduce_dim // 2, k,
                                            dtype)
            self.head_up2 = ConvTranspose2d(c.reduce_dim // 2, 1, k, dtype)
        else:
            self.head_up = ConvTranspose2d(c.reduce_dim, 1, c.vision.patch_size,
                                           dtype)

    def transposed_convolution(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.complex_transposed_convolution:
            x = torch.relu(self.head_conv(x))
            x = torch.relu(self.head_up1(x))
            return self.head_up2(x)
        return self.head_up(x)

    def forward(self, activations: Sequence[torch.Tensor],
                conditional_embeddings: torch.Tensor, num_visual_ctx: int = 0):
        """activations in extract-layer order (low -> high), each (B, S, Dv);
        conditional_embeddings (B, projection_dim). Returns
        (logits (B, s*patch, s*patch), pre-head feature (B, C, s, s))."""
        c = self.config
        output = None
        for i, act in enumerate(activations[::-1]):
            red = self.reduces[i](act)
            output = red if output is None else red + output
            if i == c.conditional_layer:
                cond = conditional_embeddings.to(output.dtype)
                output = (self.film_mul(cond)[:, None, :] * output
                          + self.film_add(cond)[:, None, :])
            output = self.layers[i](output)

        end = output.shape[1] - num_visual_ctx
        output = output[:, 1:end, :].transpose(1, 2)
        b, ch, hw = output.shape
        size = int(round(hw ** 0.5))
        feat = output.reshape(b, ch, size, size)
        logits = self.transposed_convolution(feat)[:, 0]
        return logits, feat


class AdditiveHead(nn.Module):
    """Upsample(patch, bilinear) + Conv2d(k, same, replicate) over the
    pre-head decoder feature (B, C, s, s) -> (B, s*patch, s*patch). The
    resize emits the replicate-padded map inside its own two products
    (`resize_2d(out_pad=...)`, bitwise the same values) and the convolution
    runs without padding."""

    def __init__(self, config: CLIPSegConfig, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("the additive head takes an odd kernel size")
        self.scale = config.vision.patch_size
        self.pad = (kernel_size - 1) // 2
        self.conv = Conv2d(config.reduce_dim, 1, kernel_size, padding=0,
                           dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h, w = feat.shape[-2:]
        x = resize_2d(feat, (h * self.scale, w * self.scale), "bilinear",
                      out_pad=self.pad)
        return self.conv(x)[:, 0]

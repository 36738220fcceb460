"""CLIPSeg FiLM decoder.

Counterpart of `tunevlseg_tpu/models/clipseg/decoder.py:CLIPSegDecoder`:
reversed extract-layer activations, each reduced to reduce_dim and summed;
FiLM conditioning (film_mul(cond) * x + film_add(cond)) at
`conditional_layer`; post-norm ReLU blocks; the CLS token (and trailing
visual prompt tokens) stripped; the transposed-convolution head. The three
blocks run self-attention at 485 tokens (4 heads x 16 dims at rd64), which
goes through kernel K1 on the card. The refined head (3x3 conv + two
transposed convs) and the additive `use_new_last_layer` head are not ported
yet (the rd64 CoOp path uses neither).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.nn.conv import ConvTranspose2d
from tunevlseg_torch.nn.layers import Dense, PostNormEncoderLayer


class CLIPSegDecoder(nn.Module):
    def __init__(self, config: CLIPSegConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        if c.complex_transposed_convolution:
            raise NotImplementedError(
                "the rd64-refined head (complex_transposed_convolution) is not "
                "ported yet")
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
        self.head_up = ConvTranspose2d(c.reduce_dim, 1, c.vision.patch_size, dtype)

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
        logits = self.head_up(feat)[:, 0]
        return logits, feat

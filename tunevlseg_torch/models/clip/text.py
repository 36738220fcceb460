"""CLIP text tower with prompt-token splicing.

Counterpart of `tunevlseg_tpu/models/clip/text.py` (HF
`CLIPSegTextTransformer` plus the reference's CoOp prompt surgery):

  * token embedding, then `[BOS, ctx, mid..., last]` clipped to
    max_position_embeddings while keeping the final token;
  * position embeddings for the spliced sequence;
  * a causal bias at the new length plus a padding bias whose mask is
    prepended with ones for the context slots and clipped;
  * context slots [1 : 1 + n_ctx] overwritten by `stack[i]` after layer i
    (1-based) while i < prompt_depth;
  * final LayerNorm, then EOS pooling at min(argmax + n_ctx, max_pos - 1),
    with the `eos_token_id == 2` legacy branch (argmax over the ids).

The text tower's 77 (+ctx, clipped to 77) tokens carry a causal + padding
bias: on a CUDA device in bf16 its attention goes to kernel K3
(`nn/attention.py`), elsewhere to the plain path.

Sequence parallelism (`parallel/activation_sharding.py`, the JAX hook
places): when the tower's `seq_parallel` shards the stream (its length
divides by tp; the 77 tokens do not at tp = 2), the stream after the
position embeddings is split over the model group, the context splices
land on the ranks that hold rows 1 .. 1 + n_ctx, and the final LayerNorm's
output is gathered whole before the EOS pooling.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPTextConfig
from tunevlseg_torch.nn import remat
from tunevlseg_torch.nn.attention import causal_bias, padding_bias
from tunevlseg_torch.nn.layers import Embed, LayerNorm, PreNormEncoderLayer
from tunevlseg_torch.parallel import activation_sharding


def splice_text_context(inputs_embeds: torch.Tensor, context: torch.Tensor,
                        max_length: Optional[int]) -> torch.Tensor:
    """[BOS, ctx, mid, last] with truncation preserving the last token.
    inputs_embeds (B, L, D); context (n, D) or (B, n, D)."""
    b, l, _ = inputs_embeds.shape
    if context.dim() == 2:
        context = context[None].expand(b, *context.shape)
    n = context.shape[1]
    mid_last = l - 1 if max_length is None else min(max_length - n, l) - 1
    return torch.cat([inputs_embeds[:, :1], context.to(inputs_embeds.dtype),
                      inputs_embeds[:, 1:mid_last], inputs_embeds[:, -1:]],
                     dim=1)


def extend_text_mask(mask: torch.Tensor, num_context: int,
                     max_length: Optional[int], value: int) -> torch.Tensor:
    """Prepend `num_context` entries of `value`, then clip to max_length."""
    ext = torch.full((mask.shape[0], num_context), value, dtype=mask.dtype,
                     device=mask.device)
    out = torch.cat([ext, mask], dim=1)
    return out if max_length is None else out[:, :max_length]


def eos_pooled_indices(input_ids: torch.Tensor, eos_token_id: int,
                       num_context: int,
                       max_position_embeddings: int) -> torch.Tensor:
    """Index of the pooled (EOT) token per sample after context insertion."""
    ids = input_ids.to(torch.int32)
    # legacy (eos_token_id == 2): the EOT is the highest id of each row
    pre = ids if eos_token_id == 2 else (ids == eos_token_id).to(torch.int32)
    idx = torch.argmax(pre, dim=-1) + num_context
    return idx.clamp(max=max_position_embeddings - 1)


class CLIPTextTower(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.token_embedding = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embedding = Embed(c.max_position_embeddings,
                                        c.hidden_size, dtype)
        self.layers = nn.ModuleList(
            PreNormEncoderLayer(c.hidden_size, c.num_heads, c.intermediate_size,
                                c.hidden_act, c.layer_norm_eps, dtype)
            for _ in range(c.num_layers))
        self.final_layer_norm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                text_ctx: Optional[torch.Tensor] = None,
                prompt_depth: int = 0):
        """input_ids (B, L); text_ctx (depth, n, D) or (depth, B, n, D).
        Returns (last_hidden_state, pooled_output)."""
        c = self.config
        x = self.token_embedding(input_ids)
        num_ctx = 0
        if text_ctx is not None:
            num_ctx = text_ctx.shape[-2]
            x = splice_text_context(x, text_ctx[0], c.max_position_embeddings)

        seq = x.shape[1]
        x = x + self.position_embedding(torch.arange(seq, device=x.device))[None]

        bias = causal_bias(seq, torch.float32, device=x.device)
        if attention_mask is not None:
            mask = attention_mask
            if num_ctx:
                mask = extend_text_mask(mask, num_ctx,
                                        c.max_position_embeddings, 1)
            bias = bias + padding_bias(mask, torch.float32)

        sp = activation_sharding.of(self, x)
        if sp is not None:
            x = sp.split(x)
        for i, layer in enumerate(self.layers, start=1):
            x = remat.layer_call(layer, x, bias, seq_sharded=sp is not None)
            if text_ctx is not None and i < prompt_depth:
                ctx_i = text_ctx[i].to(x.dtype)
                ctx_i = ctx_i.expand(x.shape[0], *ctx_i.shape[-2:])
                x = (torch.cat([x[:, :1], ctx_i, x[:, 1 + num_ctx:]], dim=1)
                     if sp is None else sp.write_rows(x, 1, ctx_i))

        x = self.final_layer_norm(x)
        if sp is not None:
            x = sp.gather(x)
        pool_idx = eos_pooled_indices(input_ids, c.eos_token_id, num_ctx,
                                      c.max_position_embeddings)
        pooled = x[torch.arange(x.shape[0], device=x.device), pool_idx]
        return x, pooled

"""The plain reference of CLIPSeg (CIDAS/clipseg-rd64) with a CoOp learner,
in float32: the model's forward, its DiceCE loss, the gradients autograd
takes of it and AdamW.

It follows HF `CLIPSegForImageSegmentation` and the CoOp prompt surgery of
TuneVLSeg: the text tower splices `num_context` learned vectors after BOS
(the sequence clipped to 77 keeping its last token), pools at the EOT (the
highest id, the legacy `eos_token_id == 2` rule) shifted by the contexts,
and projects to 512; the ViT-B/16 embeds 16x16 patches with bicubically
resized position embeddings and runs up to the deepest extract layer; the
decoder reduces layers (9, 6, 3) to 64 wide, FiLM-conditions after the
first, runs three post-norm blocks, drops the CLS token and upsamples with
one transposed convolution. Departures from HF, kept as the program has
them: the vision tower stops after layer 10 (nothing reads the rest), and
the patch embedding is the stride-16 convolution written as one product.

`text_index` (B,) maps each image to its prompt row, so one prompt row
serves a batch (the deduplicated layout of the CoOp recipe).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.reference.common import (ConvTranspose, Dense, Embed, LayerNorm,
                                        PostNormLayer, PreNormLayer, causal_bias,
                                        linear, normalize_uint8, padding_bias,
                                        resize)


class TextTower(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d = c["hidden_size"]
        self.max_len = c["max_position_embeddings"]
        self.token_embedding = Embed(c["vocab_size"], d)
        self.position_embedding = Embed(self.max_len, d)
        self.layers = nn.ModuleList(
            PreNormLayer(d, c["num_attention_heads"], c["intermediate_size"])
            for _ in range(c["num_hidden_layers"]))
        self.final_layer_norm = LayerNorm(d)

    def forward(self, ids, keep, ctx: Optional[torch.Tensor]):
        """ids, keep (U, L); ctx (n, D) or None. Returns the pooled (U, D)."""
        x = self.token_embedding(ids)
        n = 0
        if ctx is not None:
            n = ctx.shape[0]
            u, length = ids.shape
            mid_last = min(self.max_len - n, length) - 1
            x = torch.cat([x[:, :1], ctx[None].expand(u, -1, -1),
                           x[:, 1:mid_last], x[:, -1:]], dim=1)
            keep = torch.cat([torch.ones_like(keep[:, :n]), keep], 1)[:, :self.max_len]
        seq = x.shape[1]
        x = x + self.position_embedding.weight[:seq][None]
        bias = causal_bias(seq, x.device) + padding_bias(keep)
        for layer in self.layers:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        pool = (ids.argmax(-1) + n).clamp(max=self.max_len - 1)
        return x[torch.arange(x.shape[0], device=x.device), pool]


class VisionTower(nn.Module):
    def __init__(self, c: dict, n_layers: int):
        super().__init__()
        d, p = c["hidden_size"], c["patch_size"]
        self.patch, self.grid = p, c["image_size"] // p
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = nn.Parameter(torch.empty(self.grid ** 2 + 1, d))
        self.patch_proj = nn.Parameter(torch.empty(3 * p * p, d))
        self.pre_layernorm = LayerNorm(d)
        self.layers = nn.ModuleList(
            PreNormLayer(d, c["num_attention_heads"], c["intermediate_size"])
            for _ in range(n_layers))

    def forward(self, pixels):
        """(B, 3, H, W) -> the input of every layer and the last output."""
        b, ch, h, w = pixels.shape
        p, gh, gw = self.patch, h // self.patch, w // self.patch
        x = pixels.reshape(b, ch, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
        x = linear(x.reshape(b, gh * gw, ch * p * p), self.patch_proj.T)
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], 1)
        pos = self.position_embedding
        if (gh, gw) != (self.grid, self.grid):
            grid = pos[1:].reshape(self.grid, self.grid, -1).permute(2, 0, 1)
            grid = resize(grid, (gh, gw), "bicubic").permute(1, 2, 0)
            pos = torch.cat([pos[:1], grid.reshape(gh * gw, -1)], 0)
        x = self.pre_layernorm(x + pos[None])
        states = [x]
        for layer in self.layers:
            x = layer(x)
            states.append(x)
        return states


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        n, r = len(c["extract_layers"]), c["reduce_dim"]
        dv = c["vision_config"]["hidden_size"]
        self.reduces = nn.ModuleList(Dense(dv, r) for _ in range(n))
        self.film_mul = Dense(c["projection_dim"], r)
        self.film_add = Dense(c["projection_dim"], r)
        self.layers = nn.ModuleList(
            PostNormLayer(r, c["decoder_num_attention_heads"],
                          c["decoder_intermediate_size"]) for _ in range(n))
        self.head_up = ConvTranspose(r, 1, c["vision_config"]["patch_size"])
        self.conditional_layer = c["conditional_layer"]

    def forward(self, activations, cond):
        out = None
        for i, act in enumerate(activations[::-1]):
            red = self.reduces[i](act)
            out = red if out is None else red + out
            if i == self.conditional_layer:
                out = self.film_mul(cond)[:, None] * out + self.film_add(cond)[:, None]
            out = self.layers[i](out)
        out = out[:, 1:].transpose(1, 2)
        b, ch, hw = out.shape
        s = int(round(hw ** 0.5))
        return self.head_up(out.reshape(b, ch, s, s))


class Learner(nn.Module):
    def __init__(self, depth: int, n_ctx: int, dim: int):
        super().__init__()
        self.context_vectors = nn.Parameter(torch.empty(depth, n_ctx, dim))


class CLIPSeg(nn.Module):
    """CLIPSeg rd64 with a CoOp learner of prompt depth 1 (`recipe["strategy"]
    == "coop"`), or alone (`"e2e"`)."""

    def __init__(self, config: dict, recipe: dict):
        super().__init__()
        c = config
        self.extract = tuple(c["extract_layers"])
        self.text_model = TextTower(c["text_config"])
        self.vision_model = VisionTower(c["vision_config"], max(self.extract) + 1)
        self.text_projection = Dense(c["text_config"]["hidden_size"],
                                     c["projection_dim"], bias=False)
        self.decoder = Decoder(c)
        self.coop = recipe["strategy"] == "coop"
        if self.coop:
            if recipe["prompt_depth"] != 1:
                raise ValueError("the reference's CoOp learner splices at depth 1")
            self.learner = Learner(1, recipe["num_context"],
                                   c["text_config"]["hidden_size"])
            # the additive head the CoOp recipe builds and never reads
            self.residual_ratio = nn.Parameter(torch.empty(()))

    def forward(self, batch: dict) -> torch.Tensor:
        pixels = normalize_uint8(batch["image"])
        states = self.vision_model(pixels)
        acts = [states[i + 1] for i in self.extract]
        ctx = self.learner.context_vectors[0] if self.coop else None
        pooled = self.text_model(batch["input_ids"], batch["attention_mask"], ctx)
        cond = self.text_projection(pooled)
        if "text_index" in batch:
            cond = cond[batch["text_index"].long()]
        return self.decoder(acts, cond)                       # (B, 1, H, W)


def trainable(model: CLIPSeg) -> list[str]:
    """The leaves the recipe trains: CoOp's context vectors and the unread
    `residual_ratio` (the towers and the decoder frozen), or every leaf of
    the end-to-end fine-tune."""
    if model.coop:
        return ["learner.context_vectors", "residual_ratio"]
    return [n for n, _ in model.named_parameters()]


def build(config: dict, recipe: dict) -> CLIPSeg:
    return CLIPSeg(config, recipe)

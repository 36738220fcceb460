"""The plain reference of CRIS RN50 with a CoOp learner, in float32: the
model's forward, its DiceCE loss, the gradients autograd takes of it and
AdamW (`reference/steps.py`).

It follows CRIS.pytorch (`model/segmenter.py`, `model/layers.py`,
`model/clip.py`; `config/refcoco/cris_r50.yaml`) and the CoOp prompt
surgery of TuneVLSeg:

  * CLIP's `ModifiedResNet` (RN50): a stem of three 3x3 convolutions, each
    with BatchNorm and ReLU, and a 2x2 average pool; four stages of
    Bottlenecks (3, 4, 6, 3) whose stride is an average pool after the 3x3
    convolution, and on the shortcut before its 1x1 convolution; CRIS's
    attention pool, which attends over every position of C5 (no pooled
    token) with the positional embedding's grid resized bicubically, and
    adds a 1x1 convolution with BatchNorm of C5 before a ReLU;
  * the causal text tower: CoOp's `num_context` vectors spliced after BOS
    (the sequence clipped to 77, its last token kept), written again over
    their slots after block i while the 0-based i < prompt depth, the
    key-padding mask extended with kept entries for the contexts, pooling
    at the highest id's position shifted by the contexts, the projection
    to 1024;
  * the FPN that gates C5 by the text state, the three decoder layers
    (self-attention over the 26x26 tokens, cross-attention into the text
    with the key-padding bias, the FFN with its inner LayerNorm; sine
    position encodings), the projector's dynamic 3x3 convolution, the
    bicubic `align_corners=True` upsample to 416, and TuneVLSeg's residual
    head (1x1 convolution, bilinear resize, 5x5 convolution with replicate
    padding, blended by `residual_ratio`).

Departures from CRIS.pytorch, kept as the program has them: BatchNorm
always normalises with its running statistics (the CoOp recipe freezes
every BatchNorm); the attention probabilities are not dropped
(`nn.MultiheadAttention(dropout=0.2)` drops them in CRIS.pytorch: the
program's attention kernels have no dropout); images are normalised with
ImageNet's statistics, as every recipe of the repository does. The decay
of AdamW does not matter here: the recipe's decay is 0.

Decoder dropout (0.2) reproduces the program's masks: each train step draws
them from a generator on the model's device seeded as the program seeds
step s (`seed * 1,000,003 + s`, the task's seed 0, one rank), in the
program's order (per layer: after the self-attention, after the
cross-attention, inside the FFN, after it) and at the whole batch's shapes;
a block of rows takes its rows of them. A block's step and rows are read off
its image tensor, a view into the stacked batches of a pool (`row_blocks`
over `checked_steps`); a batch that is no such view is a step of its own.
Without gradients (a forward for probabilities) no dropout applies.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.common import (Dense, Embed, LayerNorm, Precision,
                                        PreNormLayer, attention, causal_bias,
                                        normalize_uint8, padding_bias, resize)

BN_EPS = 1e-5


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 0, groups: int = 1):
    return F.conv2d(Precision.op(x), Precision.op(weight), bias, stride=stride,
                    padding=padding, groups=groups)


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, padding: int = 0,
                 stride: int = 1, bias: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.empty(c_out)) if bias else None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class BatchNorm(nn.Module):
    """Frozen BatchNorm over axis 1: the running statistics, then the affine."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n))
        self.bias = nn.Parameter(torch.empty(n))
        self.register_buffer("running_mean", torch.empty(n))
        self.register_buffer("running_var", torch.empty(n))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, BN_EPS)


class ConvBnRelu(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 1, padding: int = 0):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, padding)
        self.bn = BatchNorm(c_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int):
        super().__init__()
        out = planes * 4
        self.stride = stride
        self.conv1, self.bn1 = Conv(inplanes, planes, 1), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, 1), BatchNorm(planes)
        self.conv3, self.bn3 = Conv(planes, out, 1), BatchNorm(out)
        self.down = stride > 1 or inplanes != out
        if self.down:
            self.downsample_conv = Conv(inplanes, out, 1)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.down:
            if self.stride > 1:
                identity = F.avg_pool2d(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class AttentionPool(nn.Module):
    """CRIS's attention pool: every position of C5 attends to every other,
    the positional grid resized bicubically to the map's; the output keeps
    the map, plus a 1x1 convolution with BatchNorm of C5, then a ReLU."""

    def __init__(self, spacial: int, dim: int, heads: int, out: int):
        super().__init__()
        self.spacial, self.heads = spacial, heads
        self.connect_conv, self.connect_bn = Conv(dim, out, 1), BatchNorm(out)
        self.positional_embedding = nn.Parameter(torch.empty(spacial ** 2 + 1, dim))
        self.q_proj, self.k_proj = Dense(dim, dim), Dense(dim, dim)
        self.v_proj, self.c_proj = Dense(dim, dim), Dense(dim, out)

    def forward(self, x):
        b, c, h, w = x.shape
        res = self.connect_bn(self.connect_conv(x))
        grid = self.positional_embedding[1:].reshape(self.spacial, self.spacial, c)
        pos = resize(grid.permute(2, 0, 1), (h, w), "bicubic").reshape(c, h * w).T
        seq = x.flatten(2).transpose(1, 2) + pos[None]

        def split(t):
            return t.unflatten(-1, (self.heads, -1))

        out = attention(split(self.q_proj(seq)), split(self.k_proj(seq)),
                        split(self.v_proj(seq)))
        out = self.c_proj(out.flatten(-2)).transpose(1, 2).reshape(b, -1, h, w)
        return F.relu(out + res)


class ResNet(nn.Module):
    """CLIP's ModifiedResNet: (B, 3, H, W) -> (C3, C4, C5')."""

    def __init__(self, c: dict):
        super().__init__()
        w = c["vision_width"]
        for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)),
                                        start=1):
            setattr(self, f"conv{i}", Conv(cin, cout, 3, 1, stride=2 if i == 1 else 1))
            setattr(self, f"bn{i}", BatchNorm(cout))
        inplanes = w
        for stage, blocks in enumerate(c["vision_layers"], start=1):
            planes = w * 2 ** (stage - 1)
            mods = []
            for i in range(blocks):
                mods.append(Bottleneck(inplanes, planes, 2 if i == 0 and stage > 1 else 1))
                inplanes = planes * 4
            setattr(self, f"layer{stage}", nn.ModuleList(mods))
        self.attnpool = AttentionPool(c["image_resolution"] // 32, w * 32,
                                      c["vision_heads"], c["embed_dim"])

    def forward(self, x):
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        feats = []
        for stage in (1, 2, 3, 4):
            for block in getattr(self, f"layer{stage}"):
                x = block(x)
            feats.append(x)
        return feats[1], feats[2], self.attnpool(feats[3])


class TextTower(nn.Module):
    """CLIP's causal text transformer with CRIS's prompt hooks."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["transformer_width"]
        self.max_len = c["context_length"]
        self.token_embedding = Embed(c["vocab_size"], d)
        self.positional_embedding = nn.Parameter(torch.empty(self.max_len, d))
        self.resblocks = nn.ModuleList(
            PreNormLayer(d, c["transformer_heads"], 4 * d)
            for _ in range(c["transformer_layers"]))
        self.ln_final = LayerNorm(d)
        self.text_projection = nn.Parameter(torch.empty(d, c["embed_dim"]))

    def forward(self, ids, keep, ctx: Optional[torch.Tensor], depth: int):
        """ids, keep (U, L); ctx (depth, n, D) or None. Returns the tokens
        (U, L', D), the state (U, embed_dim) and the keep-mask (U, L')."""
        x = self.token_embedding(ids)
        n = 0
        if ctx is not None:
            n = ctx.shape[1]
            u, length = ids.shape
            mid_last = min(self.max_len - n, length) - 1
            x = torch.cat([x[:, :1], ctx[0][None].expand(u, -1, -1),
                           x[:, 1:mid_last], x[:, -1:]], dim=1)
            keep = torch.cat([torch.ones_like(keep[:, :n]), keep], 1)[:, :self.max_len]
        seq = x.shape[1]
        x = x + self.positional_embedding[:seq][None]
        bias = causal_bias(seq, x.device) + padding_bias(keep)
        for i, block in enumerate(self.resblocks):
            x = block(x, bias)
            if ctx is not None and i < depth:
                x = torch.cat([x[:, :1], ctx[i][None].expand(x.shape[0], -1, -1),
                               x[:, 1 + n:]], dim=1)
        x = self.ln_final(x)
        pool = (ids.argmax(-1) + n).clamp(max=self.max_len - 1)
        pooled = x[torch.arange(x.shape[0], device=x.device), pool]
        return x, pooled @ self.text_projection, keep


class LinearBnRelu(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.linear = Dense(d_in, d_out, bias=False)
        self.bn = BatchNorm(d_out)

    def forward(self, x):
        return F.relu(self.bn(self.linear(x)))


def upsample2(x):
    return resize(x, (2 * x.shape[-2], 2 * x.shape[-1]), "bilinear")


def add_coords(x):
    b, _, h, w = x.shape
    xs = torch.linspace(-1, 1, w, device=x.device)
    ys = torch.linspace(-1, 1, h, device=x.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.cat([x, torch.stack([xx, yy])[None].expand(b, 2, h, w)], 1)


class FPN(nn.Module):
    """CRIS's neck: C5 gated by the text state, fused down to C3's scale."""

    def __init__(self, ci, co):
        super().__init__()
        self.txt_proj = LinearBnRelu(ci[2], co[2])
        self.f1_v_proj = ConvBnRelu(ci[2], co[2], 1, 0)
        self.norm_layer_bn = BatchNorm(co[2])
        self.f2_v_proj = ConvBnRelu(ci[1], co[1], 3, 1)
        self.f2_cat = ConvBnRelu(co[2] + co[1], co[1], 1, 0)
        self.f3_v_proj = ConvBnRelu(ci[0], co[0], 3, 1)
        self.f3_cat = ConvBnRelu(co[0] + co[1], co[1], 1, 0)
        self.f4_proj5 = ConvBnRelu(co[2], co[1], 3, 1)
        self.f4_proj4 = ConvBnRelu(co[1], co[1], 3, 1)
        self.f4_proj3 = ConvBnRelu(co[1], co[1], 3, 1)
        self.aggr = ConvBnRelu(3 * co[1], co[1], 1, 0)
        self.coordconv_0 = ConvBnRelu(co[1] + 2, co[1], 3, 1)
        self.coordconv_1 = ConvBnRelu(co[1], co[1], 3, 1)

    def forward(self, feats, state):
        v3, v4, v5 = feats
        s = self.txt_proj(state)
        f5 = F.relu(self.norm_layer_bn(self.f1_v_proj(v5) * s[:, :, None, None]))
        f4 = self.f2_cat(torch.cat([self.f2_v_proj(v4), upsample2(f5)], 1))
        f3 = self.f3_cat(torch.cat([F.avg_pool2d(self.f3_v_proj(v3), 2), f4], 1))
        fq = torch.cat([self.f4_proj3(f3), self.f4_proj4(f4),
                        upsample2(self.f4_proj5(f5))], 1)
        return self.coordconv_1(self.coordconv_0(add_coords(self.aggr(fq))))


def sine_1d(d: int, length: int, device) -> torch.Tensor:
    """(length, d) sine / cosine position encoding (CRIS's PositionEncoding)."""
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * -(math.log(1e4) / d))
    pe = torch.zeros(length, d, dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    return pe.float().to(device)


def sine_2d(d: int, h: int, w: int, device) -> torch.Tensor:
    """(h·w, d): the first half of the channels encodes the column, the
    second half the row (CRIS's pos2d)."""
    half = d // 2
    div = torch.exp(torch.arange(0, half, 2, dtype=torch.float64)
                    * -(math.log(1e4) / half))
    pe = torch.zeros(d, h, w, dtype=torch.float64)
    cols = torch.arange(w, dtype=torch.float64)[:, None] * div     # (w, half/2)
    rows = torch.arange(h, dtype=torch.float64)[:, None] * div
    pe[0:half:2] = torch.sin(cols).T[:, None, :].expand(-1, h, -1)
    pe[1:half:2] = torch.cos(cols).T[:, None, :].expand(-1, h, -1)
    pe[half::2] = torch.sin(rows).T[:, :, None].expand(-1, -1, w)
    pe[half + 1::2] = torch.cos(rows).T[:, :, None].expand(-1, -1, w)
    return pe.reshape(d, h * w).T.float().to(device)


class MHA(nn.Module):
    """Multi-head attention with separate query, key and value inputs."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Dense(dim, dim), Dense(dim, dim)
        self.v_proj, self.out_proj = Dense(dim, dim), Dense(dim, dim)

    def forward(self, q, k, v, bias=None):
        def split(t):
            return t.unflatten(-1, (self.heads, -1))

        out = attention(split(self.q_proj(q)), split(self.k_proj(k)),
                        split(self.v_proj(v)), bias)
        return self.out_proj(out.flatten(-2))


class DecoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, ffn: int):
        super().__init__()
        self.norm1, self.self_attn_norm = LayerNorm(d), LayerNorm(d)
        self.self_attn = MHA(d, heads)
        self.norm2, self.cross_attn_norm = LayerNorm(d), LayerNorm(d)
        self.multihead_attn = MHA(d, heads)
        self.norm3 = LayerNorm(d)
        self.ffn_0, self.ffn_norm, self.ffn_1 = Dense(d, ffn), LayerNorm(ffn), Dense(ffn, d)

    def forward(self, vis, txt, vis_pos, txt_pos, bias, drop):
        v2 = self.norm1(vis)
        qk = v2 + vis_pos
        vis = vis + drop(self.self_attn_norm(self.self_attn(qk, qk, v2)))
        v2 = self.norm2(vis)
        v2 = self.multihead_attn(v2 + vis_pos, txt + txt_pos, txt, bias)
        vis = vis + drop(self.cross_attn_norm(v2))
        v2 = drop(F.relu(self.ffn_0(self.norm3(vis))))
        return vis + drop(self.ffn_1(self.ffn_norm(v2)))


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(c["vis_dim"], c["num_head"], c["dim_ffn"])
            for _ in range(c["num_layers"]))
        self.norm = LayerNorm(c["vis_dim"])

    def forward(self, fq, txt, keep, drop):
        b, c, h, w = fq.shape
        vis_pos = sine_2d(c, h, w, fq.device)
        txt_pos = sine_1d(txt.shape[-1], txt.shape[1], fq.device)
        bias = padding_bias(keep)
        vis = fq.flatten(2).transpose(1, 2)
        for layer in self.layers:
            vis = layer(vis, txt, vis_pos, txt_pos, bias, drop)
        return self.norm(vis).transpose(1, 2).reshape(b, c, h, w)


class Projector(nn.Module):
    """Upsampling projector and the per-image dynamic convolution whose
    kernel and bias come from the text state."""

    def __init__(self, word_dim: int, in_dim: int, k: int = 3):
        super().__init__()
        self.k = k
        self.vis_1 = ConvBnRelu(2 * in_dim, 2 * in_dim, 3, 1)
        self.vis_3 = ConvBnRelu(2 * in_dim, in_dim, 3, 1)
        self.vis_4 = Conv(in_dim, in_dim, 1, bias=True)
        self.txt = Dense(word_dim, in_dim * k * k + 1)

    def forward(self, x, word):
        x = self.vis_4(self.vis_3(upsample2(self.vis_1(upsample2(x)))))
        b, c, h, w = x.shape
        params = self.txt(word)
        weight = params[:, :-1].reshape(b, c, self.k, self.k)
        # each image's own kernel: a grouped convolution over the batch
        out = conv2d(x.reshape(1, b * c, h, w), weight, padding=self.k // 2, groups=b)
        return out.reshape(b, 1, h, w) + params[:, -1].reshape(b, 1, 1, 1)


class Learner(nn.Module):
    def __init__(self, depth: int, n_ctx: int, dim: int):
        super().__init__()
        self.context_vectors = nn.Parameter(torch.empty(depth, n_ctx, dim))


def step_seed(seed: int, step: int) -> int:
    """The seed of train step `step`'s dropout masks, as the program seeds
    it on one rank."""
    return (seed * 1_000_003 + step) % 2 ** 63


class Dropout:
    """The decoder's dropout masks of one block of rows: drawn at the whole
    step's shapes, in the program's order, from the step's generator; the
    block takes its rows."""

    def __init__(self, rate: float, gen: torch.Generator, rows: slice, batch: int):
        self.keep, self.gen, self.rows, self.batch = 1.0 - rate, gen, rows, batch

    def __call__(self, x):
        full = (self.batch,) + tuple(x.shape[1:])
        mask = torch.rand(full, device=x.device, generator=self.gen)[self.rows] < self.keep
        return torch.where(mask, x / self.keep, torch.zeros((), device=x.device))


def _identity(x):
    return x


def block_rows(image: torch.Tensor) -> tuple:
    """(key of the step, the step's batch size, first row) of a block's
    images: a view of a pool's stacked (k, B, ...) batches, or a batch of
    its own."""
    base = image._base
    if base is None or base.dim() != image.dim() + 1:
        return (id(image),), image.shape[0], 0
    row = image[0].numel() if image.shape[0] else 1
    first = image.storage_offset() // row
    b = base.shape[1]
    return (base.untyped_storage().data_ptr(), first // b), b, first % b


class CRIS(nn.Module):
    """CRIS RN50 with a CoOp learner (`recipe["strategy"] == "coop"`) and
    TuneVLSeg's residual head."""

    def __init__(self, config: dict, recipe: dict):
        super().__init__()
        c = config
        if recipe["strategy"] != "coop":
            raise ValueError("the reference's CRIS runs the CoOp recipe")
        self.img_size = c["img_size"]
        self.rate = c["dropout"]
        self.depth = recipe["prompt_depth"]
        self.visual = ResNet(c)
        self.text = TextTower(c)
        self.neck = FPN(c["fpn_in"], c["fpn_out"])
        self.decoder = Decoder(c)
        self.proj = Projector(c["embed_dim"], c["vis_dim"] // 2)
        self.learner = Learner(self.depth, recipe["num_context"], c["transformer_width"])
        self.additive_conv1 = Conv(c["vis_dim"], 64, 1)
        self.additive_conv2 = Conv(64, 1, 5, bias=True)
        self.residual_ratio = nn.Parameter(torch.empty(()))
        self.steps: dict = {}     # step key -> step index, in order of first sight
        self.step_gen = None

    def dropout(self, image: torch.Tensor):
        """The dropout of this block's rows: none without gradients or on
        the meta device."""
        if not torch.is_grad_enabled() or image.device.type == "meta" or not self.rate:
            return _identity
        key, batch, first = block_rows(image)
        if key not in self.steps:
            self.steps[key] = len(self.steps)
        gen = torch.Generator(device=image.device)
        gen.manual_seed(step_seed(0, self.steps[key]))
        return Dropout(self.rate, gen, slice(first, first + image.shape[0]), batch)

    def forward(self, batch: dict) -> torch.Tensor:
        drop = self.dropout(batch["image"])
        feats = self.visual(normalize_uint8(batch["image"]))
        tokens, state, keep = self.text(batch["input_ids"], batch["attention_mask"],
                                        self.learner.context_vectors[:self.depth],
                                        self.depth)
        if "text_index" in batch:
            idx = batch["text_index"].long()
            tokens, state, keep = tokens[idx], state[idx], keep[idx]
        fq = self.decoder(self.neck(feats, state), tokens, keep, drop)
        size = (self.img_size, self.img_size)
        logits = resize(self.proj(fq, state), size, "bicubic", align_corners=True)
        head = self.additive_conv2(F.pad(resize(self.additive_conv1(fq), size, "bilinear"),
                                         (2, 2, 2, 2), mode="replicate"))
        r = self.residual_ratio
        return (1 - r) * logits + r * head                        # (B, 1, H, W)


def trainable(model: CRIS) -> list[str]:
    """The leaves the CoOp recipe trains: the context vectors and the
    residual head (CRIS and its towers frozen)."""
    return ["residual_ratio", "learner.context_vectors", "additive_conv1.weight",
            "additive_conv2.weight", "additive_conv2.bias"]


def build(config: dict, recipe: dict) -> CRIS:
    return CRIS(config, recipe)

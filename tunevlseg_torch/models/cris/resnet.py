"""CLIP ModifiedResNet (RN50), the CRIS image tower.

Counterpart of `tunevlseg_tpu/models/cris/resnet.py`: Bottleneck with the
anti-aliased stride (an average pool after conv2), the 3-conv stem, and the
CRIS variant of AttentionPool2d, which keeps the spatial map, adds a conv+BN
residual and bicubic-resizes its positional embedding. Returns the
(C3, C4, C5') pyramid. Submodule names follow the JAX param tree
(`layer{stage}` is a ModuleList, so `layer1.0` is the JAX `layer1_0`).

BatchNorm takes `use_running_average` explicitly, as the JAX modules do, and
never reads `nn.Module.training`: a frozen CRIS normalises with its running
statistics in a train step too. Only the NCHW layout is ported. The JAX
package's "nhwc" layout is a TPU layout experiment; its "flat" layout runs
the stages through the flat guard-banded convolution kernel (K4), which is
not ported yet, and raises here.

Memory format: tensors keep their NCHW shape everywhere, but the backbone
follows its weights: where `build_cris` has stored the 4-D convolution
weights channels-last, the image batch is converted on entry and every
activation stays channels-last, so that cuDNN's bf16 kernels, which compute
in NHWC, need no layout transposes around each convolution. The head's weights stay contiguous (the times of the three
arrangements on an H100 are in PERF.md, from
scripts/torch_cris_stages.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.nn.attention import dot_product_attention
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.nn.layers import Dense
from tunevlseg_torch.ops.image import resize_2d

_BATCH_STATS = ("BatchNorm batch statistics (the JAX task's "
                "mutable_collections) come with the e2e CRIS train step, "
                "ROADMAP Slice C")


class _BatchNorm(nn.Module):
    """torch BatchNorm semantics (eps 1e-5) over the channel axis 1, with the
    running statistics as buffers: statistics and the affine in f32, output
    in the input's dtype."""

    def __init__(self, features: int, use_running_average: bool = True,
                 epsilon: float = 1e-5):
        super().__init__()
        self.use_running_average = use_running_average
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_running_average:
            raise NotImplementedError(_BATCH_STATS)
        # one pass: f32 arithmetic inside, one rounding to x's dtype
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.epsilon)


class BatchNorm2d(_BatchNorm):
    """On (B, C, H, W)."""


class BatchNorm1d(_BatchNorm):
    """On (B, C)."""


def avg_pool_nchw(x: torch.Tensor, window: int) -> torch.Tensor:
    """nn.AvgPool2d(window) on NCHW (stride == window)."""
    return F.avg_pool2d(x, window)


class Bottleneck(nn.Module):
    EXPANSION = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_running_average: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ura, out = use_running_average, planes * self.EXPANSION
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, ura)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, ura)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out, ura)
        self.has_downsample = stride > 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = Conv2d(inplanes, out, 1, bias=False, dtype=dtype)
            self.downsample_bn = BatchNorm2d(out, ura)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = avg_pool_nchw(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = avg_pool_nchw(x, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """CRIS variant: spatial self-attention over the C5 map with a
    bicubic-resized positional embedding and a conv+BN residual; returns a
    (B, output_dim, H, W) map (no CLS pooling). At 416^2 the map has 169
    tokens, below the kernel gate's 256: plain attention."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, use_running_average: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spacial_dim, self.embed_dim = spacial_dim, embed_dim
        self.num_heads, self.output_dim = num_heads, output_dim
        self.connect_conv = Conv2d(embed_dim, output_dim, 1, bias=False, dtype=dtype)
        self.connect_bn = BatchNorm2d(output_dim, use_running_average)
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.c_proj = Dense(embed_dim, output_dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.positional_embedding.normal_(0.0, self.embed_dim ** -0.5,
                                          generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        res = self.connect_bn(self.connect_conv(x))
        # drop the CLS slot; bicubic-resize the spatial grid to (h, w)
        grid = self.positional_embedding[1:].float().reshape(
            self.spacial_dim, self.spacial_dim, self.embed_dim).permute(2, 0, 1)
        pos_hw = resize_2d(grid, (h, w), "bicubic").reshape(self.embed_dim, h * w).T
        seq = x.reshape(b, c, h * w).transpose(1, 2)            # (B, hw, C)
        seq = seq + pos_hw[None].to(seq.dtype)

        def split(t):
            return t.unflatten(-1, (self.num_heads, -1))

        attn = dot_product_attention(split(self.q_proj(seq)),
                                     split(self.k_proj(seq)),
                                     split(self.v_proj(seq)))
        out = self.c_proj(attn.flatten(-2))
        out = out.transpose(1, 2).reshape(b, self.output_dim, h, w)
        return F.relu(out + res)


class ModifiedResNet(nn.Module):
    """(B, 3, H, W) -> (C3, C4, C5') with strides 8 / 16 / 32, all NCHW."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224, width: int = 64,
                 use_running_average: bool = True, layout: str = "nchw",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layout == "flat":
            raise NotImplementedError(
                'layout="flat" runs the stages through the flat convolution '
                "kernel K4, ops/conv_pallas.py, which is still to be ported "
                "(ROADMAP Queue 2)")
        if layout != "nchw":
            raise ValueError(f'layout {layout!r}: the port runs "nchw" (the '
                             'JAX package\'s "nhwc" is a TPU layout experiment)')
        ura, w = use_running_average, width
        for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2),
                                         (w // 2, w)), start=1):
            setattr(self, f"conv{i}", Conv2d(cin, cout, 3, stride=2 if i == 1 else 1,
                                             padding=1, bias=False, dtype=dtype))
            setattr(self, f"bn{i}", BatchNorm2d(cout, ura))
        inplanes = w
        for stage, (planes, blocks) in enumerate(
                zip((w, w * 2, w * 4, w * 8), layers), start=1):
            stage_blocks = []
            for b in range(blocks):
                stride = 2 if b == 0 and stage > 1 else 1
                stage_blocks.append(Bottleneck(inplanes, planes, stride, ura, dtype))
                inplanes = planes * Bottleneck.EXPANSION
            setattr(self, f"layer{stage}", nn.ModuleList(stage_blocks))
        self.attnpool = AttentionPool2d(input_resolution // 32, w * 32, heads,
                                        output_dim, ura, dtype)

    def forward(self, x: torch.Tensor):
        if self.conv1.weight.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous(memory_format=torch.channels_last)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = avg_pool_nchw(x, 2)
        feats = []
        for stage in (1, 2, 3, 4):
            for block in getattr(self, f"layer{stage}"):
                x = block(x)
            feats.append(x)
        return feats[1], feats[2], self.attnpool(feats[3])

"""Detectron2-style ResNet-FPN backbone for FreeSOLO / SOLOv2.

Counterpart of `tunevlseg_tpu/models/solov2/backbone.py` (the reference's
vendored detectron2 resnet.py / fpn.py):
  * BasicStem: 7x7/2 convolution + FrozenBN + ReLU + 3x3/2 max pool;
  * BottleneckBlocks with FrozenBN, the stride in the 3x3 convolution
    (STRIDE_IN_1X1 False in the zsseg config), a 1x1 shortcut convolution on
    block 0 of each stage;
  * FPN: 1x1 laterals and 3x3 outputs, nearest top-down upsampling, sum
    fusion, p6 = max_pool(p5, 1, 2, 0) (LastLevelMaxPool).

FrozenBatchNorm is a pure affine at inference, y = (x - running_mean) /
sqrt(running_var + eps) * weight + bias, kept as four parameters (they are
parameters in the JAX tree too) so detectron2 checkpoints map one to one.

Layouts: "nchw" runs every convolution through `F.conv2d` (cuDNN on the
card). "flat" chains blocks 1.. of each stage through the flat guard-banded
convolution K4 (`tunevlseg_torch/ops/conv_flat.py`) with the folded FrozenBN,
the ReLUs and the residual fused into the kernel, one `flat_begin` /
`flat_end` per stage; block 0 (strided past res2, with the projection
shortcut) stays on `F.conv2d`, as the JAX package keeps it on the XLA path.
The JAX package picks the flat path with the trace-time variable
`TUNEVLSEG_PALLAS_CONV`; the port takes it as the constructor argument
`layout`. Parameter names are the same in both layouts.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.models.cris.resnet import from_flat, to_flat
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.ops.conv_flat import FlatSpec, conv_flat, make_flat_spec

RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
LAYOUTS = ("nchw", "flat")


class FrozenBN(nn.Module):
    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.running_mean = nn.Parameter(torch.empty(features))
        self.running_var = nn.Parameter(torch.empty(features))

    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def folded_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, offset) in f32, for the flat convolution's epilogue."""
        s = self.weight.float() * torch.rsqrt(self.running_var.float() + self.epsilon)
        return s, self.bias.float() - self.running_mean.float() * s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, o = self.folded_affine()
        return (x * s.reshape(1, -1, 1, 1).to(x.dtype)
                + o.reshape(1, -1, 1, 1).to(x.dtype))


def max_pool_nchw(x: torch.Tensor, window: int, stride: int,
                  padding: int) -> torch.Tensor:
    """Max pool with -inf padding (`lax.reduce_window` with max)."""
    return F.max_pool2d(x, window, stride, padding)


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        bc = bottleneck_channels
        self.conv1 = Conv2d(in_channels, bc, 1, bias=False, dtype=dtype)
        self.conv1_norm = FrozenBN(bc)
        self.conv2 = Conv2d(bc, bc, 3, stride=stride, padding=1, bias=False,
                            dtype=dtype)
        self.conv2_norm = FrozenBN(bc)
        self.conv3 = Conv2d(bc, out_channels, 1, bias=False, dtype=dtype)
        self.conv3_norm = FrozenBN(out_channels)
        self.has_shortcut = in_channels != out_channels or stride > 1
        if self.has_shortcut:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride=stride,
                                   bias=False, dtype=dtype)
            self.shortcut_norm = FrozenBN(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1_norm(self.conv1(x)))
        out = F.relu(self.conv2_norm(self.conv2(out)))
        out = self.conv3_norm(self.conv3(out))
        sc = self.shortcut_norm(self.shortcut(x)) if self.has_shortcut else x
        return F.relu(out + sc)

    def forward_flat(self, x: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
        """A stride-1 block without a shortcut on flat tensors: three K4
        launches, the FrozenBN affines, the residual add and all ReLUs fused
        into them."""
        assert not self.has_shortcut
        out = conv_flat(x, spec, self.conv1.weight,
                        *self.conv1_norm.folded_affine(), relu=True)
        out = conv_flat(out, spec, self.conv2.weight,
                        *self.conv2_norm.folded_affine(), relu=True)
        return conv_flat(out, spec, self.conv3.weight,
                         *self.conv3_norm.folded_affine(), relu=True,
                         residual=x)


class D2ResNet(nn.Module):
    """(B, 3, H, W) -> {"res2": .., "res5": ..} at strides 4 to 32."""

    def __init__(self, depth: int = 101, stem_out: int = 64,
                 res2_out: int = 256, layout: str = "nchw",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layout not in LAYOUTS:
            raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
        self.layout = layout
        self.stem_conv1 = Conv2d(3, stem_out, 7, stride=2, padding=3, bias=False,
                                 dtype=dtype)
        self.stem_conv1_norm = FrozenBN(stem_out)
        in_ch, out_ch, bottleneck = stem_out, res2_out, res2_out // 4
        for stage, n_blocks in enumerate(RESNET_STAGE_BLOCKS[depth], start=2):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 2) else 1
                blocks.append(BottleneckBlock(in_ch, bottleneck, out_ch, stride,
                                              dtype))
                in_ch = out_ch
            setattr(self, f"res{stage}", nn.ModuleList(blocks))
            out_ch *= 2
            bottleneck *= 2

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(self.stem_conv1_norm(self.stem_conv1(x)))
        x = max_pool_nchw(x, 3, 2, 1)
        feats = {}
        for stage in (2, 3, 4, 5):
            blocks = getattr(self, f"res{stage}")
            if self.layout == "flat":
                x = blocks[0](x)
                x = run_flat_blocks(x, blocks[1:])
            else:
                for block in blocks:
                    x = block(x)
            feats[f"res{stage}"] = x
        return feats


def run_flat_blocks(x: torch.Tensor,
                    blocks: Sequence[BottleneckBlock]) -> torch.Tensor:
    """Stride-1 blocks of one stage as a flat chain, (B, C, H, W) in and
    out: `flat_begin`, 3 K4 launches a block, `flat_end`."""
    if not blocks:
        return x
    spec = make_flat_spec(x.shape[2], x.shape[3], 1,
                          max_k2c=9 * blocks[0].conv2.weight.shape[0],
                          itemsize=x.element_size())
    f = to_flat(x, spec)
    for block in blocks:
        f = block.forward_flat(f, spec)
    return from_flat(f, spec)


class D2FPN(nn.Module):
    """FPN over res2..res5 with LastLevelMaxPool (p2..p6), sum fusion."""

    def __init__(self, out_channels: int = 256,
                 in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, cin in enumerate(in_channels, start=2):
            setattr(self, f"fpn_lateral{i}", Conv2d(cin, out_channels, 1,
                                                    dtype=dtype))
            setattr(self, f"fpn_output{i}", Conv2d(out_channels, out_channels, 3,
                                                   padding=1, dtype=dtype))

    def forward(self, feats: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        laterals = {i: getattr(self, f"fpn_lateral{i}")(feats[f"res{i}"])
                    for i in (2, 3, 4, 5)}
        prev = laterals[5]
        results = {"p5": self.fpn_output5(prev)}
        for level in (4, 3, 2):
            lat = laterals[level]
            up = prev.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            prev = lat + up[:, :, :lat.shape[2], :lat.shape[3]]
            results[f"p{level}"] = getattr(self, f"fpn_output{level}")(prev)
        results["p6"] = max_pool_nchw(results["p5"], 1, 2, 0)
        return results

"""CLIP ModifiedResNet (RN50), the CRIS image tower.

Counterpart of `tunevlseg_tpu/models/cris/resnet.py`: Bottleneck with the
anti-aliased stride (an average pool after conv2), the 3-conv stem, and the
CRIS variant of AttentionPool2d, which keeps the spatial map, adds a conv+BN
residual and bicubic-resizes its positional embedding. Returns the
(C3, C4, C5') pyramid. Submodule names follow the JAX param tree
(`layer{stage}` is a ModuleList, so `layer1.0` is the JAX `layer1_0`).

BatchNorm takes `use_running_average` explicitly, as the JAX modules do, and
never reads `nn.Module.training`: a frozen CRIS normalises with its running
statistics in a train step too. With batch statistics (the FPN and the
projector of the e2e fine-tune) a layer never writes its buffers: it hands
the updated running statistics to the caller's `updates` dict (the JAX
`mutable=["batch_stats"]`), and `training/task.py` carries them in the train
state. Under data parallel over several ranks the batch statistics are
those of the global batch (`parallel/data_parallel.synced_batch_norm`).

Layouts: "nchw" (the default) runs every convolution through cuDNN.
"flat" runs the stages named in `flat_stages` through the flat guard-banded
convolution K4 (`tunevlseg_torch/ops/conv_flat.py`) with the frozen BatchNorm
folded into the kernel's epilogue; conv1, the pools, stages not listed and the
attention pool stay on the cuDNN path. Parameter and buffer names are the
same, so one `state_dict` serves both. The JAX package's "nhwc" layout is a
TPU layout experiment and raises here.

Memory format: tensors keep their NCHW shape everywhere, but the backbone
follows its weights: where `build_cris` has stored the 4-D convolution
weights channels-last, the image batch is converted on entry and every
activation stays channels-last, so that cuDNN's bf16 kernels, which compute
in NHWC, need no layout transposes around each convolution. The head's weights stay contiguous (the times of the three
arrangements on an H100 are in PERF.md, from
scripts/torch_cris_stages.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.nn import remat
from tunevlseg_torch.nn.attention import dot_product_attention
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.nn.layers import Dense
from tunevlseg_torch.ops.conv_flat import (FlatSpec, conv_flat, flat_begin,
                                           flat_end, make_flat_spec)
from tunevlseg_torch.ops.image import resize_2d
from tunevlseg_torch.parallel import distributed
from tunevlseg_torch.parallel import tensor_parallel as tp_lib
from tunevlseg_torch.parallel.data_parallel import synced_batch_norm


class _BatchNorm(nn.Module):
    """torch BatchNorm semantics (momentum 0.1, eps 1e-5) over the channel
    axis 1, with the running statistics as buffers: statistics and the affine
    in f32, output in the input's dtype."""

    def __init__(self, features: int, use_running_average: bool = True,
                 momentum: float = 0.1, epsilon: float = 1e-5):
        super().__init__()
        self.use_running_average = use_running_average
        self.momentum = momentum
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

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None,
                updates: Optional[dict] = None) -> torch.Tensor:
        """`use_running_average` overrides the module's at call time. With
        batch statistics (mean and biased variance over every axis but the
        channels, in f32) and an `updates` dict, `updates[self]` becomes the
        new (running_mean, running_var): momentum 0.1 towards the batch mean
        and the unbiased variance var * n / max(n - 1, 1). The module's own
        buffers are left as they are."""
        ura = (self.use_running_average if use_running_average is None
               else use_running_average)
        if ura:
            # one pass: f32 arithmetic inside, one rounding to x's dtype
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.epsilon)
        n = x.numel() // x.shape[1]
        if distributed.data_size() > 1:
            # data parallel: the statistics of the global batch, as the JAX
            # package's BatchNorm computes them on a batch sharded over its
            # mesh (SyncBatchNorm's semantics)
            out, mean, var = synced_batch_norm(
                x, self.weight, self.bias, self.running_mean, self.running_var,
                self.momentum, self.epsilon)
        elif n > 1:
            # one fused pass that also moves the copies of the statistics
            mean, var = (self.running_mean.detach().clone(),
                         self.running_var.detach().clone())
            out = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                               self.momentum, self.epsilon)
        else:
            # one value per channel (F.batch_norm refuses it): the batch
            # variance is 0 and the unbiased one var * 1 / max(0, 1) = 0
            shape = (1, -1) + (1,) * (x.dim() - 2)
            x32 = x.float()
            batch_mean = x32.mean([0, *range(2, x.dim())])
            out = (x32 - batch_mean.reshape(shape)) * self.epsilon ** -0.5
            out = (out * self.weight.reshape(shape)
                   + self.bias.reshape(shape)).to(x.dtype)
            mean = ((1 - self.momentum) * self.running_mean.detach()
                    + self.momentum * batch_mean.detach())
            var = (1 - self.momentum) * self.running_var.detach()
        if updates is not None:
            updates[self] = (mean, var)
        return out

    def folded_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The frozen BatchNorm as a per-channel f32 (scale, offset) pair for
        the flat convolution's epilogue. Only valid with running statistics."""
        assert self.use_running_average, "BN folding requires frozen stats"
        s = self.weight * torch.rsqrt(self.running_var + self.epsilon)
        return s, self.bias - self.running_mean * s


def name_stats_updates(model: nn.Module, updates: dict, stats_updates: dict) -> None:
    """The new running statistics of `updates` ({BatchNorm module: (mean,
    var)}, as `_BatchNorm.forward` fills it) into `stats_updates` under their
    buffers' `state_dict` names in `model`."""
    for name, module in model.named_modules():
        if module in updates:
            mean, var = updates[module]
            stats_updates[f"{name}.running_mean"] = mean
            stats_updates[f"{name}.running_var"] = var


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

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None,
                updates: Optional[dict] = None) -> torch.Tensor:
        """`use_running_average` and `updates` go to every BatchNorm of the
        block (`_BatchNorm.forward`): DenseCLIP's train step normalises its
        backbone with batch statistics; CRIS never passes them."""
        def bn(norm, y):
            return norm(y, use_running_average, updates)

        out = F.relu(bn(self.bn1, self.conv1(x)))
        out = F.relu(bn(self.bn2, self.conv2(out)))
        if self.stride > 1:
            out = avg_pool_nchw(out, self.stride)
        out = bn(self.bn3, self.conv3(out))
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = avg_pool_nchw(x, self.stride)
            identity = bn(self.downsample_bn, self.downsample_conv(identity))
        return F.relu(out + identity)

    def forward_flat(self, x: torch.Tensor, spec_in: FlatSpec,
                     spec_out: FlatSpec) -> torch.Tensor:
        """The block on flat tensors (`ops/conv_flat.py`): 1x1 / 3x3 / 1x1
        with the frozen BatchNorms folded into the epilogues, the residual
        add and both ReLUs fused into the convolutions; a stride-2 block
        leaves flat space for the average pool and enters `spec_out`."""
        si, so = spec_in, spec_out
        out = conv_flat(x, si, self.conv1.weight, *self.bn1.folded_affine(),
                        relu=True)
        out = conv_flat(out, si, self.conv2.weight, *self.bn2.folded_affine(),
                        relu=True)
        if self.stride > 1:
            out = _pool_flat(out, si, so, self.stride)
        identity = x
        if self.has_downsample:
            if self.stride > 1:
                identity = _pool_flat(x, si, so, self.stride)
            identity = conv_flat(identity, so, self.downsample_conv.weight,
                                 *self.downsample_bn.folded_affine())
        return conv_flat(out, so, self.conv3.weight, *self.bn3.folded_affine(),
                         relu=True, residual=identity)


def to_flat(x: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """(B, C, H, W) -> flat (B, ROWS, C). Of a channels-last tensor the NHWC
    permutation is a view, so the one copy is `flat_begin`'s."""
    return flat_begin(x.permute(0, 2, 3, 1), spec)


def from_flat(flat: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
    """flat (B, ROWS, C) -> (B, C, H, W), a view of the flat tensor with
    stride 1 on the channels."""
    return flat_end(flat, spec).permute(0, 3, 1, 2)


def _pool_flat(flat: torch.Tensor, spec_in: FlatSpec, spec_out: FlatSpec,
               window: int) -> torch.Tensor:
    return to_flat(avg_pool_nchw(from_flat(flat, spec_in), window), spec_out)


def run_flat_stem_tail(x: torch.Tensor, net: "ModifiedResNet") -> torch.Tensor:
    """conv2 / bn2 and conv3 / bn3 of the stem as one flat chain,
    (B, C, H, W) in and out."""
    width = net.conv3.weight.shape[0]
    spec = make_flat_spec(x.shape[2], x.shape[3], 1, max_k2c=9 * (width // 2),
                          itemsize=x.element_size())
    f = to_flat(x, spec)
    for i in (2, 3):
        f = conv_flat(f, spec, getattr(net, f"conv{i}").weight,
                      *getattr(net, f"bn{i}").folded_affine(), relu=True)
    return from_flat(f, spec)


def run_flat_stage(x: torch.Tensor, blocks: Sequence[Bottleneck]) -> torch.Tensor:
    """One ResNet stage as a flat chain, (B, C, H, W) in and out: flat_begin,
    the Bottlenecks with fused epilogues (a strided block 0 changes specs
    inside), flat_end."""
    planes = blocks[0].conv2.weight.shape[0]
    stride = blocks[0].stride
    itemsize = x.element_size()
    spec_in = make_flat_spec(x.shape[2], x.shape[3], 1, max_k2c=9 * planes,
                             itemsize=itemsize)
    spec_out = spec_in if stride == 1 else make_flat_spec(
        x.shape[2] // stride, x.shape[3] // stride, 1, max_k2c=9 * planes,
        itemsize=itemsize)
    f = to_flat(x, spec_in)
    for b, block in enumerate(blocks):
        f = remat.layer_call(block.forward_flat, f,
                             spec_in=spec_in if b == 0 else spec_out,
                             spec_out=spec_out)
    return from_flat(f, spec_out)


class AttentionPool2d(nn.Module):
    """CRIS variant: spatial self-attention over the C5 map with a
    bicubic-resized positional embedding and a conv+BN residual; returns a
    (B, output_dim, H, W) map (no CLS pooling). At 416^2 the map has 169
    tokens, below the kernel gate's 256: plain attention."""

    # tensor parallel: q / k / v are column-parallel (the rank's heads);
    # c_proj matches no rule, so the local heads are gathered before it
    tp_column = ("q_proj", "k_proj", "v_proj")
    tp_row = ()
    tp = None

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

        g = self.tp
        if g is not None:
            seq = tp_lib.copy(seq, g)
        attn = dot_product_attention(split(self.q_proj(seq)),
                                     split(self.k_proj(seq)),
                                     split(self.v_proj(seq)))
        if g is not None:
            # c_proj is no rule's: the whole heads, then the replicated product
            attn = tp_lib.gather_whole(attn, g, dim=2)
        out = self.c_proj(attn.flatten(-2))
        out = out.transpose(1, 2).reshape(b, self.output_dim, h, w)
        return F.relu(out + res)


class ModifiedResNet(nn.Module):
    """(B, 3, H, W) -> (C3, C4, C5') with strides 8 / 16 / 32, all NCHW.
    `layout="flat"` runs the stages named in `flat_stages` ("stem" and "1"
    to "4") through the flat convolution K4; it needs the frozen BatchNorm."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 1024, heads: int = 32,
                 input_resolution: int = 224, width: int = 64,
                 use_running_average: bool = True, layout: str = "nchw",
                 flat_stages: Sequence[str] = ("stem", "1", "2", "3", "4"),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if layout not in ("nchw", "flat"):
            raise ValueError(f'layout {layout!r}: the port runs "nchw" and '
                             '"flat" (the JAX package\'s "nhwc" is a TPU layout '
                             "experiment)")
        if layout == "flat" and not use_running_average:
            raise ValueError("the flat layout requires the frozen BatchNorm")
        self.layout, self.flat_stages = layout, tuple(flat_stages)
        self.dtype = dtype
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

    def _flat(self, stage: str) -> bool:
        return self.layout == "flat" and stage in self.flat_stages

    def forward(self, x: torch.Tensor):
        if self.conv1.weight.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        if self._flat("stem"):
            x = run_flat_stem_tail(x, self)
        else:
            for i in (2, 3):
                x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = avg_pool_nchw(x, 2)
        feats = []
        for stage in (1, 2, 3, 4):
            blocks = getattr(self, f"layer{stage}")
            if self._flat(str(stage)):
                x = run_flat_stage(x, blocks)
            else:
                for block in blocks:
                    # remat only with frozen BatchNorm: a rematted block
                    # must not compute batch statistics twice
                    x = (remat.layer_call(block, x)
                         if block.bn1.use_running_average else block(x))
            feats.append(x)
        return feats[1], feats[2], self.attnpool(feats[3])

"""SOLOv2 (FreeSOLO's class-agnostic variant): heads and fixed-shape
inference.

Counterpart of `tunevlseg_tpu/models/solov2/model.py` (the reference's
src/models/core_models/solov2/):
  * InsHead: coordinates concatenated, each level bilinearly resized to its
    grid, 4-conv GroupNorm towers for category and kernel, 3x3 cate / kernel /
    emb prediction convolutions;
  * MaskHead: per-level conv + 2x upsample chains (coordinates appended on
    the stride-32 level), summed, 1x1 conv + GroupNorm + ReLU to num_masks;
  * inference: point NMS on the sigmoid category maps, score threshold,
    dynamic 1x1 convolution of the mask features by the predicted kernels,
    stride-based area filter, maskness rescoring, Gaussian matrix NMS, top-k.

The inference is the JAX package's FIXED-shape pipeline: every selection is
a sort with validity flags instead of a data-dependent filter, so a request
runs on the device without a host round trip, and the proposals are padded
to `max_per_img` with a validity mask. Selections keep JAX's tie order
(`lax.top_k` puts the lower index first among equal values, `jnp.argsort` is
stable): stable sorts and a slice, never `torch.topk`. The category scores,
the mask features and the dynamic-convolution product are cast to f32 where
the JAX code casts them; masks, thresholds and boxes are f32.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tunevlseg_torch.models.solov2.backbone import D2FPN, D2ResNet, max_pool_nchw
from tunevlseg_torch.nn.conv import Conv2d
from tunevlseg_torch.nn.layers import GroupNorm
from tunevlseg_torch.ops.image import resize_2d


@dataclasses.dataclass(frozen=True)
class SOLOv2Config:
    depth: int = 101
    fpn_channels: int = 256
    num_classes: int = 2
    num_kernels: int = 256
    num_masks: int = 256
    num_embs: int = 128
    num_grids: Sequence[int] = (40, 36, 24, 16, 12)
    instance_strides: Sequence[int] = (8, 8, 16, 32, 32)
    instance_channels: int = 512
    mask_channels: int = 128
    num_instance_convs: int = 4
    # inference
    score_threshold: float = 0.1
    mask_threshold: float = 0.5
    update_threshold: float = 0.05
    nms_pre: int = 500
    max_per_img: int = 100
    nms_sigma: float = 2.0
    pixel_mean: Sequence[float] = (123.675, 116.28, 103.53)
    pixel_std: Sequence[float] = (58.395, 57.12, 57.375)

    @staticmethod
    def tiny(**kw) -> "SOLOv2Config":
        base = dict(depth=50, fpn_channels=16, num_kernels=8, num_masks=8,
                    num_embs=8, num_grids=(8, 6, 4, 3, 2),
                    instance_channels=16, mask_channels=8,
                    num_instance_convs=2, nms_pre=50, max_per_img=10)
        base.update(kw)
        return SOLOv2Config(**base)


def _coord_grid(b: int, h: int, w: int, dtype: torch.dtype,
                device=None) -> torch.Tensor:
    xs = torch.linspace(-1, 1, w, device=device).to(dtype)
    ys = torch.linspace(-1, 1, h, device=device).to(dtype)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy])[None].expand(b, 2, h, w)


def _with_coords(x: torch.Tensor) -> torch.Tensor:
    b, _, h, w = x.shape
    return torch.cat([x, _coord_grid(b, h, w, x.dtype, x.device)], dim=1)


class ConvGNRelu(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 use_gn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, padding=kernel // 2,
                           bias=not use_gn, dtype=dtype)
        self.gn = GroupNorm(32, out_ch, 1e-5, dtype) if use_gn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.gn is not None:
            x = self.gn(x)
        return F.relu(x)


class SOLOv2InsHead(nn.Module):
    def __init__(self, config: SOLOv2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        for head, extra_in in (("cate", 0), ("kernel", 2)):
            for i in range(c.num_instance_convs):
                cin = c.fpn_channels + extra_in if i == 0 else c.instance_channels
                setattr(self, f"{head}_tower_{i}",
                        ConvGNRelu(cin, c.instance_channels, dtype=dtype))
        self.cate_pred = Conv2d(c.instance_channels, c.num_classes, 3, padding=1,
                                dtype=dtype)
        self.kernel_pred = Conv2d(c.instance_channels, c.num_kernels, 3,
                                  padding=1, dtype=dtype)
        self.emb_pred = Conv2d(c.instance_channels, c.num_embs, 3, padding=1,
                               dtype=dtype)

    def _tower(self, head: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.config.num_instance_convs):
            x = getattr(self, f"{head}_tower_{i}")(x)
        return x

    def forward(self, features: Sequence[torch.Tensor]):
        cate_preds, kernel_preds, emb_preds = [], [], []
        for feat, grid in zip(features, self.config.num_grids):
            kernel_feat = resize_2d(_with_coords(feat), (grid, grid), "bilinear")
            kernel_preds.append(self.kernel_pred(self._tower("kernel",
                                                             kernel_feat)))
            cf = self._tower("cate", kernel_feat[:, :-2])
            cate_preds.append(self.cate_pred(cf))
            emb_preds.append(self.emb_pred(cf))
        return cate_preds, kernel_preds, emb_preds


class SOLOv2MaskHead(nn.Module):
    def __init__(self, config: SOLOv2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.level0_conv0 = ConvGNRelu(c.fpn_channels, c.mask_channels,
                                       dtype=dtype)
        for i in (1, 2, 3):
            for j in range(i):
                cin = (c.fpn_channels + (2 if i == 3 else 0)) if j == 0 \
                    else c.mask_channels
                setattr(self, f"level{i}_conv{j}",
                        ConvGNRelu(cin, c.mask_channels, dtype=dtype))
        self.conv_pred_conv = Conv2d(c.mask_channels, c.num_masks, 1, bias=False,
                                     dtype=dtype)
        self.conv_pred_gn = GroupNorm(32, c.num_masks, 1e-5, dtype)

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:  # p2..p5
        total = self.level0_conv0(features[0])
        for i in (1, 2, 3):
            x = _with_coords(features[i]) if i == 3 else features[i]
            for j in range(i):
                x = getattr(self, f"level{i}_conv{j}")(x)
                x = resize_2d(x, (x.shape[2] * 2, x.shape[3] * 2), "bilinear")
            total = total + x
        return F.relu(self.conv_pred_gn(self.conv_pred_conv(total)))


class SOLOv2(nn.Module):
    """Backbone + heads; `forward` returns the raw predictions (cate, kernel
    and emb lists over the five levels, mask features), `solov2_inference`
    turns them into fixed-shape proposals. `layout="flat"` runs the
    backbone's stride-1 blocks through K4 (`backbone.D2ResNet`)."""

    def __init__(self, config: SOLOv2Config, layout: str = "nchw",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.backbone = D2ResNet(c.depth, layout=layout, dtype=dtype)
        self.fpn = D2FPN(c.fpn_channels, (256, 512, 1024, 2048), dtype=dtype)
        self.ins_head = SOLOv2InsHead(c, dtype)
        self.mask_head = SOLOv2MaskHead(c, dtype)

    def forward(self, images: torch.Tensor):
        """images: (B, 3, H, W), padded to /32."""
        feats = self.fpn(self.backbone(images))
        p2, p6 = feats["p2"], feats["p6"]
        # split_feats (solov2.py:675-683): p2 halved, p6 resized to p5
        ins_feats = [resize_2d(p2, (p2.shape[2] // 2, p2.shape[3] // 2),
                               "bilinear"),
                     feats["p3"], feats["p4"], feats["p5"],
                     resize_2d(p6, tuple(feats["p5"].shape[2:]), "bilinear")]
        cate, kernel, emb = self.ins_head(ins_feats)
        mask_feats = self.mask_head([feats[f] for f in ("p2", "p3", "p4", "p5")])
        return cate, kernel, emb, mask_feats


def top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` on a 1-D tensor: the k largest values and their
    indices, the lower index first among equal values."""
    values, idx = torch.sort(x, descending=True, stable=True)
    return values[:k], idx[:k]


def point_nms(heat: torch.Tensor) -> torch.Tensor:
    """Keep the local maxima of the category heatmap (utils.py:219-223): a
    2x2 max pool with the reference's asymmetric padding."""
    hmax = max_pool_nchw(heat, 2, 1, 1)[:, :, :-1, :-1]
    return heat * (hmax == heat).to(heat.dtype)


def matrix_nms(seg_masks: torch.Tensor, sum_masks: torch.Tensor,
               labels: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               sigma: float = 2.0) -> torch.Tensor:
    """Gaussian matrix NMS (utils.py:226-270) on fixed (N, ...) inputs sorted
    by descending score; invalid rows contribute nothing. The min runs over
    the FULL matrix, so rows below the diagonal contribute exp(sigma *
    comp^2) >= 1, as in the reference."""
    n = seg_masks.shape[0]
    flat = seg_masks.reshape(n, -1).float() * valid[:, None].float()
    inter = flat @ flat.T
    sums = sum_masks.clamp(min=0.0)
    union = sums[None, :] + sums[:, None] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1e-6),
                      torch.zeros_like(inter))
    triu = torch.triu(torch.ones(n, n, device=iou.device), diagonal=1)
    label_eq = (labels[None, :] == labels[:, None]).float()
    iou = iou * triu * label_eq
    compensate = iou.max(dim=0).values              # per column (proposal j)
    decay = torch.exp(-sigma * iou ** 2) / torch.exp(-sigma * compensate[:, None] ** 2)
    return scores * decay.min(dim=0).values


def solov2_inference(cate_preds, kernel_preds, emb_preds, mask_feats,
                     cfg: SOLOv2Config, cur_hw: tuple[int, int],
                     ori_hw: tuple[int, int]):
    """Fixed-shape single-image inference (solov2.py:833-975).

    Returns (masks (M, H, W) bool, boxes (M, 4), scores (M,), embs (M, E),
    valid (M,) bool) with M = cfg.max_per_img, on the predictions' device."""
    c = cfg.num_classes
    device = mask_feats.device
    scores_lv, kernels_lv, embs_lv, strides_lv = [], [], [], []
    for lvl, (cate, kern, emb) in enumerate(zip(cate_preds, kernel_preds,
                                                emb_preds)):
        heat = point_nms(torch.sigmoid(cate.float()))
        g = heat.shape[-1]
        scores_lv.append(heat[0].permute(1, 2, 0).reshape(-1, c))
        kernels_lv.append(kern[0].permute(1, 2, 0).reshape(g * g, -1))
        embs_lv.append(emb[0].permute(1, 2, 0).reshape(g * g, -1))
        strides_lv.append(torch.full((g * g,), float(cfg.instance_strides[lvl]),
                                     device=device))
    kernels_all = torch.cat(kernels_lv)              # (S, K)
    embs_all = torch.cat(embs_lv)                    # (S, E)
    strides_all = torch.cat(strides_lv)              # (S,)
    flat_scores = torch.cat(scores_lv).reshape(-1)   # (S * C,)

    k = min(cfg.nms_pre, flat_scores.shape[0])
    top_scores, top_idx = top_k_stable(
        torch.where(flat_scores > cfg.score_threshold, flat_scores,
                    torch.full_like(flat_scores, -1.0)), k)
    valid = top_scores > cfg.score_threshold
    cell = top_idx // c
    labels = top_idx % c

    # dynamic 1x1 convolution: (k, K) x (K, Hf, Wf)
    seg_logits = torch.einsum("nk,khw->nhw", kernels_all[cell].float(),
                              mask_feats[0].float())
    seg_sigmoid = torch.sigmoid(seg_logits)
    seg_bin = seg_sigmoid > cfg.mask_threshold
    sum_masks = seg_bin.sum(dim=(1, 2)).float()

    valid = valid & (sum_masks > strides_all[cell])
    maskness = (seg_sigmoid * seg_bin).sum(dim=(1, 2)) / sum_masks.clamp(min=1.0)
    scores = top_scores * maskness * valid

    # resort by the rescored values (the reference sorts before the NMS)
    order = torch.argsort(-scores, stable=True)
    seg_sigmoid, seg_bin = seg_sigmoid[order], seg_bin[order]
    sum_masks, scores = sum_masks[order], scores[order]
    labels, valid = labels[order], valid[order]
    embs = embs_all[cell][order]

    decayed = matrix_nms(seg_bin, sum_masks, labels, scores, valid, cfg.nms_sigma)
    keep = (decayed >= cfg.update_threshold) & valid
    final_scores, final_idx = top_k_stable(
        torch.where(keep, decayed, torch.full_like(decayed, -1.0)),
        min(cfg.max_per_img, decayed.shape[0]))
    final_valid = final_scores >= cfg.update_threshold
    sel_sigmoid = seg_sigmoid[final_idx]
    sel_embs = embs[final_idx]

    # upsample to the original size (solov2.py:738-790)
    h, w = cur_hw
    f_h, f_w = sel_sigmoid.shape[-2:]
    ratio = max(-(-h // f_h), -(-w // f_w))
    up = resize_2d(sel_sigmoid, (f_h * ratio, f_w * ratio), "bilinear")
    up = resize_2d(up[:, :h, :w], tuple(ori_hw), "bilinear")
    masks = up > cfg.mask_threshold
    final_valid = final_valid & (masks.sum(dim=(1, 2)) > 0)
    masks = masks & final_valid[:, None, None]

    # boxes from the projections and the centre of mass (solov2.py:808-830)
    width_proj = masks.any(dim=1).float()            # (M, W)
    height_proj = masks.any(dim=2).float()           # (M, H)
    widths = width_proj.sum(dim=1)
    heights = height_proj.sum(dim=1)
    xs = torch.arange(width_proj.shape[1], dtype=torch.float32, device=device)
    ys = torch.arange(height_proj.shape[1], dtype=torch.float32, device=device)
    center_ws = (width_proj * xs[None]).sum(dim=1) / widths.clamp(min=1e-6)
    center_hs = (height_proj * ys[None]).sum(dim=1) / heights.clamp(min=1e-6)
    boxes = torch.stack([center_ws - 0.5 * widths, center_hs - 0.5 * heights,
                         center_ws + 0.5 * widths, center_hs + 0.5 * heights],
                        dim=1)

    norm = torch.linalg.vector_norm(sel_embs, dim=-1, keepdim=True)
    sel_embs = sel_embs / norm.clamp(min=1e-12)
    return masks, boxes, final_scores, sel_embs, final_valid


def preprocess_image(image: torch.Tensor, cfg: SOLOv2Config,
                     size_divisibility: int = 32,
                     normalize: bool = False) -> torch.Tensor:
    """(3, H, W) RGB -> (1, 3, H', W') zero-padded to /32.

    Normalization is OFF by default: the reference's normalizer is commented
    out (solov2.py:146-158), so FreeSOLO consumes the pixels as given (a
    reference quirk, kept). `normalize=True` applies the documented pixel
    mean / std."""
    x = image
    if normalize:
        mean = torch.tensor(cfg.pixel_mean, dtype=x.dtype, device=x.device)
        std = torch.tensor(cfg.pixel_std, dtype=x.dtype, device=x.device)
        x = (x - mean.reshape(3, 1, 1)) / std.reshape(3, 1, 1)
    h, w = x.shape[1:]
    x = F.pad(x, (0, -w % size_divisibility, 0, -h % size_divisibility))
    return x[None]

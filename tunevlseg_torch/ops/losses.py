"""Segmentation loss with MONAI DiceCE semantics.

Counterpart of `tunevlseg_tpu/ops/losses.py:dice_ce_loss`: MONAI
`DiceCELoss(sigmoid=True)` for the binary single-channel case, Dice per
(sample, channel) with smooth_nr = smooth_dr = 1e-5 and mean reduction, plus
BCE-with-logits (mean), every reduction in f32. Only the options the
configurations set (`lambda_dice`, `lambda_ce`, `weight`) are ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SMOOTH = 1e-5


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                                     pos_weight=None) -> torch.Tensor:
    x = logits.float()
    z = targets.float()
    w = 1.0 if pos_weight is None else pos_weight
    # log(sigmoid(x)) = -softplus(-x); log(1 - sigmoid(x)) = -softplus(x)
    loss = w * z * F.softplus(-x) + (1.0 - z) * F.softplus(x)
    return loss.mean()


def dice_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid Dice loss per (sample, channel), averaged."""
    p = torch.sigmoid(logits.float())
    g = targets.float()
    dims = tuple(range(2, p.dim()))
    intersection = (g * p).sum(dim=dims)
    denominator = g.sum(dim=dims) + p.sum(dim=dims)
    f = 1.0 - (2.0 * intersection + SMOOTH) / (denominator + SMOOTH)
    return f.mean()


def dice_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                 lambda_dice: float = 1.0, lambda_ce: float = 0.2,
                 weight=None) -> torch.Tensor:
    """`monai.losses.DiceCELoss(sigmoid=True)` for the binary single-channel
    case (`weight` -> BCE pos_weight)."""
    ce = binary_cross_entropy_with_logits(logits, targets, pos_weight=weight)
    return lambda_dice * dice_loss(logits, targets) + lambda_ce * ce

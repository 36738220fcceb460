"""Segmentation losses with MONAI semantics, every reduction in f32.

Counterpart of `tunevlseg_tpu/ops/losses.py`, function for function, with the
same argument order and defaults, so that a configuration's `loss_fn` block
(`name` picks the function from `LOSS_REGISTRY`, every other key is a keyword
argument) builds the same loss on either package:

  DiceLoss (include_background=True, reduction="mean"), per (sample,
  channel), or per channel over the batch with `batch=True`:
      f = 1 - (2*sum(p*g) + smooth_nr) / (sum(p) + sum(g) + smooth_dr)
  with p = sigmoid(logits) when `sigmoid`, squared sums with `squared_pred`,
  and the Jaccard denominator 2*(sum(p) + sum(g) - sum(p*g)) with `jaccard`;
  the CE part for the single-channel binary case is BCE-with-logits (mean,
  `weight` -> pos_weight); total = lambda_dice * dice + lambda_ce * bce.
  `focal_loss` is the sigmoid focal loss (mean) of SOLOv2's objective.

Under data parallel over several ranks (`parallel/`), `batch=True` sums
over the global batch, as the JAX dice does under `jit` on its mesh: the
three sums are added over the data group before the ratio, by an
all-reduce whose backward sums the gradients over the group too
(`data_parallel.summed_over_ranks`). Every rank's loss is then the global
dice, and each rank's gradient of it is the data size times its own rows'
share, so DDP's mean (FSDP's reduce-scatter mean) of the ranks' gradients
is the gradient of the global dice. The model group is not summed over: its
ranks hold the same rows. With one data rank no collective runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tunevlseg_torch.parallel import data_parallel, distributed


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                                     pos_weight=None) -> torch.Tensor:
    """Mean BCE-with-logits (torch `BCEWithLogitsLoss(pos_weight=...)`)."""
    x = logits.float()
    z = targets.float()
    w = 1.0 if pos_weight is None else pos_weight
    # log(sigmoid(x)) = -softplus(-x); log(1 - sigmoid(x)) = -softplus(x)
    loss = w * z * F.softplus(-x) + (1.0 - z) * F.softplus(x)
    return loss.mean()


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, sigmoid: bool = True,
              squared_pred: bool = False, jaccard: bool = False,
              smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
              batch: bool = False) -> torch.Tensor:
    """`monai.losses.DiceLoss` on (B, C, *spatial), averaged; with `batch`
    over the global batch of every data rank."""
    x = logits.float()
    g = targets.float()
    p = torch.sigmoid(x) if sigmoid else x
    dims = tuple(range(2, p.dim()))
    if batch:
        dims = (0,) + dims
    intersection = (g * p).sum(dim=dims)
    if squared_pred:
        ground, pred = (g * g).sum(dim=dims), (p * p).sum(dim=dims)
    else:
        ground, pred = g.sum(dim=dims), p.sum(dim=dims)
    if batch and distributed.data_size() > 1:
        intersection, ground, pred = data_parallel.summed_over_ranks(
            torch.stack([intersection, ground, pred])).unbind(0)
    denominator = ground + pred
    if jaccard:
        denominator = 2.0 * (denominator - intersection)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (denominator + smooth_dr)
    return f.mean()


def dice_ce_loss(logits: torch.Tensor, targets: torch.Tensor, sigmoid: bool = True,
                 lambda_dice: float = 1.0, lambda_ce: float = 0.2,
                 smooth_nr: float = 1e-5, smooth_dr: float = 1e-5,
                 squared_pred: bool = False, jaccard: bool = False,
                 batch: bool = False, weight=None) -> torch.Tensor:
    """`monai.losses.DiceCELoss` for the binary single-channel case
    (`weight` -> BCE pos_weight)."""
    d = dice_loss(logits, targets, sigmoid=sigmoid, squared_pred=squared_pred,
                  jaccard=jaccard, smooth_nr=smooth_nr, smooth_dr=smooth_dr,
                  batch=batch)
    ce = binary_cross_entropy_with_logits(logits, targets, pos_weight=weight)
    return lambda_dice * d + lambda_ce * ce


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
               alpha: float = 0.25) -> torch.Tensor:
    """Sigmoid focal loss (mean); no alpha weighting when alpha < 0."""
    x = logits.float()
    z = targets.float()
    p = torch.sigmoid(x)
    ce = x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))
    p_t = p * z + (1 - p) * (1 - z)
    weight = (1 - p_t) ** gamma
    if alpha >= 0:
        weight = weight * (alpha * z + (1 - alpha) * (1 - z))
    return (weight * ce).mean()


LOSS_REGISTRY = {
    "dice_ce": dice_ce_loss,
    "dice": dice_loss,
    "bce": binary_cross_entropy_with_logits,
    "focal": focal_loss,
}

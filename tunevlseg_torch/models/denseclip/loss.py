"""DenseCLIP training losses.

Counterpart of `tunevlseg_tpu/models/denseclip/loss.py`: mmseg's
CrossEntropyLoss (use_sigmoid=False, weight 1.0) over the decode head's
logits at the label resolution, plus the identity head's auxiliary CE over
`score_map / tau` bilinearly resized to the labels, at weight 0.4.

mmseg's semantics, as the JAX package keeps them:
  * label 255 (ignore_index) contributes zero loss;
  * with the default `avg_non_ignore=False` the mean divides by ALL pixels,
    ignored ones included (not torch's `reduction="mean"` with
    ignore_index, which divides by the non-ignored count).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from tunevlseg_torch.ops.image import resize_2d

IGNORE_INDEX = 255


def cross_entropy_seg(logits: torch.Tensor, labels: torch.Tensor,
                      ignore_index: int = IGNORE_INDEX,
                      avg_non_ignore: bool = False) -> torch.Tensor:
    """mmseg CrossEntropyLoss over (B, K, H, W) logits (in f32) and (B, H, W)
    integer labels: the sum of -log softmax at the label over the pixels not
    at `ignore_index`, over the count of all pixels (of the valid ones with
    `avg_non_ignore`, at least 1)."""
    labels = labels.long()
    total = F.cross_entropy(logits.float(), labels, ignore_index=ignore_index,
                            reduction="sum")
    if avg_non_ignore:
        return total / (labels != ignore_index).sum().clamp(min=1)
    return total / labels.numel()


def denseclip_losses(logits: torch.Tensor, score_map: torch.Tensor,
                     labels: torch.Tensor, tau: float = 0.07,
                     identity_weight: float = 0.4) -> dict:
    """{"loss", "loss_decode", "loss_aux_identity"}: the decode CE over
    `logits` (already at the label resolution) plus `identity_weight` x the CE
    over the stride-32 `score_map / tau` resized to the label grid."""
    loss_decode = cross_entropy_seg(logits, labels)
    id_logits = resize_2d(score_map.float() / tau, tuple(labels.shape[1:]),
                          "bilinear")
    loss_identity = cross_entropy_seg(id_logits, labels)
    return {"loss": loss_decode + identity_weight * loss_identity,
            "loss_decode": loss_decode, "loss_aux_identity": loss_identity}

"""Segmentation metrics as an accumulable running state.

Counterpart of `tunevlseg_tpu/ops/metrics.py`: torchmetrics
`Dice(average="samples", threshold=0.5, zero_division=1)` (per-sample dice
averaged over every sample) and `JaccardIndex(task="binary")` (one global
confusion matrix, IoU at the end). The state is five f32 scalars on the
device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SegMetricState(NamedTuple):
    dice_sum: torch.Tensor   # sum of per-sample dice scores
    n_samples: torch.Tensor
    tp: torch.Tensor         # global confusion-matrix entries
    fp: torch.Tensor
    fn: torch.Tensor

    @staticmethod
    def zeros(device=None) -> "SegMetricState":
        return SegMetricState(*(torch.zeros((), dtype=torch.float32, device=device)
                                for _ in range(5)))

    def merge(self, other: "SegMetricState") -> "SegMetricState":
        return SegMetricState(*(a + b for a, b in zip(self, other)))


def update_state(state: SegMetricState, probs: torch.Tensor,
                 targets: torch.Tensor, threshold: float = 0.5,
                 zero_division: float = 1.0,
                 valid: Optional[torch.Tensor] = None) -> SegMetricState:
    """probs, targets (B, 1, H, W); `valid` (B,) {0, 1} masks padded samples."""
    b = probs.shape[0]
    p = (probs >= threshold).float().reshape(b, -1)
    g = (targets >= 0.5).float().reshape(b, -1)
    v = (torch.ones(b, device=probs.device) if valid is None
         else valid.float())
    tp = (p * g).sum(dim=1)
    fp = (p * (1 - g)).sum(dim=1)
    fn = ((1 - p) * g).sum(dim=1)
    denom = 2 * tp + fp + fn
    dice = torch.where(denom > 0, 2 * tp / denom.clamp(min=1),
                       torch.full_like(denom, zero_division))
    return SegMetricState(
        dice_sum=state.dice_sum + (dice * v).sum(),
        n_samples=state.n_samples + v.sum(),
        tp=state.tp + (tp * v).sum(),
        fp=state.fp + (fp * v).sum(),
        fn=state.fn + (fn * v).sum(),
    )


def compute(state: SegMetricState,
            zero_division: float = 0.0) -> dict[str, torch.Tensor]:
    dice = state.dice_sum / state.n_samples.clamp(min=1.0)
    iou_denom = state.tp + state.fp + state.fn
    iou = torch.where(iou_denom > 0, state.tp / iou_denom.clamp(min=1.0),
                      torch.full_like(iou_denom, zero_division))
    return {"dice": dice, "iou": iou}

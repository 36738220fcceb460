"""The segmentation task, inference half.

Counterpart of `tunevlseg_tpu/training/task.py:SegmentationTask` for
prediction and evaluation. The batch contract is the JAX package's:

    batch = {"image": (B, C, H, W) uint8 or f32, "mask": (B, 1, H, W) f32,
             "input_ids": (B, L) or (U, L) int, "attention_mask": same,
             "valid": (B,) f32 (optional), "text_index": (B,) int (optional)}

uint8 images are ImageNet-normalised on the device. The model holds its own
weights (`torch.func.functional_call` swaps in others; see
`tunevlseg_torch/serving.py`). The train step comes with the K2 port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from tunevlseg_torch.ops import losses as losses_lib
from tunevlseg_torch.ops import metrics as metrics_lib


@dataclasses.dataclass
class SegmentationTask:
    model: nn.Module
    loss_fn: Callable = losses_lib.dice_ce_loss
    loss_kwargs: dict = dataclasses.field(default_factory=dict)
    threshold: float = 0.5
    # (mean, std) for the device-side normalisation of uint8 image batches
    image_stats: tuple = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))

    def _prep_image(self, image: torch.Tensor) -> torch.Tensor:
        if image.dtype != torch.uint8:
            return image
        mean, std = (torch.tensor(s, dtype=torch.float32, device=image.device)
                     .reshape(1, -1, 1, 1) for s in self.image_stats)
        return (image.float() / 255.0 - mean) / std

    def model_inputs(self, batch: dict) -> tuple[tuple, dict]:
        """(args, kwargs) of the model call for a batch; `text_index` is
        passed only when present."""
        kwargs = ({"text_index": batch["text_index"]}
                  if "text_index" in batch else {})
        return (batch["input_ids"], self._prep_image(batch["image"]),
                batch.get("attention_mask")), kwargs

    def _forward(self, batch: dict) -> torch.Tensor:
        args, kwargs = self.model_inputs(batch)
        return self.model(*args, **kwargs)

    @torch.no_grad()
    def predict_step(self, batch: dict) -> torch.Tensor:
        """Sigmoid probabilities (B, 1, H, W) in f32."""
        return torch.sigmoid(self._forward(batch).float())

    @torch.no_grad()
    def eval_step(self, metric_state: metrics_lib.SegMetricState, batch: dict):
        """Returns (updated metric state, {"loss_sum", "n"}); samples with
        valid == 0 contribute a constant loss term and no metric counts."""
        logits = self._forward(batch)
        mask = batch["mask"]
        valid = batch.get("valid")
        probs = torch.sigmoid(logits.float())
        if valid is not None:
            vv = valid.reshape(-1, 1, 1, 1).to(logits.dtype)
            loss = self.loss_fn(logits * vv, mask * vv, **self.loss_kwargs)
            n = valid.float().sum()
        else:
            loss = self.loss_fn(logits, mask, **self.loss_kwargs)
            n = torch.tensor(float(mask.shape[0]), device=mask.device)
        new_state = metrics_lib.update_state(metric_state, probs, mask,
                                             self.threshold, valid=valid)
        return new_state, {"loss_sum": loss * n, "n": n}

"""FreeSOLO / BoxInst pseudo-supervision losses for SOLOv2 training.

Counterpart of `tunevlseg_tpu/models/solov2/pseudo_loss.py` (the
reference's solov2/pseudo_solov2.py:132-179, solov2.py:416-500 and
utils.py:310-427), in plain tensor ops:

  * `unfold_wo_center`: each pixel's dilated k x k neighbourhood without its
    centre, as k*k - 1 shifted slices of the zero-padded map (the JAX
    package's formulation; `F.unfold` plus the centre drop gives the same);
  * `rgb2lab`: skimage.color.rgb2lab's sRGB -> linear -> XYZ (D65, 2 deg)
    -> CIELAB;
  * `images_color_similarity`: exp(-||lab difference|| / 2) against each
    neighbour, gated by the unfolded maximum of the image validity mask;
  * `compute_pairwise_term`: -log P(a pixel and its neighbour get the same
    prediction), in log space;
  * `prepare_color_similarity`: the stride-4 pooled image, truncated to
    integers, in CIELAB, against the stride-4 validity mask;
  * `paired_losses`: the max- and mean-projection dice along each axis and
    the colour-gated pairwise term with its linear warm-up, over a
    fixed-shape instance stack with a `valid` flag (per FPN level with
    `level_ids`, else global means over the valid instances).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def unfold_wo_center(x: torch.Tensor, kernel_size: int,
                     dilation: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, k*k - 1, H, W): each pixel's dilated k x k
    neighbourhood, centre removed, zeros outside; neighbour ki * k + kj reads
    offset (ki * d, kj * d) of the padded map."""
    assert x.dim() == 4 and kernel_size % 2 == 1
    k, d = kernel_size, dilation
    pad = (k + (d - 1) * (k - 1)) // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    center = (k * k) // 2
    shifts = [xp[:, :, ki * d:ki * d + h, kj * d:kj * d + w]
              for ki in range(k) for kj in range(k) if ki * k + kj != center]
    return torch.stack(shifts, dim=2)


_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


def rgb2lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 255] -> CIELAB (skimage's), in f32."""
    s = rgb.float() / 255.0
    linear = torch.where(s > 0.04045, ((s + 0.055) / 1.055) ** 2.4, s / 12.92)
    m = torch.tensor(_RGB2XYZ, dtype=torch.float32, device=rgb.device)
    xyz = linear @ m.T
    t = xyz / torch.tensor(_WHITE, dtype=torch.float32, device=rgb.device)
    eps = 0.008856451679035631          # (6 / 29) ** 3
    kappa = 7.787068965517241           # (29 / 6) ** 2 / 3
    # the real cube root (t >= 0 here; the other branch takes t <= eps)
    cbrt = torch.sign(t) * t.abs() ** (1.0 / 3.0)
    f = torch.where(t > eps, cbrt, kappa * t + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def images_color_similarity(images_lab: torch.Tensor, image_masks: torch.Tensor,
                            kernel_size: int, dilation: int) -> torch.Tensor:
    """(N, 3, H, W) LAB and (N, H, W) validity -> (N, k*k - 1, H, W) neighbour
    similarity exp(-||diff|| / 2), zero where the neighbourhood reaches
    padding."""
    unfolded = unfold_wo_center(images_lab, kernel_size, dilation)
    diff = images_lab[:, :, None] - unfolded              # (N, 3, k*k-1, H, W)
    similarity = torch.exp(-torch.linalg.vector_norm(diff, dim=1) * 0.5)
    unfolded_w = unfold_wo_center(image_masks[:, None], kernel_size, dilation)
    return similarity * unfolded_w.amax(dim=1)


def compute_pairwise_term(mask_logits: torch.Tensor, pairwise_size: int,
                          pairwise_dilation: int) -> torch.Tensor:
    """(N, 1, H, W) logits -> (N, k*k - 1, H, W) = -log P(same prediction as
    the neighbour), in log space."""
    assert mask_logits.dim() == 4
    log_fg = F.logsigmoid(mask_logits)
    log_bg = F.logsigmoid(-mask_logits)
    log_same_fg = log_fg[:, :, None] + unfold_wo_center(
        log_fg, pairwise_size, pairwise_dilation)
    log_same_bg = log_bg[:, :, None] + unfold_wo_center(
        log_bg, pairwise_size, pairwise_dilation)
    m = torch.maximum(log_same_fg, log_same_bg)
    log_same = torch.log(torch.exp(log_same_fg - m)
                         + torch.exp(log_same_bg - m)) + m
    return -log_same[:, 0]


def prepare_color_similarity(images: torch.Tensor, image_masks: torch.Tensor,
                             *, pairwise_size: int = 3,
                             pairwise_dilation: int = 2) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 255] and (B, H, W) validity -> (B, k*k - 1,
    H / 4, W / 4): the stride-4 average pool truncated to integers (the
    reference's `.byte()`), in CIELAB, against the validity mask sampled
    from offset 2 at stride 4."""
    b, c, h, w = images.shape
    assert h % 4 == 0 and w % 4 == 0, "image dims must be divisible by 4"
    down = images.float().reshape(b, c, h // 4, 4, w // 4, 4).mean(dim=(3, 5))
    lab = rgb2lab(torch.floor(down).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    masks = image_masks[:, 2::4, 2::4].float()
    return images_color_similarity(lab, masks, pairwise_size, pairwise_dilation)


def dice_coefficient(x: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-instance dice distance with squared denominators."""
    n = x.shape[0]
    x = x.reshape(n, -1)
    target = target.reshape(n, -1)
    inter = (x * target).sum(dim=1)
    union = (x ** 2).sum(dim=1) + (target ** 2).sum(dim=1) + eps
    return 1.0 - 2.0 * inter / union


def paired_losses(ins_pred: torch.Tensor,           # (N, H, W) mask logits
                  ins_labels: torch.Tensor,         # (N, H, W) {0, 1} boxes
                  color_similarity: torch.Tensor,   # (N, k*k - 1, H, W)
                  valid: torch.Tensor,              # (N,) {0, 1}
                  *,
                  level_ids: Optional[torch.Tensor] = None,  # (N,) FPN level
                  num_levels: int = 5,
                  step: int = 0,
                  warmup_iters: int = 1000,
                  pairwise_size: int = 3,
                  pairwise_dilation: int = 2,
                  pairwise_color_thresh: float = 0.3,
                  ins_loss_weight: float = 3.0) -> dict[str, torch.Tensor]:
    """The BoxInst pseudo objective over a fixed-shape instance stack:
    {"loss_ins", "loss_ins_max", "loss_pairwise"}. Invalid rows contribute
    nothing and are left out of the means. With `level_ids` each FPN level's
    instance mean (and its own weighted pairwise ratio) comes first and the
    levels present are averaged, as the reference does; without, the means
    are global over the valid instances (the JAX package's simplification,
    PARITY.md)."""
    valid = valid.float()
    scores = torch.sigmoid(ins_pred)
    target = ins_labels.float()

    if level_ids is not None:
        levels = torch.arange(num_levels, device=ins_pred.device)
        onehot = (level_ids[:, None] == levels[None]).float() * valid[:, None]
        count = onehot.sum(dim=0)                              # (L,)
        present = (count > 0).float()
        n_present = present.sum().clamp(min=1.0)

        def agg(per_inst):      # per-level mean, then the mean over levels
            lv = (onehot * per_inst[:, None]).sum(dim=0) / count.clamp(min=1.0)
            return (lv * present).sum() / n_present
    else:
        n_valid = valid.sum().clamp(min=1.0)

        def agg(per_inst):
            return (per_inst * valid).sum() / n_valid

    def proj_pair(reduce):
        y = dice_coefficient(reduce(scores, 1), reduce(target, 1))
        x = dice_coefficient(reduce(scores, 2), reduce(target, 2))
        return agg(y + x)

    loss_ins_max = proj_pair(lambda a, ax: a.amax(dim=ax, keepdim=True))
    loss_ins = proj_pair(lambda a, ax: a.mean(dim=ax, keepdim=True))

    pairwise = compute_pairwise_term(ins_pred[:, None], pairwise_size,
                                     pairwise_dilation)
    box_target = (target.amax(dim=1, keepdim=True)
                  * target.amax(dim=2, keepdim=True))          # (N, H, W)
    weights = ((color_similarity >= pairwise_color_thresh).float()
               * box_target[:, None] * valid[:, None, None, None])
    warmup = min(float(step) / warmup_iters, 1.0)
    if level_ids is not None:
        pw_num = (pairwise * weights).sum(dim=(1, 2, 3))        # (N,)
        w_sum = weights.sum(dim=(1, 2, 3))
        lv_num = (onehot * pw_num[:, None]).sum(dim=0)
        lv_den = (onehot * w_sum[:, None]).sum(dim=0).clamp(min=1.0)
        loss_pairwise = ((lv_num / lv_den) * present).sum() / n_present * warmup
    else:
        loss_pairwise = ((pairwise * weights).sum()
                         / weights.sum().clamp(min=1.0)) * warmup

    return {"loss_ins": loss_ins * ins_loss_weight * 0.1,
            "loss_ins_max": loss_ins_max * ins_loss_weight * 1.0,
            "loss_pairwise": loss_pairwise}

"""Host-side image/mask transforms (numpy + cv2).

Equivalents of the albumentations pipeline the reference composes from config
(configs/experiment/coop/clipseg.yaml:78-126): Resize(cubic), Affine(p=0.2),
PadIfNeeded(replicate), CropNonEmptyMaskIfExists, RandomBrightnessContrast
(p=0.2), Normalize(ImageNet), to-CHW-tensor. Masks are warped with NEAREST
interpolation (albumentations' default) so binary masks stay binary.

Each transform is `t(image, mask, rng) -> (image, mask)` with HWC uint8/float
images; `Compose` threads a per-sample `np.random.Generator` through for
reproducibility (the reference relies on global seeding —
src/train.py:67-68).

The port's own copy of `tunevlseg_tpu/data/transforms.py`. cv2 is imported
where a transform runs (through `data/opencv.py`, which keeps it on one
thread), so that importing this module needs none; the defaults name cv2's
constants by their values."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from tunevlseg_torch.data.opencv import cv2 as _cv2

# cv2's values of the flags the defaults use (stable across OpenCV releases)
INTER_NEAREST, INTER_CUBIC = 0, 2
BORDER_REPLICATE = 1


class Transform:
    p: float = 1.0

    def apply(self, image, mask, rng):  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, image, mask, rng):
        if self.p >= 1.0 or rng.random() < self.p:
            return self.apply(image, mask, rng)
        return image, mask


@dataclasses.dataclass
class Compose:
    transforms: Sequence[Transform]

    def __call__(self, image: np.ndarray, mask: Optional[np.ndarray],
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            image, mask = t(image, mask, rng)
        return image, mask


@dataclasses.dataclass
class Resize(Transform):
    height: int
    width: int
    interpolation: int = INTER_CUBIC
    p: float = 1.0

    def apply(self, image, mask, rng):
        cv2 = _cv2()
        image = cv2.resize(image, (self.width, self.height),
                           interpolation=self.interpolation)
        if mask is not None:
            mask = cv2.resize(mask, (self.width, self.height),
                              interpolation=cv2.INTER_NEAREST)
        return image, mask


@dataclasses.dataclass
class Affine(Transform):
    """Random scale/translate/rotate (albumentations.Affine subset)."""

    scale: tuple[float, float] = (0.98, 1.02)
    translate_percent: tuple[float, float] = (-0.02, 0.02)
    rotate: tuple[float, float] = (-5.0, 5.0)
    interpolation: int = INTER_CUBIC
    border_mode: int = BORDER_REPLICATE
    p: float = 0.2

    def apply(self, image, mask, rng):
        cv2 = _cv2()
        h, w = image.shape[:2]
        scale = rng.uniform(*self.scale)
        angle = rng.uniform(*self.rotate)
        tx = rng.uniform(*self.translate_percent) * w
        ty = rng.uniform(*self.translate_percent) * h
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
        m[:, 2] += (tx, ty)
        image = cv2.warpAffine(image, m, (w, h), flags=self.interpolation,
                               borderMode=self.border_mode)
        if mask is not None:
            mask = cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST,
                                  borderMode=self.border_mode)
        return image, mask


@dataclasses.dataclass
class PadIfNeeded(Transform):
    min_height: int
    min_width: int
    border_mode: int = BORDER_REPLICATE
    p: float = 1.0

    def apply(self, image, mask, rng):
        h, w = image.shape[:2]
        ph, pw = max(0, self.min_height - h), max(0, self.min_width - w)
        if not ph and not pw:
            return image, mask
        cv2 = _cv2()
        top, left = ph // 2, pw // 2
        image = cv2.copyMakeBorder(image, top, ph - top, left, pw - left,
                                   self.border_mode)
        if mask is not None:
            mask = cv2.copyMakeBorder(mask, top, ph - top, left, pw - left,
                                      self.border_mode)
        return image, mask


@dataclasses.dataclass
class CropNonEmptyMaskIfExists(Transform):
    """Random crop biased to contain mask foreground (albumentations name)."""

    height: int
    width: int
    p: float = 1.0

    def apply(self, image, mask, rng):
        h, w = image.shape[:2]
        if h == self.height and w == self.width:
            return image, mask
        if mask is not None and mask.sum() > 0:
            m2 = mask if mask.ndim == 2 else mask[..., 0]
            ys, xs = np.nonzero(m2)
            cy = int(rng.choice(ys))
            cx = int(rng.choice(xs))
            y0 = np.clip(cy - rng.integers(0, self.height), 0, max(0, h - self.height))
            x0 = np.clip(cx - rng.integers(0, self.width), 0, max(0, w - self.width))
        else:
            y0 = rng.integers(0, max(1, h - self.height + 1))
            x0 = rng.integers(0, max(1, w - self.width + 1))
        y0, x0 = int(y0), int(x0)
        image = image[y0:y0 + self.height, x0:x0 + self.width]
        if mask is not None:
            mask = mask[y0:y0 + self.height, x0:x0 + self.width]
        return image, mask


@dataclasses.dataclass
class RandomBrightnessContrast(Transform):
    brightness_limit: float = 0.1
    contrast_limit: float = 0.1
    p: float = 0.2

    def apply(self, image, mask, rng):
        alpha = 1.0 + rng.uniform(-self.contrast_limit, self.contrast_limit)
        beta = rng.uniform(-self.brightness_limit, self.brightness_limit)
        img = image.astype(np.float32)
        max_val = 255.0 if image.dtype == np.uint8 else 1.0
        img = img * alpha + beta * max_val
        if image.dtype == np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return img, mask


@dataclasses.dataclass
class HorizontalFlip(Transform):
    p: float = 0.5

    def apply(self, image, mask, rng):
        image = image[:, ::-1]
        if mask is not None:
            mask = mask[:, ::-1]
        return image, mask


@dataclasses.dataclass
class Normalize(Transform):
    """albumentations.Normalize: (img/255 - mean) / std for uint8 input."""

    mean: Sequence[float] = (0.485, 0.456, 0.406)
    std: Sequence[float] = (0.229, 0.224, 0.225)
    max_pixel_value: float = 255.0
    p: float = 1.0

    def apply(self, image, mask, rng):
        img = image.astype(np.float32) / self.max_pixel_value
        img = (img - np.asarray(self.mean, np.float32)) / \
            np.asarray(self.std, np.float32)
        return img, mask


def to_chw(image: np.ndarray, mask: Optional[np.ndarray]):
    """HWC float image -> CHW; mask -> (1, H, W) (ToTensorV2 transpose_mask)."""
    image = np.ascontiguousarray(image.transpose(2, 0, 1))
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[None]
        else:
            mask = np.ascontiguousarray(mask.transpose(2, 0, 1))
    return image, mask


def train_transforms(img_size: int,
                     mean=(0.485, 0.456, 0.406),
                     std=(0.229, 0.224, 0.225),
                     normalize_on_device: bool = False) -> Compose:
    """The reference's canonical train pipeline (coop/clipseg.yaml:78-111).

    With `normalize_on_device` the image stays uint8 on the host (augments
    run on uint8, 4x smaller host->device transfer) and the train step
    applies (x/255 - mean)/std on the device: mathematically identical."""
    steps = [
        Resize(img_size, img_size),
        Affine(p=0.2),
        PadIfNeeded(img_size, img_size),
        CropNonEmptyMaskIfExists(img_size, img_size),
        RandomBrightnessContrast(p=0.2),
    ]
    if not normalize_on_device:
        steps.append(Normalize(mean, std))
    return Compose(steps)


def eval_transforms(img_size: int,
                    mean=(0.485, 0.456, 0.406),
                    std=(0.229, 0.224, 0.225),
                    normalize_on_device: bool = False) -> Compose:
    steps = [Resize(img_size, img_size)]
    if not normalize_on_device:
        steps.append(Normalize(mean, std))
    return Compose(steps)

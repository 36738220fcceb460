"""ZeroShotRIS: training-free referring segmentation (FreeSOLO proposals,
masked and cropped CLIP features, a text ensemble).

Counterpart of `tunevlseg_tpu/models/zero_shot_ris/model.py` (the
reference's src/models/core_models/zero_shot_ris/__init__.py):
  * FreeSOLO proposes up to `max_per_img` masks and boxes with a validity
    mask (fixed shapes, `models/solov2/model.py`);
  * "mask features": the CLIP ViT where, from `masking_block_idx` on, the
    patch tokens are multiplied by each proposal's mask (nearest-downsampled
    to the patch grid) before EVERY remaining layer, the proposals becoming
    the batch;
  * "crop features": the image mask-filled with its channel mean, each box
    cropped and bicubic-resized to the CLIP input, the plain pooled CLIP
    features;
  * visual = alpha * mask + (1 - alpha) * crop, text = beta * phrase +
    (1 - beta) * class name; the cosine argmax over the VALID proposals picks
    the mask;
  * an npz cache of the proposals and the visual and text features per
    `cache_name`, with the JAX package's file names and keys, so a cache
    written by one package reads in the other (the alpha / beta sweeps run
    from it without the models).

With `devices` (k of them, the models' device first) the proposal batch
runs proposal-parallel, the JAX package's `n_devices` mesh in the port's
idiom: the masked-CLIP and crop-CLIP towers take the (P, ...) proposals in
k contiguous chunks, each through a replica of the dual encoder on its own
device, and the features gather on the first; FreeSOLO, the text tower
and the selection stay there. No collective: one process drives them all.

`predict_fused` runs a request on the device from the image to the picked
mask and reads the host once, at the end; `predict_fused_many` keeps `depth`
requests in flight by deferring that copy. `__call__` is the reference's
host loop (the crops cut and resized on the host, `host_crop_canvases`).
Features are f32 once they leave a tower, whatever the towers' compute
dtype.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
from pathlib import Path
from typing import Any, Iterable, Optional

import numpy as np
import torch
from torch import nn

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.clip.text import CLIPTextTower
from tunevlseg_torch.models.clip.vision import CLIPVisionTower
from tunevlseg_torch.models.solov2.model import (SOLOv2, SOLOv2Config,
                                                 preprocess_image,
                                                 solov2_inference, top_k_stable)
from tunevlseg_torch.nn.layers import Dense
from tunevlseg_torch.ops.image import crop_resize_bicubic_masked, resize_2d


def run_masked_layers(x: torch.Tensor, layers, pred_masks: Optional[torch.Tensor],
                      masking_block_idx: Optional[int]) -> torch.Tensor:
    """The encoder layers over x (B, 1 + g*g, D). With `pred_masks` (P, g, g)
    {0, 1}, from layer `masking_block_idx` on (all layers when None: no
    masking) the patch tokens are multiplied by each proposal's mask before
    every layer and the proposals become the batch; the CLS token stays
    unmasked."""
    if pred_masks is None:
        for layer in layers:
            x = layer(x)
        return x
    n_layers = len(layers)
    split = masking_block_idx % n_layers if masking_block_idx is not None \
        else n_layers
    for layer in layers[:split]:
        x = layer(x)
    p, g = pred_masks.shape[0], pred_masks.shape[-1]
    mask_flat = pred_masks.reshape(p, g * g, 1).to(x.dtype)
    for layer in layers[split:]:
        cls = x[:, :1].expand(p, 1, x.shape[-1])
        patches = x[:, 1:].expand(p, g * g, x.shape[-1]) * mask_flat
        x = layer(torch.cat([cls, patches], dim=1))
    return x


class MaskedCLIP(nn.Module):
    """CLIP dual encoder with the per-proposal patch-masking vision path."""

    def __init__(self, config: CLIPSegConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.config = config
        self.text_model = CLIPTextTower(c.text, dtype)
        self.vision_model = CLIPVisionTower(c.vision, dtype=dtype)
        self.text_projection = Dense(c.text.hidden_size, c.projection_dim,
                                     bias=False, dtype=dtype)
        self.visual_projection = Dense(c.vision.hidden_size, c.projection_dim,
                                       bias=False, dtype=dtype)

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: Optional[torch.Tensor] = None):
        _, pooled = self.text_model(input_ids, attention_mask)
        return self.text_projection(pooled)

    def get_image_features(self, pixel_values: torch.Tensor,
                           pred_masks: Optional[torch.Tensor] = None,
                           masking_block_idx: Optional[int] = None):
        """pred_masks: (P, g, g) {0, 1} masks at the patch grid."""
        vm = self.vision_model
        x = vm.pre_layernorm(vm.embed_patches(pixel_values))
        x = run_masked_layers(x, vm.layers, pred_masks, masking_block_idx)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def _host_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on `device`; to a CUDA device through pinned memory
    without blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class ZeroShotRIS:
    """The batch-1 orchestrator around the proposal network `solo` and the
    dual encoder `clip` (`MaskedCLIP`, or `BiomedCLIP`: anything with
    `get_text_features` / `get_image_features` and a config with
    `.vision.patch_size`), both on one device, the proposal batch over
    `devices`. Inference only."""

    clip_config: Any
    solo_config: SOLOv2Config
    clip: nn.Module
    solo: SOLOv2
    masking_block_idx: Optional[int] = -3
    alpha: float = 0.95
    beta: float = 0.5
    num_masks: int = 1
    clip_image_size: int = 224
    cache_dir: Optional[Path] = None
    read_cache: bool = False
    write_cache: bool = False
    # the devices the proposal batch runs over, the models' own first; ()
    # is the models' device alone
    devices: tuple = ()

    def __post_init__(self):
        if self.cache_dir is not None:
            self.cache_dir = Path(self.cache_dir)
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.device = next(self.solo.parameters()).device
        self.devices = tuple(torch.device(d) for d in self.devices) or (self.device,)
        if self.devices[0] != self.device:
            raise ValueError(f"devices {self.devices}: the first must be the "
                             f"models' device, {self.device}")
        # one replica of the dual encoder a device (shared where a device
        # repeats the models' own)
        self.replicas = [self.clip if d == self.device
                         else copy.deepcopy(self.clip).to(d)
                         for d in self.devices]

    def _proposal_parallel(self, fn, proposals: torch.Tensor,
                           *shared: torch.Tensor) -> torch.Tensor:
        """`fn(clip, proposals, *shared)` over contiguous chunks of the
        proposal batch, one chunk a device through its replica of the dual
        encoder, every chunk launched before any result is gathered; the
        results concatenated on the first device."""
        if len(self.devices) == 1:
            return fn(self.clip, proposals, *shared)
        outs = [fn(clip, chunk.to(device), *(t.to(device) for t in shared))
                for device, clip, chunk in zip(
                    self.devices, self.replicas,
                    torch.tensor_split(proposals, len(self.devices)))
                if chunk.shape[0]]
        return torch.cat([o.to(self.device) for o in outs])

    # ---- FreeSOLO proposals ------------------------------------------------

    def _solo_forward(self, image: torch.Tensor, ori_hw: tuple[int, int]):
        batched = preprocess_image(image, self.solo_config)
        cate, kern, emb, mask_feats = self.solo(batched)
        return solov2_inference(cate, kern, emb, mask_feats, self.solo_config,
                                tuple(batched.shape[-2:]), ori_hw)

    @torch.no_grad()
    def get_freesolo_predictions(self, image: np.ndarray,
                                 cache_name: Optional[str] = None):
        path = self._cache_path(cache_name, "freesolo")
        if path is not None and self.read_cache and path.exists():
            data = np.load(path)
            return data["masks"], data["boxes"], data["valid"]
        masks, boxes, _, _, valid = self._solo_forward(
            _host_tensor(image, self.device), tuple(image.shape[-2:]))
        masks, boxes, valid = (masks.cpu().numpy(), boxes.cpu().numpy(),
                               valid.cpu().numpy())
        if path is not None and self.write_cache:
            np.savez_compressed(path, masks=masks, boxes=boxes, valid=valid)
        return masks, boxes, valid

    # ---- CLIP features -----------------------------------------------------

    def _mask_features(self, image: torch.Tensor, masks: torch.Tensor):
        """The masked-CLIP features of each proposal: the image resized to
        the CLIP input, the masks downsampled to the patch grid by torch's
        legacy "nearest" (floor(dst * scale))."""
        size = self.clip_image_size
        resized = resize_2d(image[None], (size, size), "bicubic")
        grid = size // self.clip_config.vision.patch_size
        small = (resize_2d(masks.float(), (grid, grid), "nearest") > 0.5).float()
        return self._proposal_parallel(
            lambda clip, small, resized: clip.get_image_features(
                resized, small, self.masking_block_idx).float(), small, resized)

    def _crop_features(self, crops: torch.Tensor) -> torch.Tensor:
        """The plain CLIP features of the (P, 3, S, S) crops."""
        return self._proposal_parallel(
            lambda clip, crops: clip.get_image_features(crops).float(), crops)

    @torch.no_grad()
    def get_mask_features(self, image: np.ndarray, masks: np.ndarray):
        return self._mask_features(_host_tensor(image, self.device),
                                   _host_tensor(masks, self.device))

    @staticmethod
    def host_crop_canvases(image: np.ndarray, boxes: np.ndarray,
                           masks: np.ndarray, valid: np.ndarray,
                           size: int) -> np.ndarray:
        """The reference's crop pipeline on the host (torchvision
        resized_crop of the mask-filled image; zero_shot_ris/__init__.py:
        106-159), one proposal at a time: the oracle of the device op
        `ops.image.crop_resize_bicubic_masked`. Invalid proposals get a zero
        canvas."""
        pixel_mean = image.mean(axis=(1, 2), keepdims=True)
        h, w = image.shape[1:]
        crops = []
        for box, mask, ok in zip(boxes.astype(np.int64), masks, valid):
            if not ok:
                crops.append(np.zeros((3, size, size), np.float32))
                continue
            filled = image * mask[None] + (1 - mask[None]) * pixel_mean
            x1, y1, x2, y2 = (int(v) for v in box)
            # crop (past the image: zero) then resize
            ch, cw = max(y2 - y1, 1), max(x2 - x1, 1)
            canvas = np.zeros((3, ch, cw), np.float32)
            ys0, xs0 = max(0, y1), max(0, x1)
            ys1, xs1 = min(h, y1 + ch), min(w, x1 + cw)
            if ys1 > ys0 and xs1 > xs0:
                canvas[:, ys0 - y1:ys1 - y1, xs0 - x1:xs1 - x1] = \
                    filled[:, ys0:ys1, xs0:xs1]
            crops.append(resize_2d(torch.from_numpy(canvas), (size, size),
                                   "bicubic").numpy())
        return np.stack(crops)

    @torch.no_grad()
    def get_crop_features(self, image: np.ndarray, boxes: np.ndarray,
                          masks: np.ndarray, valid: np.ndarray):
        crops = self.host_crop_canvases(image, boxes, masks, valid,
                                        self.clip_image_size)
        return self._crop_features(_host_tensor(crops, self.device))

    @torch.no_grad()
    def get_visual_feature(self, image, boxes, masks, valid, cache_name=None):
        path = self._cache_path(cache_name, "visual_feature")
        if path is not None and self.read_cache and path.exists():
            data = np.load(path)
            mask_f = torch.from_numpy(data["mask_features"]).to(self.device)
            crop_f = torch.from_numpy(data["crop_features"]).to(self.device)
        else:
            mask_f = (self.get_mask_features(image, masks)
                      if self.alpha != 0 else torch.zeros((), device=self.device))
            crop_f = (self.get_crop_features(image, boxes, masks, valid)
                      if self.alpha != 1 else torch.zeros((), device=self.device))
            if path is not None and self.write_cache:
                np.savez_compressed(path, mask_features=mask_f.cpu().numpy(),
                                    crop_features=crop_f.cpu().numpy())
        return self.alpha * mask_f + (1 - self.alpha) * crop_f

    @torch.no_grad()
    def get_text_ensemble(self, input_ids, attention_mask, cache_name=None):
        path = self._cache_path(cache_name, "textual_feature")
        if path is not None and self.read_cache and path.exists():
            data = np.load(path)
            phrase = torch.from_numpy(data["phrase_features"]).to(self.device)
            classname = torch.from_numpy(data["class_features"]).to(self.device)
        else:
            feats = self.clip.get_text_features(
                _host_tensor(input_ids, self.device),
                _host_tensor(attention_mask, self.device)).float()
            phrase, classname = feats[0], feats[1]
            if path is not None and self.write_cache:
                np.savez_compressed(path, phrase_features=phrase.cpu().numpy(),
                                    class_features=classname.cpu().numpy())
        return self.beta * phrase + (1 - self.beta) * classname

    # ---- the fused device path ---------------------------------------------

    def _fused_forward(self, image: torch.Tensor, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor, ori_hw: tuple[int, int]):
        """The whole pipeline on the device with no host read: proposals ->
        mask downsample -> masked CLIP (+ the device crop-resize -> CLIP when
        alpha < 1) -> text ensemble -> cosine argmax -> the picked mask(s),
        (num_masks, 1, H, W) f32; all-invalid proposals give a zero mask."""
        masks, boxes, _, _, valid = self._solo_forward(image, ori_hw)
        zero = torch.zeros((), device=image.device)
        mask_f = crop_f = zero
        if self.alpha != 0.0:
            mask_f = self._mask_features(image, masks)
        if self.alpha != 1.0:
            crops = crop_resize_bicubic_masked(image, masks, boxes,
                                               self.clip_image_size)
            # invalid rows do not matter: -inf at the selection below
            crop_f = self._crop_features(crops)
        visual = self.alpha * mask_f + (1.0 - self.alpha) * crop_f
        feats = self.clip.get_text_features(input_ids, attention_mask).float()
        text = self.beta * feats[0] + (1 - self.beta) * feats[1]
        v = visual / torch.linalg.vector_norm(visual, dim=-1, keepdim=True)
        t = text / torch.linalg.vector_norm(text, dim=-1)
        sims = torch.where(valid, v @ t, torch.full_like(valid, float("-inf"),
                                                         dtype=torch.float32))
        idx = (torch.argmax(sims)[None] if self.num_masks == 1
               else top_k_stable(sims, self.num_masks)[1])
        picked = masks[idx][:, None].float()
        picked = torch.where(valid.any(), picked, torch.zeros_like(picked))
        extras = {"masks": masks, "boxes": boxes, "valid": valid,
                  "mask_features": mask_f, "crop_features": crop_f,
                  "phrase_features": feats[0], "class_features": feats[1],
                  "sims": sims}
        return picked, extras

    def _launch(self, item: dict):
        """One fused request enqueued on the device, its result copied back
        without blocking: (host tensor, event to wait for, extras)."""
        image = item["image"]
        picked, extras = self._fused_forward(
            _host_tensor(image, self.device),
            _host_tensor(item["input_ids"], self.device),
            _host_tensor(item["attention_mask"], self.device),
            tuple(image.shape[-2:]))
        if picked.is_cuda:
            host = torch.empty(picked.shape, dtype=picked.dtype, pin_memory=True)
            host.copy_(picked, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done, extras
        return picked, None, extras

    @staticmethod
    def _result(host: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return host.numpy()

    @torch.no_grad()
    def predict_fused(self, image: np.ndarray, input_ids: np.ndarray,
                      attention_mask: np.ndarray,
                      cache_name: Optional[str] = None) -> np.ndarray:
        """`__call__` at any alpha with everything on the device (the crop
        branch through `crop_resize_bicubic_masked`) and one host read.

        With `write_cache` and `cache_dir` it also writes the host path's npz
        cache (freesolo, visual and textual files); only then are the
        intermediate tensors copied off the device."""
        host, done, extras = self._launch(
            {"image": image, "input_ids": input_ids,
             "attention_mask": attention_mask})
        if self.write_cache and self.cache_dir is not None and cache_name:
            ex = {k: v.cpu().numpy() for k, v in extras.items()}
            np.savez_compressed(self._cache_path(cache_name, "freesolo"),
                                masks=ex["masks"], boxes=ex["boxes"],
                                valid=ex["valid"])
            np.savez_compressed(self._cache_path(cache_name, "visual_feature"),
                                mask_features=ex["mask_features"],
                                crop_features=ex["crop_features"])
            np.savez_compressed(self._cache_path(cache_name, "textual_feature"),
                                phrase_features=ex["phrase_features"],
                                class_features=ex["class_features"])
        return self._result(host, done)

    def predict_fused_many(self, items: Iterable[dict], depth: int = 2):
        """Pipelined `predict_fused` over `items` (dicts with `image`,
        `input_ids`, `attention_mask`, optional `cache_name`): a generator of
        the picked masks in order, with up to `depth` requests in flight. A
        request's copy to the host is enqueued behind it and waited for only
        when its result is due, so the host enqueues the next requests while
        the device computes, and the consumer's work overlaps too. Gives what
        sequential `predict_fused` gives. Writing the cache needs every
        intermediate on the host, so `write_cache` (or depth < 1) runs
        sequentially."""
        if depth < 1 or (self.write_cache and self.cache_dir is not None):
            for item in items:
                yield self.predict_fused(item["image"], item["input_ids"],
                                         item["attention_mask"],
                                         cache_name=item.get("cache_name"))
            return
        pending: collections.deque = collections.deque()
        for item in items:
            with torch.no_grad():
                host, done, _ = self._launch(item)
            pending.append((host, done))
            if len(pending) > depth:
                yield self._result(*pending.popleft())
        while pending:
            yield self._result(*pending.popleft())

    @torch.no_grad()
    def __call__(self, image: np.ndarray, input_ids: np.ndarray,
                 attention_mask: np.ndarray,
                 cache_name: Optional[str] = None) -> np.ndarray:
        """image (3, H, W) float pixels; input_ids (2, L): [phrase, class
        name]. Returns (num_masks, 1, H, W) f32 masks; zeros of (1, 1, H, W)
        when no proposal is valid."""
        masks, boxes, valid = self.get_freesolo_predictions(image, cache_name)
        if not valid.any():
            return np.zeros((1, 1, *image.shape[1:]), np.float32)
        visual = self.get_visual_feature(image, boxes, masks, valid, cache_name)
        text = self.get_text_ensemble(input_ids, attention_mask, cache_name)
        v = visual / torch.linalg.vector_norm(visual, dim=-1, keepdim=True)
        t = text / torch.linalg.vector_norm(text, dim=-1, keepdim=True)
        sims = torch.where(torch.from_numpy(np.asarray(valid)).to(self.device),
                           v @ t, torch.tensor(float("-inf"), device=self.device))
        if self.num_masks == 1:
            idx = [int(torch.argmax(sims))]
        else:
            idx = top_k_stable(sims, self.num_masks)[1].tolist()
        return masks[idx][:, None].astype(np.float32)

    def _cache_path(self, cache_name: Optional[str],
                    postfix: str) -> Optional[Path]:
        if self.cache_dir is None or cache_name is None:
            return None
        return self.cache_dir / f"{Path(cache_name).stem}_{postfix}.npz"

"""Image-text-mask datasets — same on-disk formats as the reference.

  * `ImageTextMaskDataset` (reference src/data/core_datasets/
    image_text_mask_dataset.py): JSON task list
    `[{img_name, mask_name, prompts: {p0: ..., p1: [...]}}]`; prompt
    selection override_prompt > p{index} > random (random key excluding p0,
    then random element if a list); optional trailing "."; mask =
    grayscale/255 float32.
  * `ImageDirTextMaskDataset` (image_dir_mask_text_dataset.py): tasks scanned
    from `mask_dir/<class_name>/*<suffix>`; the prompt IS the class/directory
    name — used for binarized Cityscapes/VOC/ADE20k zero-shot suites.

Unlike the torch Dataset, items here carry everything as numpy with FIXED
text shape (pad-to-77) so downstream batches have static shapes; the ragged
dynamic-padding collator of the reference (data_collator.py:8) is
intentionally gone (SURVEY §2.3 consequence note).

The port's own copy of `tunevlseg_tpu/data/datasets.py`. Images decode
through cv2, imported at first use by `data/opencv.py` (the JAX package's
native libjpeg / libpng codec is not ported: ROADMAP "Do not port").
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np

from tunevlseg_torch.data.opencv import cv2 as _cv2
from tunevlseg_torch.data.tokenizer import CLIPTokenizer
from tunevlseg_torch.data.transforms import Compose, to_chw

StrOrPath = Union[str, Path]

# cv2's values of the flags used here (stable across OpenCV releases)
IMREAD_GRAYSCALE, IMREAD_COLOR = 0, 1
COLOR_BGR2RGB = 4


def load_image(path: StrOrPath, flags: int = IMREAD_COLOR,
               cvt_color: Optional[int] = COLOR_BGR2RGB) -> np.ndarray:
    """Decode an image to RGB (or grayscale, or cv2's BGR with
    `cvt_color=None`) with cv2."""
    cv2 = _cv2()
    img = cv2.imread(str(path), flags)
    if img is None:
        raise FileNotFoundError(f"could not read image: {path}")
    if cvt_color is not None and img.ndim == 3:
        img = cv2.cvtColor(img, cvt_color)
    return img


class BaseImageTextMaskDataset:
    def __init__(
        self,
        tokenizer: CLIPTokenizer,
        transforms: Optional[Compose] = None,
        max_length: int = 77,
        tokenizer_style: str = "hf",
        seed: int = 0,
    ):
        self.tokenizer = tokenizer
        self.transforms = transforms
        self.max_length = max_length
        self.tokenizer_style = tokenizer_style
        self.seed = seed

    def __len__(self) -> int:
        return len(self.tasks)

    def tokenize(self, prompt: str) -> dict[str, np.ndarray]:
        out = self.tokenizer(prompt, max_length=self.max_length,
                             style=self.tokenizer_style)
        return {"input_ids": out["input_ids"][0],
                "attention_mask": out["attention_mask"][0]}

    def fixed_prompt(self) -> Optional[str]:
        """The single prompt string every sample provably selects, or None.

        Multi-host prompt dedup replicates the unique text rows via
        `make_array_from_process_local_data`, which trusts the hosts to
        pass identical values — that only holds when prompt selection is a
        CONSTANT over the dataset (hosts hold disjoint sample shards, so
        per-task or list-sampled prompts can diverge across hosts even
        with a fixed prompt_index). Subclasses override where the property
        is checkable; the base conservatively answers None."""
        return None


class ImageTextMaskDataset(BaseImageTextMaskDataset):
    def __init__(
        self,
        *,
        image_dir: StrOrPath,
        mask_dir: StrOrPath,
        task_path: StrOrPath,
        prompt_index: int = 0,
        override_prompt: Optional[str] = None,
        insert_stop_at_last: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.image_dir = Path(image_dir)
        self.mask_dir = Path(mask_dir)
        with open(task_path, encoding="utf-8") as fp:
            self.tasks = json.load(fp)
        self.prompt_key = f"p{prompt_index}" if prompt_index >= 0 else "random"
        self.override_prompt = override_prompt
        self.insert_stop_at_last = insert_stop_at_last

    def pick_prompt(self, task: Mapping[str, Any],
                    rng: np.random.Generator) -> str:
        if self.override_prompt is not None:
            prompt = self.override_prompt
        else:
            prompts = task["prompts"]
            if self.prompt_key == "random":
                keys = sorted(prompts, key=lambda k: int(k[1:]))
                key = keys[1:][int(rng.integers(len(keys) - 1))]
            else:
                key = self.prompt_key
            prompt = prompts[key]
            if not isinstance(prompt, str):
                prompt = prompt[int(rng.integers(len(prompt)))]
        if self.insert_stop_at_last and not prompt.endswith("."):
            prompt += "."
        return prompt

    def fixed_prompt(self) -> Optional[str]:
        if self.override_prompt is not None:
            prompt = self.override_prompt
        else:
            if self.prompt_key == "random":
                return None
            vals = set()
            for task in self.tasks:
                v = task["prompts"].get(self.prompt_key)
                if not isinstance(v, str):  # missing or list-sampled
                    return None
                vals.add(v)
                if len(vals) > 1:
                    return None
            if not vals:
                return None
            prompt = next(iter(vals))
        if self.insert_stop_at_last and not prompt.endswith("."):
            prompt += "."
        return prompt

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, index))
        task = self.tasks[index]
        image = load_image(self.image_dir / str(task["img_name"]))
        mask = load_image(self.mask_dir / str(task["mask_name"]),
                          IMREAD_GRAYSCALE, None).astype(np.float32) / 255
        mask_shape = np.asarray(mask.shape, np.int32)

        if self.transforms is not None:
            image, mask = self.transforms(image, mask, rng)
        if image.dtype != np.uint8:  # normalized on host; uint8 stays packed
            image = image.astype(np.float32)
        image, mask = to_chw(image, mask)

        prompt = self.pick_prompt(task, rng)
        return {
            "image": image,
            "mask": mask,
            "mask_shape": mask_shape,
            "mask_name": str(task["mask_name"]),
            "prompt": prompt,
            **self.tokenize(prompt),
        }


class ZeroShotDataset(ImageTextMaskDataset):
    """Wraps ImageTextMaskDataset for ZeroShotRIS: tokenizes the
    [prompt, object_class] PAIR (phrase + classname text ensemble) and
    attaches a cache_name for the npz feature cache
    (reference src/data/core_datasets/zeroshot_dataset.py:6-23).

    Tasks must carry an `object_class` field; batch size must be 1."""

    def __getitem__(self, index: int):
        item = super().__getitem__(index)
        task = self.tasks[index]
        object_class = str(task.get("object_class", item["prompt"]))
        pair = self.tokenizer([item["prompt"], object_class],
                              max_length=self.max_length,
                              style=self.tokenizer_style)
        item["input_ids"] = pair["input_ids"]
        item["attention_mask"] = pair["attention_mask"]
        item["cache_name"] = str(Path(str(task["mask_name"])).stem)
        return item


class ImageDirTextMaskDataset(BaseImageTextMaskDataset):
    """Masks organized as `mask_dir/<class_name>/<image>.suffix`; the class
    (directory) name is the prompt."""

    def __init__(
        self,
        *,
        image_dir: StrOrPath,
        mask_dir: StrOrPath,
        mask_suffix: str = ".png",
        image_suffix: str = ".png",
        insert_stop_at_last: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.image_dir = Path(image_dir)
        self.mask_dir = Path(mask_dir)
        self.image_suffix = image_suffix
        self.insert_stop_at_last = insert_stop_at_last
        class_dirs = [p for p in self.mask_dir.iterdir() if p.is_dir()]
        if not class_dirs:
            raise ValueError(f"no class directories in {self.mask_dir}")
        self.tasks = [
            {"class_name": p.parent.name, "mask_name": p.name}
            for p in sorted(self.mask_dir.glob(f"*/*{mask_suffix}"))
        ]

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, index))
        task = self.tasks[index]
        class_name = str(task["class_name"])
        prompt = (f"{class_name}." if self.insert_stop_at_last
                  and not class_name.endswith(".") else class_name)

        mask_name = Path(str(task["mask_name"]))
        image = load_image(self.image_dir
                           / mask_name.with_suffix(self.image_suffix))
        mask = load_image(self.mask_dir / class_name / mask_name,
                          IMREAD_GRAYSCALE, None).astype(np.float32) / 255
        mask_shape = np.asarray(mask.shape, np.int32)

        if self.transforms is not None:
            image, mask = self.transforms(image, mask, rng)
        image, mask = to_chw(image.astype(np.float32), mask)
        return {
            "image": image,
            "mask": mask,
            "mask_shape": mask_shape,
            "mask_name": f"{class_name}/{mask_name}",
            "prompt": prompt,
            **self.tokenize(prompt),
        }

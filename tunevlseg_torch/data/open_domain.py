"""Open-domain referring-segmentation datasets (PhraseCut, RefCOCO).

Mirrors reference src/data/core_datasets/open_domain/:
  * prompt template pools "fixed"/"shuffle"/"shuffle+"
    (__init__.py:115-159), a random template per sample;
  * negative sampling: with probability `neg_prob`, the phrase is swapped
    for one NOT present on the same image and the mask becomes all-zeros
    (__init__.py:250-281);
  * PhraseCut: invalid COCO image-id exclusion, task_id "imgid__..."
    parsing, mask name "{task_id}-{safe_phrase}.png"
    (phrasecutdataset.py:74-148);
  * RefCOCO: task JSON {image_id, image_name, ann_id, sent_id, phrase},
    mask name "{image_id}-{ann_id}-{sent_id}.png" (refcocodataset.py:14-60).

The port's own copy of `tunevlseg_tpu/data/open_domain.py`; cv2 is imported
at first use, in `load_image`.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from tunevlseg_torch.data.datasets import (IMREAD_GRAYSCALE,
                                           BaseImageTextMaskDataset, StrOrPath,
                                           load_image)
from tunevlseg_torch.data.transforms import to_chw

PROMPT_POOLS = {
    "fixed": ("a photo of {}.",),
    "shuffle": ("a photo of {}.", "a photograph of {}.", "a picture of {}.",
                "an image of {}.", "{}."),
}
PROMPT_POOLS["shuffle+"] = PROMPT_POOLS["shuffle"] + tuple(
    f"a {quality} {noun} of {{}}."
    for noun in ("photo", "photograph", "image", "snap")
    for quality in ("cropped", "good", "bad")
)

PHRASECUT_INVALID_IMAGE_IDS = frozenset((
    150333, 285814, 498246, 498269, 498010, 498042, 498187, 498277, 498344,
    498390, 498393, 498453, 498476, 498504, 498748, 498911, 498921,
))


class OpenDomainDataset(BaseImageTextMaskDataset):
    """Base for phrase-grounded datasets with template prompts + negatives."""

    def __init__(
        self,
        *,
        image_dir: StrOrPath,
        mask_dir: StrOrPath,
        task_path: StrOrPath,
        prompt_method: str = "fixed",
        neg_prob: float = 0.0,
        neg_sample_tries: int = 5,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.image_dir = Path(image_dir)
        self.mask_dir = Path(mask_dir)
        self.prompt_pool = PROMPT_POOLS[prompt_method]
        self.neg_prob = neg_prob
        self.neg_sample_tries = neg_sample_tries
        self.tasks = self.load_tasks(task_path)
        # phrase -> image ids index, built lazily only when negatives are on
        self._phrase_index: Optional[dict[str, set]] = None
        self._unique_phrases: Optional[list[str]] = None

    # -- per-dataset contracts ----------------------------------------------

    def load_tasks(self, task_path: StrOrPath) -> list[Mapping[str, Any]]:
        with open(task_path, encoding="utf-8") as fp:
            return json.load(fp)

    def image_name(self, task: Mapping[str, Any]) -> str:
        raise NotImplementedError

    def image_id(self, task: Mapping[str, Any]):
        return task["image_id"]

    def mask_name(self, task: Mapping[str, Any]) -> str:
        raise NotImplementedError

    # -- negative sampling ---------------------------------------------------

    def _build_phrase_index(self) -> None:
        index: dict[str, set] = {}
        for t in self.tasks:
            index.setdefault(str(t["phrase"]), set()).add(self.image_id(t))
        self._phrase_index = index
        self._unique_phrases = sorted(index)

    def negative_phrase(self, phrase: str, image_id,
                        rng: np.random.Generator) -> Optional[str]:
        if self.neg_prob < 1 and not (self.neg_prob > 0
                                      and rng.random() < self.neg_prob):
            return None
        if self._phrase_index is None:
            self._build_phrase_index()
        for _ in range(self.neg_sample_tries):
            cand = self._unique_phrases[
                int(rng.integers(len(self._unique_phrases)))]
            if cand == phrase:
                continue
            if image_id not in self._phrase_index[cand]:
                return cand
        return None

    # -- item ----------------------------------------------------------------

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, index))
        task = self.tasks[index]
        image = load_image(self.image_dir / self.image_name(task))
        mask_shape = np.asarray(image.shape[:2], np.int32)
        mask_name = self.mask_name(task)

        phrase = str(task["phrase"])
        neg = self.negative_phrase(phrase, self.image_id(task), rng)
        if neg is not None:
            phrase = neg
            mask = np.zeros(image.shape[:2], np.float32)
        else:
            mask = load_image(self.mask_dir / mask_name, IMREAD_GRAYSCALE,
                              None).astype(np.float32) / 255

        if self.transforms is not None:
            image, mask = self.transforms(image, mask, rng)
        image, mask = to_chw(image.astype(np.float32), mask)

        template = self.prompt_pool[int(rng.integers(len(self.prompt_pool)))]
        prompt = template.format(phrase)
        return {
            "image": image,
            "mask": mask,
            "mask_shape": mask_shape,
            "mask_name": mask_name,
            "prompt": prompt,
            **self.tokenize(prompt),
        }


class PhraseCutDataset(OpenDomainDataset):
    def load_tasks(self, task_path):
        tasks = super().load_tasks(task_path)
        return [t for t in tasks
                if self.image_id(t) not in PHRASECUT_INVALID_IMAGE_IDS]

    def image_id(self, task):
        tid = str(task["task_id"])
        return int(tid.split("__", 1)[0])

    def image_name(self, task) -> str:
        return f"{self.image_id(task)}.jpg"

    def mask_name(self, task) -> str:
        phrase = str(task["phrase"]).replace("\x00", "").replace("/", "\\")
        return f"{task['task_id']}-{phrase}.png"


class RefCOCODataset(OpenDomainDataset):
    def image_name(self, task) -> str:
        return str(task["image_name"])

    def mask_name(self, task) -> str:
        return f"{task['image_id']}-{task['ann_id']}-{task['sent_id']}.png"

"""Host-side batch collation (numpy only).

The port's own copy of `collate`, `dedup_text` and `device_batch` from
`tunevlseg_tpu/data/pipeline.py`: batches have fixed shapes, a partial final
batch is padded with repeated samples and `valid = 0` flags, and
`text_dedup=U` rewrites the text keys to the batch's unique prompt rows plus
the inverse map `text_index`, so the text tower runs U times instead of
batch_size times. The threaded `DataLoader` comes with the training loop.
"""
from __future__ import annotations

import logging
from typing import Any

import numpy as np

_ARRAY_KEYS = ("image", "mask", "input_ids", "attention_mask")
_warned_dense_fallback = False


def collate(samples: list[dict[str, Any]], batch_size: int,
            text_dedup: int = 0, strict_dedup: bool = True) -> dict[str, Any]:
    """Stack samples; pad to `batch_size` with repeats + valid=0.

    `text_dedup=U` rewrites the text keys to the batch's unique prompt rows
    padded to the STATIC capacity U, plus an inverse map `text_index` (B,).
    When a batch holds more than U distinct prompts, `strict_dedup=True`
    raises and `strict_dedup=False` falls back to the dense layout for THIS
    batch with a one-time warning."""
    n = len(samples)
    valid = np.zeros((batch_size,), np.float32)
    valid[:n] = 1.0
    while len(samples) < batch_size:
        samples.append(samples[-1])
    batch: dict[str, Any] = {
        k: np.stack([s[k] for s in samples]) for k in _ARRAY_KEYS
        if k in samples[0]
    }
    batch["valid"] = valid
    if text_dedup and "input_ids" in batch:
        try:
            dedup_text(batch, text_dedup)
        except ValueError:
            if strict_dedup:
                raise
            global _warned_dense_fallback
            if not _warned_dense_fallback:
                _warned_dense_fallback = True
                logging.getLogger("tunevlseg").warning(
                    "text_dedup=%d exceeded by a batch's distinct prompts: "
                    "falling back to DENSE text collation for such batches "
                    "(slower; raise data.text_dedup or set it to 0 for "
                    "multi-prompt data). Further fallbacks are silent.",
                    text_dedup)
    # passthrough metadata (lists, not arrays: host-side only)
    for k in ("mask_name", "prompt", "mask_shape"):
        if k in samples[0]:
            batch[k] = [s[k] for s in samples]
    return batch


def dedup_text(batch: dict[str, Any], capacity: int) -> dict[str, Any]:
    """In-place prompt dedup: keep the unique (input_ids, attention_mask)
    rows (padded to `capacity` with repeats of row 0; padding rows are
    computed but never gathered, so they carry no gradient) and add the
    int32 inverse map `text_index`."""
    ids = batch["input_ids"]
    am = batch.get("attention_mask")
    row_key: dict[bytes, int] = {}
    index = np.empty((ids.shape[0],), np.int32)
    keep: list[int] = []
    for i in range(ids.shape[0]):
        key = ids[i].tobytes() + (b"" if am is None else am[i].tobytes())
        j = row_key.setdefault(key, len(keep))
        if j == len(keep):
            keep.append(i)
        index[i] = j
    if len(keep) > capacity:
        raise ValueError(
            f"text_dedup={capacity} but the batch holds {len(keep)} distinct "
            f"prompts: raise data.text_dedup or disable it")
    sel = np.asarray(keep + [keep[0]] * (capacity - len(keep)))
    batch["input_ids"] = ids[sel]
    if am is not None:
        batch["attention_mask"] = am[sel]
    batch["text_index"] = index
    return batch


def device_batch(batch: dict[str, Any]) -> dict[str, Any]:
    """Strip host-only metadata before shipping to device."""
    return {k: v for k, v in batch.items()
            if k in (*_ARRAY_KEYS, "valid", "text_index")}

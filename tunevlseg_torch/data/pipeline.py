"""Host-side input pipeline: collation, threaded loading, device copies.

The port's own copy of `tunevlseg_tpu/data/pipeline.py`:
  * `collate`: batches have fixed shapes, a partial final batch is padded
    with repeated samples and `valid = 0` flags, and `text_dedup=U` rewrites
    the text keys to the batch's unique prompt rows plus the inverse map
    `text_index`, so the text tower runs U times instead of batch_size times;
  * `DataLoader`: a thread pool decodes / augments samples, a background
    producer keeps `prefetch` batches ready, and the epoch's order is a
    function of (seed, epoch), the same order as the JAX loader's;
  * `device_batch`: strips host-only metadata and, given a device, copies
    the arrays there through pinned memory without blocking the host.

Unlike the JAX module this one does not import cv2 (the JAX loader imports
it only to set its thread count), so that loading from memory needs none;
the datasets and transforms that decode take cv2 from `data/opencv.py`,
which sets that thread count.
"""
from __future__ import annotations

import logging
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np
import torch

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


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        drop_last: bool = False,
        prefetch: int = 2,
        num_shards: int = 1,
        shard_index: int = 0,
        text_dedup: int = 0,
        strict_dedup: Optional[bool] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.text_dedup = text_dedup
        # a sharded loader (one shard per process) must give every process
        # the same text layout every step, so capacity overflow stays an
        # error there; one process falls back to dense with a warning
        self.strict_dedup = (num_shards > 1 if strict_dedup is None
                             else strict_dedup)
        self.epoch = 0
        self.start_batch = 0
        # this loader yields every num_shards-th sample (DistributedSampler
        # semantics: wraparound padding keeps every shard the same length)
        self.num_shards = num_shards
        self.shard_index = shard_index

    def _shard_len(self) -> int:
        return -(-len(self.dataset) // self.num_shards)

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the loader at (epoch, start_batch). `start_batch` skips
        that many leading batches of the epoch's deterministic order: a
        step-level resume replays the tail of an interrupted epoch without
        training its consumed batches again."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        if self.num_shards > 1:
            total = self._shard_len() * self.num_shards
            idx = np.concatenate([idx, idx[: total - len(idx)]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __iter__(self) -> Iterator[dict[str, Any]]:
        order = self._order()
        nb = len(self)
        out: "queue.Queue[Any]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a blocking put that still sees a consumer that left early
            # (limit_batches), which would otherwise wedge the producer
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # a bounded window of batches in flight, so that decoded samples
            # never pile up past ~(window + prefetch) batches of memory
            window = self.prefetch + 2
            with ThreadPoolExecutor(self.num_workers) as pool:
                pending: deque = deque()
                b_next = min(self.start_batch, nb)
                try:
                    while pending or b_next < nb:
                        while b_next < nb and len(pending) < window:
                            lo = b_next * self.batch_size
                            chunk = order[lo:lo + self.batch_size]
                            pending.append([
                                pool.submit(self.dataset.__getitem__, i)
                                for i in chunk])
                            b_next += 1
                        futs = pending.popleft()
                        try:
                            item: Any = collate([f.result() for f in futs],
                                                self.batch_size,
                                                text_dedup=self.text_dedup,
                                                strict_dedup=self.strict_dedup)
                        except Exception as e:  # surface worker errors
                            item = e
                        if not put_or_stop(item) or isinstance(item, Exception):
                            return
                finally:
                    for futs in pending:
                        for f in futs:
                            f.cancel()
            put_or_stop(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def device_batch(batch: dict[str, Any], device=None) -> dict[str, Any]:
    """Strip host-only metadata before shipping to the device. Without a
    device the arrays stay as they are; with one, each becomes a tensor
    there: on a CUDA device pinned on the host, then copied with
    `non_blocking=True`, so the host goes on while the copy runs."""
    arrays = {k: v for k, v in batch.items()
              if k in (*_ARRAY_KEYS, "valid", "text_index")}
    if device is None:
        return arrays
    device = torch.device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out

"""cv2, imported at first use with its own thread pool switched off.

The loader's worker threads each decode and augment one sample, so cv2's
own threads would multiply with them (threads x cores); the JAX package
calls `cv2.setNumThreads(0)` when its pipeline module is imported. The port
imports cv2 only where a disk dataset, a transform or `Trainer.predict`'s
mask writer runs (loading from memory needs no cv2), and every such place
takes it from `cv2()`, which sets the thread count on the first call.
"""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def cv2():
    """The cv2 module, with `cv2.setNumThreads(0)` applied once."""
    import cv2 as module
    module.setNumThreads(0)
    return module

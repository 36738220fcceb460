"""The card: the check that the cell's chips are there, the device record of
the result, and the few calls that differ on the CPU (where only the tests
drive the loops; `run.py` refuses to run without a card)."""
from __future__ import annotations

import sys
import time

import torch


def require(chips: int) -> torch.device:
    """The first card, or exit with code 2 and no result line when CUDA is
    not there or has fewer cards than the cell asks for."""
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; a run needs the "
              "card and never falls back to the CPU", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} are there", file=sys.stderr)
        raise SystemExit(2)
    return torch.device("cuda", 0)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device, reserved: bool = False) -> int:
    """The allocator's peak since the last reset: of live tensors, or with
    `reserved` of what it holds from the card (a captured graph's private
    pool is held, not allocated, between replays)."""
    if torch.device(device).type != "cuda":
        return 0
    if reserved:
        return int(torch.cuda.max_memory_reserved(device))
    return int(torch.cuda.max_memory_allocated(device))


class Phases:
    """Seconds from the process's start to the end of each set-up phase."""

    def __init__(self, t0: float, device):
        self.t0, self.device, self.seconds = t0, device, {}

    def mark(self, name: str) -> None:
        sync(self.device)
        self.seconds[name] = time.perf_counter() - self.t0


class Marker:
    """An event after the work enqueued so far (nothing on the CPU, where
    the work is done when the call returns)."""

    def __init__(self, device):
        self.event = None
        if torch.device(device).type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def record(device, count: int) -> dict:
    """The result's `device` entry (the peak is filled in by the caller)."""
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}

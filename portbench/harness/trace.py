"""The traced window: torch.profiler over a short stretch of the cell's own
loop, reduced to what the per-layer readers take.

Device activity is every record on the CUDA timeline (kernels, copies,
sets) that is not a user annotation mirrored there. Busy time is the length
of the union of their intervals, so overlapping streams are not counted
twice; idle = 1 - busy / window, the arithmetic of `chip_smoke.py`'s
profile phases with the union in the place of the sum. Host spans are the
harness's own `record_function` ranges, on the profiler's clock: each loop
names its spans in its own module (`SPANS`) and hands them to `Window`.
The window opens with a spin kernel of its own and a synchronize: a
window's first device record is often lost, and the spin is left out of
every sum.
"""
from __future__ import annotations

import collections
import contextlib

import torch

SPIN_CYCLES = 1_000_000


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span of the harness, recorded only in the traced window."""
    if not on:
        yield
        return
    with torch.profiler.record_function(name):
        yield


class Window:
    """`with Window(spans) as w: ...` profiles the body; then `w.summary()`,
    with idle time told by the host spans named in `spans`."""

    def __init__(self, spans: tuple):
        self.spans = tuple(spans)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def summary(self) -> dict:
        return summarize(self.prof.events(), self.spans)


def _union(intervals: list) -> tuple:
    """(covered length, [(gap start, gap end)]) of sorted (start, end)."""
    covered, gaps = 0.0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


def summarize(events, span_names: tuple) -> dict:
    """{"window_s", "busy_s", "device": {name: [seconds, launches]},
    "idle_by_span": {span: seconds}} of a traced window, its host spans
    those named in `span_names`. The window runs
    from the first host span's start to the end of the last device record
    or host span."""
    from torch.autograd import DeviceType
    device, spans = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or "spin_kernel" in e.name:
                continue
            device.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name in span_names:
            spans.append((e.name, e.time_range.start, e.time_range.end))
    if not spans or not device:
        return {}
    start = min(s for _, s, _ in spans)
    end = max(max(e for _, _, e in spans), max(e for _, _, e in device))
    inside = [(s, e) for _, s, e in device if e > start]
    clipped = [(max(s, start), e) for s, e in inside]
    busy, gaps = _union(clipped)
    # the waits before the first and after the last device record count too
    gaps += [(start, min(s for s, _ in clipped)), (max(e for _, e in clipped), end)]
    gaps = [(a, b) for a, b in gaps if b > a]
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in device:
        if e > start:
            by_name[name][0] += (e - s) / 1e6
            by_name[name][1] += 1
    idle: dict = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [(s, n) for n, s, e in spans if s <= mid <= e]
        idle[max(open_)[1] if open_ else "none"] += (b - a) / 1e6
    return {"window_s": (end - start) / 1e6, "busy_s": busy / 1e6,
            "device": dict(by_name), "idle_by_span": dict(idle)}


def breakdown(summary: dict) -> dict:
    """The contract's `breakdown`: the ten device operations that took most
    time, and the idle time by the harness span open while the device
    waited, each as [name, seconds]."""
    ops = sorted(summary["device"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], v[0]] for n, v in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def kernel_time(summary: dict, *needles: str) -> tuple:
    """(seconds, launches) of the device records whose name holds any of
    `needles`."""
    secs, n = 0.0, 0
    for name, (s, c) in summary.get("device", {}).items():
        if any(k in name for k in needles):
            secs += s
            n += c
    return secs, n

"""Spans and counters of the port: one registry that every layer records
into and every reader takes plain numbers from.

Counterpart of the JAX package's `utils/profiling.py` (`trace`, `timed`):
there a region is traced by `jax.profiler`; here the program names its own
regions, and the same names reach three places:

  * `span(name)`, a context manager. On the host it adds the span's
    duration (two `time.perf_counter_ns` reads) to the name's count and
    total, and keeps a record (name, start, end, parent span, group index)
    in a bounded ring. While a `torch.profiler` is recording, and only
    then, it also opens `torch.profiler.record_function(name)`, so the span
    lies on the profiler's clock beside the device records.
  * Inside a CUDA graph's capture (`capturing()`), `span` records instead a
    pair of timing events into the graph as event nodes: a host span runs
    once, at the capture, while the events run at every replay. The pairs
    belong to the capture that is open; `replayed(spans)` marks a graph's
    pairs as those of the last group replayed, and `snapshot()` reads them.
  * `count(name, n)`, an always-on integer counter (the kernels' launch
    counts among them).

`group_begin()` and `group_end()` bracket each replayed group with two
plain timing events. A group's device time runs from its begin event to its
end event; the gap before it from the previous group's end event to its
begin event: the card's wait between two groups. Each is folded into the
ring once its events have completed, without waiting for them; what is
still open is folded by `snapshot()`.

The host work is a handful of records a step: nothing is recorded per
layer or per kernel.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Iterator, Optional

import torch

RING = 1 << 16           # records kept; the oldest go first
GAP = "captured.gap"     # the card between two replayed groups (device ms)
GROUP = "captured.group"  # a replayed group, begin event to end event (device ms)


@dataclasses.dataclass
class DeviceSpans:
    """The event pairs that one capture recorded, in the order the spans
    opened: [(name, begin event, end event)]."""
    pairs: list = dataclasses.field(default_factory=list)

    def resolve(self) -> dict:
        """{name: [ms of each span, in order]}; the events must have
        completed (after a synchronise)."""
        out: dict = collections.defaultdict(list)
        for name, begin, end in self.pairs:
            out[name].append(begin.elapsed_time(end))
        return dict(out)


class Registry:
    """Host spans, counters, the ring of records, the device spans of the
    captures and the replayed groups' events."""

    def __init__(self, capacity: int = RING):
        self.totals: dict = {}       # name -> [count, total ns]
        self.counters: dict = {}     # name -> int
        self.ring: collections.deque = collections.deque(maxlen=capacity)
        self.seq = 0
        self.group = -1              # index of the group being replayed
        self.capture: Optional[DeviceSpans] = None
        self.last_replay: Optional[DeviceSpans] = None
        self.last_group = -1
        self.last_profiled = False   # whether a profiler recorded the last replay
        self.unprofiled: dict = {}   # the spans of the latest such group read
        self.open: collections.deque = collections.deque()   # groups not folded
        self.last_end = None         # the end event of the last group
        self.last_begin = None       # the begin event of the last group
        self.free: list = []         # plain timing events to reuse
        self.local = threading.local()

    # -- host spans ------------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def _record(self, name: str, ms: float, group: int) -> None:
        """A record of device ms alone (no host clock, no parent)."""
        self.seq += 1
        self.ring.append((self.seq, name, None, None, None, group, ms))

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            with self._device_span(name):
                yield
            return
        stack = self._stack()
        parent = stack[-1] if stack else None
        self.seq += 1
        me = self.seq
        stack.append(me)
        profiled = (torch.profiler.record_function(name)
                    if torch._C._autograd._profiler_enabled() else None)
        if profiled is not None:
            profiled.__enter__()
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            if profiled is not None:
                profiled.__exit__(None, None, None)
            stack.pop()
            total = self.totals.setdefault(name, [0, 0])
            total[0] += 1
            total[1] += end - start
            self.ring.append((me, name, start, end, parent, self.group, None))

    @contextlib.contextmanager
    def _device_span(self, name: str) -> Iterator[None]:
        """Two events captured into the graph; kept by the open capture,
        dropped in a capture that is not the registry's. A body that raises
        ends the capture: no end event is recorded."""
        if self.capture is None:
            yield
            return
        begin = torch.cuda.Event(enable_timing=True, external=True)
        end = torch.cuda.Event(enable_timing=True, external=True)
        begin.record()
        yield
        end.record()
        self.capture.pairs.append((name, begin, end))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self.counters.get(name, 0)

    def zero(self, *names: str) -> None:
        for name in names:
            self.counters[name] = 0

    # -- captures and replays ----------------------------------------------------

    @contextlib.contextmanager
    def capturing(self) -> Iterator[DeviceSpans]:
        """Open while a graph is captured: the device spans recorded inside
        belong to the `DeviceSpans` it yields."""
        spans = DeviceSpans()
        outer, self.capture = self.capture, spans
        try:
            yield spans
        finally:
            self.capture = outer

    def _event(self) -> torch.cuda.Event:
        return self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)

    def set_group(self, index: int) -> None:
        """Tag the ring's records with the group `index` from here on."""
        self.group = index

    def group_begin(self, index: int) -> None:
        """A plain event on the current stream before group `index`'s
        replay. A group begun and never ended (its replay raised) is
        dropped, and the next gap is not measured across it."""
        self._read_last()
        if self.open and self.open[-1][3] is None:
            self.open.pop()
            self.last_end = None
        begin = self._event()
        begin.record()
        self.last_begin = begin
        self.open.append([index, self.last_end, begin, None, False])

    def group_end(self) -> None:
        """A plain event after the group's last work; then whatever has
        completed is folded."""
        end = self._event()
        end.record()
        self.open[-1][3] = end
        self.last_end = end
        self.poll()

    def replayed(self, spans: DeviceSpans, index: int) -> None:
        """`spans` are the device spans of the group just replayed."""
        self.last_replay, self.last_group = spans, index
        self.last_profiled = torch._C._autograd._profiler_enabled()

    def _read_last(self) -> None:
        """The last replayed group's spans into numbers where no profiler
        recorded it and it has completed, before its graph runs again and
        records the events anew. Never waits."""
        if (self.last_replay is None or self.last_profiled or self.last_end is None
                or self.unprofiled.get("group") == self.last_group
                or not self.last_end.query()):
            return
        self.unprofiled = {"group": self.last_group, "spans": self.last_replay.resolve()}

    def poll(self) -> None:
        """Fold each gap whose begin event has completed and each group
        whose end event has, in order; never wait."""
        while self.open:
            index, prev_end, begin, end, gap_done = entry = self.open[0]
            if not gap_done:
                if not begin.query():
                    return
                if prev_end is not None:
                    self._record(GAP, prev_end.elapsed_time(begin), index)
                entry[4] = True
            if end is None or not end.query():
                return
            self._record(GROUP, begin.elapsed_time(end), index)
            self.open.popleft()
            self.free.append(begin)
            if prev_end is not None:
                self.free.append(prev_end)

    # -- readers -----------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain numbers: {"spans": {name: {"count", "total_ms"}},
        "counters": {name: n}, "records": [{"id", "name", "start_ns",
        "end_ns", "ms", "parent", "group"}] (host spans with their clock
        reads; "captured.gap" and "captured.group" with device ms alone),
        "last_replay": {"group", "spans": {name: [ms a span]}, "start_ms",
        "profiled"}, "unprofiled": {"group", "spans"}}: `start_ms` runs from
        the last group's begin event to the first event inside its graph,
        the card's wait for the graph's launch; "unprofiled" holds the spans
        of the latest group that ran with no profiler recording and was read
        before its graph ran again (the device spans of a profiled group
        include the profiler's own cost on the card). Synchronises the
        device first, so that every open event completes."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
            self.poll()
            self._read_last()
        records = [{"id": seq, "name": name, "start_ns": start, "end_ns": end,
                    "ms": (end - start) / 1e6 if ms is None else ms,
                    "parent": parent, "group": group}
                   for seq, name, start, end, parent, group, ms in self.ring]
        last = {}
        if self.last_replay is not None:
            last = {"group": self.last_group, "spans": self.last_replay.resolve(),
                    "profiled": self.last_profiled}
            if self.last_begin is not None and self.last_replay.pairs:
                last["start_ms"] = self.last_begin.elapsed_time(self.last_replay.pairs[0][1])
        return {"spans": {name: {"count": n, "total_ms": ns / 1e6}
                          for name, (n, ns) in self.totals.items()},
                "counters": dict(self.counters), "records": records,
                "last_replay": last, "unprofiled": dict(self.unprofiled)}


_REGISTRY = Registry()


def registry() -> Registry:
    """The process's registry."""
    return _REGISTRY


def reset(capacity: int = RING) -> None:
    """Clear the registry: spans, counters, records and events."""
    global _REGISTRY
    _REGISTRY = Registry(capacity)


def span(name: str):
    """`with span(name):` times the body on the host, or inside a capture on
    the device (module docstring)."""
    return _REGISTRY.span(name)


def count(name: str, n: int = 1) -> None:
    _REGISTRY.count(name, n)


def counter(name: str) -> int:
    """A counter's value (0 for one never counted)."""
    return _REGISTRY.counter(name)


def zero(*names: str) -> None:
    """Set the named counters to 0."""
    _REGISTRY.zero(*names)


def capturing():
    return _REGISTRY.capturing()


def set_group(index: int) -> None:
    _REGISTRY.set_group(index)


def group_begin(index: int) -> None:
    _REGISTRY.group_begin(index)


def group_end() -> None:
    _REGISTRY.group_end()


def replayed(spans: DeviceSpans, index: int) -> None:
    _REGISTRY.replayed(spans, index)


def snapshot() -> dict:
    return _REGISTRY.snapshot()

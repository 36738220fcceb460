"""The four readers of the program's own spans (`forward_ms.train`,
`backward_ms.train`, `update_ms.train`, `group_gap_ms.train`): None on an
empty registry and where the program has no registry at all, and their
numbers from a filled one (on stand-in events: a CUDA event needs the
card)."""
from __future__ import annotations

import sys

import pytest

from portbench.harness import cell as cell_lib

READERS = ["forward_ms.train", "backward_ms.train", "update_ms.train",
           "group_gap_ms.train"]
PHASES = READERS[:3]


class _Event:
    def __init__(self, at: float):
        self.at = at

    def query(self) -> bool:
        return True

    def elapsed_time(self, other) -> float:
        return other.at - self.at


@pytest.fixture
def profiling():
    from tunevlseg_torch.utils import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_empty_registry(profiling, name):
    assert cell_lib.metric_reader(name).read({}, None) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_program_has_no_registry(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "tunevlseg_torch.utils.profiling", None)
    assert cell_lib.metric_reader(name).read({}, None) is None


def _fill(profiling) -> dict:
    """A profiled replay of a group of two steps, the latest unprofiled
    group's spans as the registry reads them, and three gaps."""
    reg = profiling.registry()
    spans = profiling.DeviceSpans()
    at = 0.0
    for step_ms in ((3.0, 5.0, 1.0), (4.0, 6.0, 2.0)):
        for name, ms in zip(("step.forward", "step.backward", "step.update"), step_ms):
            spans.pairs.append((name, _Event(at), _Event(at + ms)))
            at += ms
    reg.replayed(spans, 3)
    reg.unprofiled = {"group": 2, "spans": {
        "step.forward": [2.0, 4.0], "step.backward": [7.0, 9.0], "step.update": [0.5, 1.5]}}
    for i, gap in enumerate((0.5, 2.0, 0.25)):
        reg._record(profiling.GAP, gap, i + 1)
    return {"forward_ms.train": 3.0, "backward_ms.train": 8.0, "update_ms.train": 1.0,
            "group_gap_ms.train": 0.5}


@pytest.mark.parametrize("name", PHASES)
def test_the_phases_read_no_profiled_group(profiling, name):
    """A profiled group's spans carry the profiler's own cost on the card:
    with no unprofiled group read, the phases give None."""
    _fill(profiling)
    profiling.registry().unprofiled = {}
    assert cell_lib.metric_reader(name).read({}, None) is None


@pytest.mark.parametrize("name", READERS)
def test_reads_a_filled_registry(profiling, name):
    want = _fill(profiling)
    assert cell_lib.metric_reader(name).read({}, None) == pytest.approx(want[name])

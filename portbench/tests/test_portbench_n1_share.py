"""The reader of `n1_share.train`: None where the program has no N1
counters (or has counted no LayerNorm call), the share of N1's launches
among the LayerNorm calls otherwise."""
from __future__ import annotations

import sys

import pytest

from portbench.harness import cell as cell_lib


@pytest.fixture
def profiling():
    from tunevlseg_torch.utils import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


def read():
    return cell_lib.metric_reader("n1_share.train").read({}, None)


def test_none_without_the_counters(profiling, monkeypatch):
    assert read() is None
    profiling.zero("n1.launches", "n1.plain")
    assert read() is None
    monkeypatch.setitem(sys.modules, "tunevlseg_torch.utils.profiling", None)
    assert read() is None


def test_the_share_of_n1_launches(profiling):
    profiling.count("n1.launches", 63)
    assert read() == 100.0
    profiling.count("n1.plain", 21)
    assert read() == 75.0
    profiling.count("n1.bwd_launches", 9)     # the backward's: not a call
    assert read() == 75.0

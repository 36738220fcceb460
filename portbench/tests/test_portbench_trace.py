"""The traced window's arithmetic: busy time as the union of the device
records, idle time by the harness span open while the card waited."""
from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from portbench.harness import trace as tr


def ev(name, start, end, device):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end), is_user_annotation=False)


def test_union_busy_and_idle_by_span():
    events = [ev("replay", 0, 100, False), ev("sync", 100, 300, False),
              ev("gemm", 10, 50, True), ev("gemm", 40, 120, True),
              ev("flash_attn_fwd_kernel<64>", 200, 250, True),
              ev("spin_kernel", 0, 5, True), ev("other_cpu_op", 0, 300, False)]
    got = tr.summarize(events, ("replay", "sync"))
    assert got["window_s"] == pytest.approx(300e-6)
    assert got["busy_s"] == pytest.approx(160e-6)          # [10, 120] and [200, 250]
    assert got["idle_by_span"] == pytest.approx({"replay": 10e-6, "sync": 130e-6})
    assert got["device"]["gemm"] == [pytest.approx(120e-6), 2]
    assert tr.kernel_time(got, "flash_attn_fwd") == (pytest.approx(50e-6), 1)
    b = tr.breakdown(got)
    assert b["device_ops"][0][0] == "gemm" and b["idle_gaps"][0][0] == "sync"


def test_nothing_traced():
    assert tr.summarize([ev("replay", 0, 10, False)], ("replay",)) == {}

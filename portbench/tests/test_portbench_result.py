"""The result line's keys and the check for JAX by whole top-level names."""
from __future__ import annotations

import json
import types

import torch

from portbench import run as run_mod
from portbench.harness import cell as cell_lib, report


def fake_run(cell) -> dict:
    out = {"setup_s": 12.5, "window_s": 10.0, "steps": 400, "images": 25600,
           "requests": 300, "latency_s": [0.03] * 299 + [0.05],
           "dispatch_s": [0.02] * 300, "peak_window_bytes": 2 ** 31,
           "memory_peak_bytes": 2 ** 32, "attempted": 400, "failed": 0,
           "phases": {"build": 3.0},
           "trace": {"window_s": 0.5, "busy_s": 0.45,
                     "device": {"void flash_attn_fwd_kernel<64>": [0.03, 26],
                                "flash_attn_bwd_dq_kernel<16>": [0.004, 6],
                                "flash_attn_bwd_dkdv_kernel<16>": [0.004, 6],
                                "gemm": [0.3, 100]},
                     "idle_by_span": {"replay": 0.04, "sync": 0.01},
                     "steps": 20, "requests": 8}}
    out["checks"] = {k: 0.0 for k in cell.limits["limits"]}
    return out


def test_result_keys(capsys):
    for name in [w["name"] for w in json.loads(
            (cell_lib.ROOT / "BENCHMARK.json").read_text())["workloads"]]:
        cell = cell_lib.load(name)
        run = fake_run(cell)
        for traced in (False, True):
            res = report.result(cell, run, traced, torch.device("cpu"))
            assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
            assert res["correct"] is True
            want = cell.per_layer if traced else cell.end_to_end
            assert set(res["metrics"]) == {m.name for m in want}
            for m in want:
                assert res["metrics"][m.name]["unit"] == m.unit
                assert res["metrics"][m.name]["value"] > 0
            assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
            if traced:
                assert {"busy_s", "window_s"} <= set(res["device"])
                assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
                assert len(res["breakdown"]["device_ops"]) <= 10
            report.emit(dict(res))
            out, err = capsys.readouterr()
            line = json.loads(out.strip().splitlines()[-1])
            assert list(line)[-1] == "checks"
            assert "phases" not in line
            tail = err.strip().splitlines()[-len(line["checks"]):]
            assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_checks_fail_the_run():
    cell = cell_lib.load("clipseg_coop_train_b64")
    run = fake_run(cell)
    run["checks"] = dict(run["checks"], change_gap=1e9)
    assert report.result(cell, run, False, torch.device("cpu"))["correct"] is False
    run["checks"] = dict(run["checks"], change_gap=float("nan"))
    assert report.result(cell, run, False, torch.device("cpu"))["correct"] is False


def test_forbidden_modules_by_whole_top_level_name():
    mods = {"tunevlseg_torch": None, "tunevlseg_torch.serving": None,
            "jaxtyping": None, "flaxen.x": None, "numpy": None}
    assert run_mod.forbidden_modules(mods) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "tunevlseg_tpu",
                "tunevlseg_tpu.models"):
        assert run_mod.forbidden_modules({**mods, bad: None}) == [bad.split(".")[0]]


def test_cli_refuses_forbidden(monkeypatch, capsys):
    monkeypatch.setattr(run_mod, "main", lambda: {"checks": {}, "phases": {}})
    monkeypatch.setitem(__import__("sys").modules, "jax", types.ModuleType("jax"))
    assert run_mod.cli() == 3
    out, err = capsys.readouterr()
    assert out == "" and "jax" in err

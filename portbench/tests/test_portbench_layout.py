"""BENCHMARK.json against the benchmark's contract, and every cell resolved
to its files: configuration, traffic mix, limits, loop, program builder,
reference, work and metric readers."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench.harness import cell as cell_lib

BENCH = json.loads((cell_lib.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    every = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
             + BENCH["per_layer"])
    for entry in every:
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = cell_lib.load(name)
    assert cell.loop().run and cell.port().build_task
    work = cell.work()
    assert work.train_work and work.serve_work
    fam = importlib.import_module(f"portbench.reference.{cell.family}")
    assert fam.build and fam.trainable
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    moved = {next(x["moves"] for x in BENCH["per_layer"] if x["name"] == m.name)
             for m in cell.per_layer}
    assert moved <= e2e
    for m in cell.end_to_end + cell.per_layer:
        assert callable(m.reader.read)
    assert set(cell.limits["limits"]) and all(v > 0 for v in cell.limits["limits"].values())


def test_configs_used_and_files_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))

"""A cell, found by its name: its entry in `BENCHMARK.json`, its
configuration, its traffic mix, its limits and its metrics' readers.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric is a file of its own, looked up by the name `BENCHMARK.json`
gives it:

  portbench/configs/<config>.json     the model's sizes and the weights' draw
  portbench/traffic/<traffic>.json    the mix: its loop, batch, prompts, recipe
  portbench/workloads/<cell>.json     the limits of the correctness check
  portbench/metrics/<metric>.py       `read(run, cell)` -> number or None
  portbench/work/<config>.py          the operations and kernel bounds
  portbench/port/<family>.py          how the program under test is built
  portbench/reference/<family>.py     the plain reference of the family
  portbench/loops/<loop>.py           the loop that drives the entry
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

PKG = pathlib.Path(__file__).resolve().parent.parent
ROOT = PKG.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object      # module with read(run, cell)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    benchmark: dict

    @property
    def family(self) -> str:
        return self.config["family"]

    def port(self):
        return importlib.import_module(f"portbench.port.{self.family}")

    def work(self):
        return importlib.import_module(f"portbench.work.{self.config_name}")

    def loop(self):
        return importlib.import_module(f"portbench.loops.{self.traffic['loop']}")


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: the cells it lists, or, without a
    list, every cell (as `setup_s`)."""
    return cell in metric.get("workloads", [cell])


def metric_reader(name: str):
    return _module(PKG / "metrics" / f"{name}.py", name.replace(".", "_"))


def load(name: str, root: pathlib.Path = ROOT) -> Cell:
    benchmark = _json(root / "BENCHMARK.json")
    entry = next((w for w in benchmark["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in benchmark["configs"] if c["name"] == entry["config"])

    def metrics(kind: str) -> list:
        return [Metric(m["name"], m["unit"], metric_reader(m["name"]))
                for m in benchmark[kind] if reports(m, name)]

    return Cell(name=name, chips=entry["chips"], config_name=entry["config"],
                config=_json(root / config_entry["file"]),
                traffic_name=entry["traffic"],
                traffic=_json(PKG / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(PKG / "workloads" / f"{name}.json"),
                end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"),
                benchmark=benchmark)

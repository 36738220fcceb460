"""Tiny copies of the benchmark's cells for the CPU tests: the cell's own
files with a configuration of the same topology at small widths and a
batch of a few rows."""
from __future__ import annotations

import dataclasses
import json
import pathlib

from portbench.harness import cell as cell_lib

HERE = pathlib.Path(__file__).resolve().parent
TINY = {"clipseg": "tiny_clipseg.json"}
# cells whose files are here but which BENCHMARK.json does not hold yet
# (PERF.md, Open questions): (config, traffic, limits). The serving loop's
# mix, held by the limits read for it at b64 on the card.
UNLISTED = {"clipseg_coop_serve_b64": ("clipseg_rd64", "coop_serve_b64",
                                       {"limits": {"prob_gap_max": 0.13,
                                                   "prob_gap_mean": 0.0085},
                                        "checked_requests": 2,
                                        "reference_rows_per_block": 64})}


def unlisted(name: str) -> cell_lib.Cell:
    config, traffic, limits = UNLISTED[name]
    return cell_lib.Cell(
        name=name, chips=1, config_name=config,
        config=json.loads((cell_lib.PKG / "configs" / f"{config}.json").read_text()),
        traffic_name=traffic,
        traffic=json.loads((cell_lib.PKG / "traffic" / f"{traffic}.json").read_text()),
        limits=limits, end_to_end=[], per_layer=[], benchmark={})


def tiny_cell(name: str, batch: int = 4, **traffic) -> cell_lib.Cell:
    cell = unlisted(name) if name in UNLISTED else cell_lib.load(name)
    config = json.loads((HERE / TINY[cell.family]).read_text())
    t = dict(cell.traffic, batch=batch, **traffic)
    limits = dict(cell.limits, reference_rows_per_block=2)
    return dataclasses.replace(cell, config=config, traffic=t, limits=limits)

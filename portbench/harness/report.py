"""The result line: the cell's metrics from their readers, the device, the
breakdown of a traced run, and the compared numbers beside their limits
(last in the line, and the last lines of standard error)."""
from __future__ import annotations

import json
import sys

from portbench.harness import check, device as dev, trace as tr


def result(cell, run: dict, traced: bool, device) -> dict:
    correct, checks = check.verdict(run["checks"], cell.limits["limits"])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = m.reader.read(run, cell)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    record = dev.record(device, cell.chips)
    record["memory_peak_bytes"] = run["memory_peak_bytes"]
    out = {"correct": correct and run["failed"] == 0, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": record}
    if traced and run.get("trace"):
        record["busy_s"] = run["trace"]["busy_s"]
        record["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = tr.breakdown(run["trace"])
    out["checks"] = checks
    out["phases"] = run.get("phases", {})
    return out


def emit(result: dict) -> None:
    checks = result.pop("checks")
    print("set-up phases (s from the start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in result.pop("phases").items()), file=sys.stderr)
    result["checks"] = checks
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)

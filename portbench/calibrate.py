"""Readings from which a cell's correctness limits are set, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --controls 3

In one process (the program is built once): for each of `--seeds` seeds,
the program's checked groups (or its served requests) against the
reference, as a run's check reads them; and for the first `--controls`
seeds the control, the reference computed in float8 and put in the
program's place, and the faults a cell of its kind can have, planted in the
reference put in the program's place: half of each batch left out, the mean
taken over the rest (training), an answer altered where it is produced
(serving: each image given its neighbour's mask). A state left unchanged
reads 1 on `change_gap` by definition and is printed without a run. One
JSON line a seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def worst_leaves(reading: dict, ref: dict) -> dict:
    """The three leaves of largest moment and change gap, with their gaps."""
    from portbench.harness import check
    leaves = check.counted_leaves(ref["first_grad"])
    out = {}
    for key in ("gradnorm", "moment", "change", "gradnorm_last", "moment_last"):
        gaps = check.leaf_gaps(reading[key], ref[key], leaves)
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return out


def train_rows(cell, seeds, controls: int, device):
    import torch
    from portbench.harness import check, device as dev, inputs
    from portbench.loops import train_captured as tc
    k = cell.traffic["steps_per_group"]
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], device)
    shapes = tc.model_shapes(task)
    groups_checked = cell.limits["checked_groups"]
    for i, seed in enumerate(seeds):
        weights = inputs.weights(shapes, cell.config["init"], seed, device)
        state = task.init(params=weights)
        groups = tc.pool(cell, seed, device, groups_checked)
        multi = task.compile_train_multistep(k)
        state, reading = check.checked_groups(multi, task, state, groups, groups_checked)
        del multi, state, groups
        dev.free(device)
        per_step = tc.checked_steps(cell, seed, device)
        t = time.perf_counter()
        ref = check.run_reference(cell, weights, per_step, device)
        row = {"seed": seed, "reference_s": time.perf_counter() - t,
               "program": check.train_numbers(reading, ref),
               "worst_leaves": worst_leaves(reading, ref),
               "losses": {"program": reading["losses"], "reference": ref["losses"]}}
        if i < controls:
            ctrl = check.reference_as_program(
                check.run_reference(cell, weights, per_step, device, mode="fp8"),
                groups_checked)
            row["control"] = check.train_numbers(ctrl, ref)
            row["control_worst_leaves"] = worst_leaves(ctrl, ref)
            half = check.run_reference(cell, weights, per_step, device, half_batch=True)
            row["half_batch"] = check.train_numbers(
                check.reference_as_program(half, groups_checked), ref)
            still = dict(reading, change={n: torch.zeros_like(v)
                                          for n, v in reading["change"].items()})
            row["unchanged"] = check.train_numbers(still, ref)
        del weights, ref
        dev.free(device)
        yield row


def serve_rows(cell, seeds, controls: int, device):
    from tunevlseg_torch.serving import task_predict_fn
    from portbench.harness import check, device as dev, inputs
    from portbench.loops import serve_closed as sc
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], device)
    task.model.eval()
    shapes = {n: tuple(v.shape) for n, v in task.model.state_dict().items()}
    predict = task_predict_fn(task)
    n = cell.limits["checked_requests"]
    for i, seed in enumerate(seeds):
        weights = inputs.weights(shapes, cell.config["init"], seed, device)
        task.init(params=weights)
        params = dict(task.model.state_dict())
        reqs = [{k: v.to(device) for k, v in r.items()}
                for r in sc.request_pool(cell, seed, device, False)[:n]]
        got = [predict(params, r).cpu() for r in reqs]
        t = time.perf_counter()
        want = check.reference_probabilities(cell, weights, reqs, device)
        row = {"seed": seed, "reference_s": time.perf_counter() - t,
               "program": check.serve_numbers(got, want)}
        if i < controls:
            ctrl = check.reference_probabilities(cell, weights, reqs, device, mode="fp8")
            row["control"] = check.serve_numbers(ctrl, want)
            row["answer_altered"] = check.serve_numbers([g.roll(1, 0) for g in got], want)
        del weights, got, want, reqs
        dev.free(device)
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_019)
    args = p.parse_args(argv)
    from portbench.harness import cell as cell_lib, device as dev
    from portbench.run import prepare_environment
    prepare_environment()
    cell = cell_lib.load(args.workload, ROOT)
    device = dev.require(cell.chips)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = (serve_rows if cell.traffic["loop"] == "serve_closed" else train_rows)
    for row in rows(cell, seeds, args.controls, device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

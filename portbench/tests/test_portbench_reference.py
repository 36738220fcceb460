"""The plain reference against the program at a tiny size on the CPU, both
in float32 (the program's compute dtype set to float32), and the
reference's independence from the program."""
from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from portbench.harness import check, inputs
from portbench.loops import train_captured as tc
from portbench.reference import steps as ref_steps
from portbench.tests.tiny import tiny_cell

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "reference"


def f32_cell(name, **traffic):
    cell = tiny_cell(name, **traffic)
    return dataclasses.replace(cell, config=dict(cell.config, compute_dtype="float32"))


@pytest.mark.parametrize("name", ["clipseg_coop_train_b64", "clipseg_e2e_train_b64"])
def test_names_and_shapes_match_the_program(name):
    cell = tiny_cell(name)
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    ref = ref_steps.family(cell.family).build(cell.config, cell.traffic["recipe"])
    prog = {n: tuple(p.shape) for n, p in task.model.named_parameters()}
    assert prog == {n: tuple(p.shape) for n, p in ref.named_parameters()}
    task.init()
    trained = {n for n, p in task.model.named_parameters() if p.requires_grad}
    assert trained == set(ref_steps.family(cell.family).trainable(ref))


@pytest.mark.parametrize("name", ["clipseg_coop_train_b64", "clipseg_e2e_train_b64"])
def test_train_group_matches_the_program_in_f32(name):
    torch.manual_seed(0)
    cell = f32_cell(name, steps_per_group=2, groups_in_pool=2)
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    shapes = tc.model_shapes(task)
    weights = inputs.weights(shapes, cell.config["init"], 123, "cpu")
    state = task.init(params=weights)
    groups = tc.pool(cell, 123, "cpu", 2)
    state, reading = check.checked_groups(task.compile_train_multistep(2), task, state,
                                          groups, 2)
    ref = check.run_reference(cell, inputs.weights(shapes, cell.config["init"], 123, "cpu"),
                              tc.checked_steps(dataclasses.replace(
                                  cell, limits=dict(cell.limits, checked_groups=2)),
                                  123, "cpu"), "cpu")
    numbers = check.train_numbers(reading, ref)
    # two float32 programs agree to round-off (Adam amplifies it on tiny
    # gradient entries); bf16 moves these numbers by 1e-4 to 1e-2
    assert all(v < 1e-4 for v in numbers.values()), numbers


def test_probabilities_match_the_program_in_f32():
    from tunevlseg_torch.serving import task_predict_fn
    cell = f32_cell("clipseg_coop_serve_b64")
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    shapes = {n: tuple(v.shape) for n, v in task.model.state_dict().items()}
    task.init(params=inputs.weights(shapes, cell.config["init"], 9, "cpu"))
    req = inputs.batch(cell.traffic, cell.config, inputs.generator(9, 2, "cpu"), "cpu")
    got = task_predict_fn(task)(dict(task.model.state_dict()), req)
    want = check.reference_probabilities(
        cell, inputs.weights(shapes, cell.config["init"], 9, "cpu"), [req], "cpu")
    assert check.serve_numbers([got], want)["prob_gap_max"] < 1e-5


def test_reference_row_blocks_add_up():
    cell = tiny_cell("clipseg_e2e_train_b64", steps_per_group=1, groups_in_pool=1)
    group = tc.pool(cell, 4, "cpu", 1)[0]
    per_step = [{k: v[0] for k, v in group.items()}]
    fam = ref_steps.family(cell.family)
    shapes = {n: tuple(p.shape) for n, p in
              fam.build(cell.config, cell.traffic["recipe"]).named_parameters()}
    w = inputs.weights(shapes, cell.config["init"], 4, "cpu")
    whole = check.run_reference(cell, w, per_step, "cpu", rows_per_block=4)
    blocks = check.run_reference(cell, w, per_step, "cpu", rows_per_block=1)
    assert whole["losses"][0] == pytest.approx(blocks["losses"][0], rel=1e-6)
    for n, g in whole["first_grad"].items():
        torch.testing.assert_close(blocks["first_grad"][n], g, rtol=1e-4, atol=1e-7)


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        text = path.read_text()
        for name in ("tunevlseg_torch", "tunevlseg_tpu", "jax", "flax"):
            assert f"import {name}" not in text and f"from {name}" not in text, path
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.clipseg, "
            "portbench.reference.steps; bad = [m for m in sys.modules if m.split('.')[0] "
            "in ('tunevlseg_torch', 'tunevlseg_tpu', 'jax', 'flax')]; print(bad); "
            "sys.exit(1 if bad else 0)" % str(REFERENCE.parents[1]))
    subprocess.run([sys.executable, "-c", code], check=True)

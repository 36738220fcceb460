"""The CRIS cell on the CPU at a tiny size (`tiny_cris.json`: the topology
of `CRISConfig.tiny` with the decoder's dropout at 0.2): the plain
reference (`reference/cris.py`) against the program, both in float32, and
the correctness check of `cris_coop_train_b64` against a sound run, the
faults a cell of its kind can have and the control. Also the work of a
step at the cell's own shapes."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from portbench.harness import cell as cell_lib, check, inputs, report
from portbench.loops import train_captured as tc
from portbench.reference import steps as ref_steps
from portbench.work import common as work

HERE = pathlib.Path(__file__).resolve().parent
CELL = "cris_coop_train_b64"


def tiny_cell(batch: int = 4, dtype: str = "float32", **traffic) -> cell_lib.Cell:
    cell = cell_lib.load(CELL)
    config = json.loads((HERE / "tiny_cris.json").read_text())
    return dataclasses.replace(
        cell, config=dict(config, compute_dtype=dtype),
        traffic=dict(cell.traffic, batch=batch, **traffic),
        limits=dict(cell.limits, reference_rows_per_block=2))


def test_names_and_shapes_match_the_program():
    cell = tiny_cell()
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    ref = ref_steps.family("cris").build(cell.config, cell.traffic["recipe"])
    assert tc.model_shapes(task) == {n: tuple(t.shape) for n, t in ref.state_dict().items()}


def test_trainable_set_matches_the_program():
    cell = tiny_cell()
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    task.init()
    ref = ref_steps.family("cris").build(cell.config, cell.traffic["recipe"])
    trained = {n for n, p in task.model.named_parameters() if p.requires_grad}
    assert trained == set(ref_steps.family("cris").trainable(ref))


def test_checked_group_with_dropout_matches_the_program_in_f32():
    """One checked group of two steps, the decoder's dropout on: the
    reference draws the program's masks, so the two float32 programs agree
    to round-off."""
    torch.manual_seed(0)
    cell = tiny_cell(steps_per_group=2, groups_in_pool=1)
    cell = dataclasses.replace(cell, limits=dict(cell.limits, checked_groups=1))
    assert cell.config["dropout"] > 0
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    shapes = tc.model_shapes(task)
    state = task.init(params=inputs.weights(shapes, cell.config["init"], 123, "cpu"))
    groups = tc.pool(cell, 123, "cpu", 1)
    _, reading = check.checked_groups(task.compile_train_multistep(2), task, state,
                                      groups, 1)
    ref = check.run_reference(cell, inputs.weights(shapes, cell.config["init"], 123, "cpu"),
                              tc.checked_steps(cell, 123, "cpu"), "cpu")
    numbers = check.train_numbers(reading, ref)
    assert all(v < 1e-4 for v in numbers.values()), numbers


def test_probabilities_match_the_program_in_f32():
    cell = tiny_cell()
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    shapes = tc.model_shapes(task)
    task.init(params=inputs.weights(shapes, cell.config["init"], 9, "cpu"))
    req = inputs.batch(cell.traffic, cell.config, inputs.generator(9, 2, "cpu"), "cpu")
    got = task.predict_step(req)
    want = check.reference_probabilities(
        cell, inputs.weights(shapes, cell.config["init"], 9, "cpu"), [req], "cpu")
    assert check.serve_numbers([got], want)["prob_gap_max"] < 1e-5


def drive(cell) -> dict:
    run = cell.loop().run(cell, 2 ** 31 + 77, 0.5, False, time.perf_counter(),
                          torch.device("cpu"))
    return report.result(cell, run, False, torch.device("cpu"))


@pytest.fixture
def task_cls():
    from tunevlseg_torch.training.task import SegmentationTask
    return SegmentationTask


def test_sound_run_is_correct():
    assert drive(tiny_cell())["correct"] is True


def test_state_left_unchanged(task_cls, monkeypatch):
    def compile_train_multistep(self, k):
        def multi(state, batches):
            with torch.no_grad():
                loss, _ = self._loss({n: v[0] for n, v in batches.items()}, state.step,
                                     state.model_state)
            return state, {"loss": loss}
        return multi
    monkeypatch.setattr(task_cls, "compile_train_multistep", compile_train_multistep)
    res = drive(tiny_cell())
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_left_out(task_cls, monkeypatch):
    real = task_cls.compile_train_multistep

    def compile_train_multistep(self, k):
        multi = real(self, k)

        def halved(state, batches):
            b = batches["image"].shape[1] // 2
            return multi(state, {n: v if n in ("input_ids", "attention_mask")
                                 else v[:, :b] for n, v in batches.items()})
        return halved
    monkeypatch.setattr(task_cls, "compile_train_multistep", compile_train_multistep)
    assert drive(tiny_cell())["correct"] is False


def test_control_fails():
    cell = tiny_cell(dtype="bfloat16")
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    w = inputs.weights(tc.model_shapes(task), cell.config["init"], 31, "cpu")
    per_step = tc.checked_steps(cell, 31, "cpu")
    ref = check.run_reference(cell, w, per_step, "cpu")
    ctrl = check.run_reference(cell, w, per_step, "cpu", mode="fp8")
    numbers = check.train_numbers(
        check.reference_as_program(ctrl, cell.limits["checked_groups"]), ref)
    assert check.verdict(numbers, cell.limits["limits"])[0] is False


def test_work_counts_the_decoders_kernels():
    """At the cell's shapes: three K1 launches a step at 676 tokens (the
    decoder's self-attention), each with its K2; the attention pool's 169
    tokens are under the kernels' 256-token gate, the text's and the cross
    attention's carry a bias."""
    cell = cell_lib.load(CELL)
    got = work.count(cell.family, cell.config, cell.traffic["recipe"],
                     work.batch_shapes(cell), train=True)
    launches = work.kernel_launches(got["attention"])
    assert launches["K1"] == [(64, 676, 8, 64, 676, True)] * 3
    assert launches["K2"] == [(64, 676, 8, 64, 676)] * 3
    pool = [q for q, _, _, _ in got["attention"] if q[2] == 32]
    assert pool and all(q[1] == 169 for q in pool)
    assert 1.2e13 < got["flops"] < 1.6e13


def test_reference_imports_nothing_of_the_program():
    root = HERE.parents[1]
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.cris; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('tunevlseg_torch', "
            "'tunevlseg_tpu', 'jax', 'flax')]; print(bad); sys.exit(1 if bad else 0)"
            % str(root))
    subprocess.run([sys.executable, "-c", code], check=True)

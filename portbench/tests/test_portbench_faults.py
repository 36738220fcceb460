"""The correctness check sees the faults a cell can have, and the control.

A run is driven on the CPU at a tiny size (the look for a card skipped,
the program's compute in float32, so that only the planted fault moves
the numbers), with the timed path broken underneath, and `correct` has to
come out false under the cell's own limits: a step that returns its state
unchanged; half of each batch left out, the mean taken over the rest; an
answer altered where it is produced. One chip: no exchange between chips
to leave out. The control, the reference in float8 put in the program's
place, has to fail the cell's limits too."""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from portbench.harness import check, inputs, report
from portbench.loops import train_captured as tc
from portbench.tests.tiny import tiny_cell

TRAIN = ["clipseg_coop_train_b64", "clipseg_e2e_train_b64"]


def f32_cell(name, **traffic):
    cell = tiny_cell(name, **traffic)
    return dataclasses.replace(cell, config=dict(cell.config, compute_dtype="float32"))


def drive(cell) -> dict:
    run = cell.loop().run(cell, 2 ** 31 + 77, 0.5, False, time.perf_counter(),
                          torch.device("cpu"))
    return report.result(cell, run, False, torch.device("cpu"))


@pytest.fixture
def task_cls():
    from tunevlseg_torch.training.task import SegmentationTask
    return SegmentationTask


@pytest.mark.parametrize("name", TRAIN)
def test_sound_run_is_correct(name):
    cell = f32_cell(name, steps_per_group=2, groups_in_pool=3)
    assert drive(cell)["correct"] is True


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged(name, task_cls, monkeypatch):
    def compile_train_multistep(self, k):
        def multi(state, batches):
            with torch.no_grad():
                loss, _ = self._loss({n: v[0] for n, v in batches.items()}, state.step,
                                     state.model_state)
            return state, {"loss": loss}
        return multi
    monkeypatch.setattr(task_cls, "compile_train_multistep", compile_train_multistep)
    cell = f32_cell(name, steps_per_group=2, groups_in_pool=3)
    res = drive(cell)
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_left_out(name, task_cls, monkeypatch):
    real = task_cls.compile_train_multistep

    def compile_train_multistep(self, k):
        multi = real(self, k)

        def halved(state, batches):
            b = batches["image"].shape[1] // 2
            shared = "text_index" in batches
            return multi(state, {n: v if shared and n in ("input_ids", "attention_mask")
                                 else v[:, :b] for n, v in batches.items()})
        return halved
    monkeypatch.setattr(task_cls, "compile_train_multistep", compile_train_multistep)
    cell = f32_cell(name, steps_per_group=2, groups_in_pool=3)
    assert drive(cell)["correct"] is False


def test_answer_altered(monkeypatch):
    import tunevlseg_torch.serving as serving
    real = serving.task_predict_fn

    def altered(task):
        predict = real(task)
        return lambda params, batch: predict(params, batch).roll(1, 0)
    monkeypatch.setattr(serving, "task_predict_fn", altered)
    cell = f32_cell("clipseg_coop_serve_b64")
    assert drive(cell)["correct"] is False


def test_sound_serve_is_correct():
    assert drive(f32_cell("clipseg_coop_serve_b64"))["correct"] is True


@pytest.mark.parametrize("name", TRAIN)
def test_control_fails(name):
    cell = tiny_cell(name, steps_per_group=3, groups_in_pool=1)
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    shapes = tc.model_shapes(task)
    w = inputs.weights(shapes, cell.config["init"], 31, "cpu")
    per_step = tc.checked_steps(cell, 31, "cpu")
    ref = check.run_reference(cell, w, per_step, "cpu")
    ctrl = check.run_reference(cell, w, per_step, "cpu", mode="fp8")
    numbers = check.train_numbers(
        check.reference_as_program(ctrl, cell.limits["checked_groups"]), ref)
    assert check.verdict(numbers, cell.limits["limits"])[0] is False


def test_serve_control_fails():
    cell = tiny_cell("clipseg_coop_serve_b64")
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], "cpu")
    shapes = {n: tuple(v.shape) for n, v in task.model.state_dict().items()}
    w = inputs.weights(shapes, cell.config["init"], 31, "cpu")
    req = inputs.batch(cell.traffic, cell.config, inputs.generator(31, 2, "cpu"), "cpu")
    want = check.reference_probabilities(cell, w, [req], "cpu")
    ctrl = check.reference_probabilities(cell, w, [req], "cpu", mode="fp8")
    numbers = check.serve_numbers(ctrl, want)
    assert check.verdict(numbers, cell.limits["limits"])[0] is False

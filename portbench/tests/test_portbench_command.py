"""The command itself: without a card it exits non-zero and prints no
result (no fallback to the CPU); on the card a short run of the flagship
cell prints a result line that names the H100. The card test decides
inside itself whether a card is there."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def command(*args, timeout=900, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    # CUDA hidden from the child, whatever this machine holds
    got = command("--workload", "clipseg_coop_train_b64", "--seed", "2147483749",
                  "--seconds", "1", "--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""},
                  timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in got.stderr


def test_unknown_workload_fails():
    got = command("--workload", "no_such_cell", "--seed", "1", "--seconds", "1",
                  "--trace", "0", timeout=300)
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.mark.gpu
def test_flagship_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = command("--workload", "clipseg_coop_train_b64", "--seed", "2147483777",
                  "--seconds", "3", "--trace", "0")
    assert got.returncode == 0, got.stderr[-2000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["device"]["platform"] == "gpu"
    assert "H100" in line["device"]["kind"]
    assert line["correct"] is True
    assert {"setup_s", "train_images_per_s"} == set(line["metrics"])

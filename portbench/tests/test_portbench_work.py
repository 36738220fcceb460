"""The work functions: the meta-device count against FlopCounterMode over
the reference's real pass at a tiny shape, the launches found, and the
kernel bounds against the attention bench's figures."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import inputs
from portbench.reference import common as ref_common
from portbench.reference import steps as ref_steps
from portbench.tests.tiny import tiny_cell
from portbench.work import common as work


@pytest.mark.parametrize("name,train", [("clipseg_coop_train_b64", True),
                                        ("clipseg_e2e_train_b64", True),
                                        ("clipseg_coop_serve_b64", False)])
def test_meta_count_matches_a_real_pass(name, train):
    cell = tiny_cell(name)
    got = work.count(cell.family, cell.config, cell.traffic["recipe"],
                     work.batch_shapes(cell), train)
    fam = ref_steps.family(cell.family)
    model = fam.build(cell.config, cell.traffic["recipe"])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ref_common.load_weights(model, inputs.weights(shapes, cell.config["init"], 5, "cpu"))
    names = set(fam.trainable(model)) if train else set()
    for n, p in model.named_parameters():
        p.requires_grad_(n in names)
    batch = inputs.batch(dict(cell.traffic, masks=True), cell.config,
                         inputs.generator(5, 1, "cpu"), "cpu")
    with FlopCounterMode(display=False) as counter:
        logits = model(batch)
        if train:
            loss = ref_common.dice_ce_per_sample(logits, batch["mask"]).mean()
            torch.autograd.grad(loss, [p for n, p in model.named_parameters()
                                       if n in names], allow_unused=True)
    assert got["flops"] == counter.get_total_flops() > 0


def test_linear_count_by_hand():
    x = torch.empty(7, 5, 48, device="meta")
    w = torch.empty(32, 48, device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        torch.autograd.grad(ref_common.linear(x, w).sum(), [w])
    # forward 2·M·N·K, the weight's gradient as much again, no input gradient
    assert counter.get_total_flops() == 2 * (2 * 35 * 32 * 48)


def test_launches_follow_the_gate():
    calls = [((64, 485, 12, 64), (64, 485, 12, 64), False, False),
             ((64, 485, 4, 16), (64, 485, 4, 16), False, True),
             ((1, 77, 8, 64), (1, 77, 8, 64), True, True),       # text: biased, K3
             ((2, 100, 2, 8), (2, 100, 2, 8), False, True)]      # short: plain path
    got = work.kernel_launches(calls)
    assert got["K1"] == [(64, 485, 12, 64, 485, False), (64, 485, 4, 16, 485, True)]
    assert got["K2"] == [(64, 485, 4, 16, 485)]


def test_bounds_match_the_attention_bench():
    # scripts/torch_attn_bench.py at the vision shape: K1 0.0569 ms (bytes),
    # K2 0.1169 ms (operations)
    assert work.k1_bound_s(64, 485, 12, 64, 485, False) * 1e3 == pytest.approx(0.0569, abs=1e-4)
    assert work.k2_bound_s(64, 485, 12, 64, 485) * 1e3 == pytest.approx(0.1169, abs=1e-4)


def test_full_size_counts():
    cell = tiny_cell("clipseg_coop_train_b64")
    from portbench.harness import cell as cell_lib
    full = cell_lib.load("clipseg_coop_train_b64")
    w = work.cell_work(full, train=True)
    assert w["K1_launches"] == 13 and w["K2_launches"] == 3
    assert 4.5e12 < w["flops"] < 5.6e12
    assert cell.name == full.name

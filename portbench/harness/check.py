"""The comparison that decides `correct`: what the timed path produced
against the plain reference, worked out again from the same weights and
inputs, each number beside the limit of the cell (`workloads/<cell>.json`,
which names the numbers the cell compares; the others are only computed).

Training: the first `checked_groups` groups of the window's own captured
program, from the seeded start. Numbers: each group's mean loss; the
gradient's size as AdamW holds it (the square root of its second moment)
and its first moment, after the first group and after the last; each
trainable leaf's change over the groups. The per-leaf numbers go by the
worst leaf and by the median leaf: the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf. A leaf whose first gradient in the reference is under
a thousandth of the median leaf's is left out (its moments move by
round-off alone).

Serving: the probabilities of requests sampled from the seed among those the
window completed, against the reference's forward on the same inputs; the
largest and the mean absolute gap.
"""
from __future__ import annotations

import statistics

from portbench.reference import common as ref_common
from portbench.reference import steps as ref_steps

NEGLIGIBLE = 1e-3


def _norms(tensors: dict) -> dict:
    return {n: float(t.double().norm()) for n, t in tensors.items() if t is not None}


def counted_leaves(first_grad: dict) -> list:
    """The leaves whose reference first gradient is not nought to rounding."""
    norms = _norms(first_grad)
    if not norms:
        return []
    med = statistics.median(norms.values())
    return sorted(n for n, v in norms.items() if v >= NEGLIGIBLE * med)


def leaf_gaps(got: dict, want: dict, leaves: list) -> dict:
    """{leaf: gap} of each leaf's norm against the reference's, relative to
    max(its reference norm, the median leaf's)."""
    want_n = {n: float(want[n].double().norm()) for n in leaves}
    med = statistics.median(want_n.values())
    return {n: abs((float(got[n].double().norm()) if got.get(n) is not None else 0.0)
                   - want_n[n]) / max(want_n[n], med, 1e-30) for n in leaves}


def group_losses(losses: list, groups: int) -> list:
    """The mean loss of each of `groups` equal groups of steps."""
    k = len(losses) // groups
    return [statistics.fmean(losses[i * k:(i + 1) * k]) for i in range(groups)]


def train_numbers(program: dict, reference: dict) -> dict:
    """{number: value} of a program reading against the reference's: the
    first group's mean loss (and the worst of the later groups'); after the
    first group, the gradient's size as AdamW holds it (the square root of
    its second moment: each leaf's norm is the root of the steps' weighted
    squared gradient norms) and its first moment; the change after the last;
    each by the worst leaf and by the median leaf."""
    leaves = counted_leaves(reference["first_grad"])
    got = program["losses"]
    want = group_losses(reference["losses"], len(got))
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    out = {"loss_gap": gaps[0]}
    if len(gaps) > 1:
        out["loss_gap_later"] = max(gaps[1:])
    for key in ("gradnorm", "moment", "change", "gradnorm_last", "moment_last"):
        if key not in program:
            continue
        gaps = leaf_gaps(program[key], reference[key], leaves)
        out[f"{key}_gap"] = max(gaps.values())
        out[f"{key}_gap_median"] = statistics.median(gaps.values())
    return out


def reference_as_program(reference: dict, groups: int) -> dict:
    """A reference reading in the form of a program reading (the control,
    and a fault planted in the reference put in the program's place)."""
    out = {"losses": group_losses(reference["losses"], groups)}
    out.update((k, reference[k]) for k in ("gradnorm", "moment", "change",
                                           "gradnorm_last", "moment_last"))
    return out


def moments(task, state, key: str) -> dict:
    """AdamW's moment `key` of each trainable leaf, on the host, by name."""
    names = {id(p): n for n, p in task.model.named_parameters()}
    return {names[id(p)]: s[key].detach().float().to("cpu", copy=True)
            for p, s in state.optimizer.optimizer.state.items() if key in s}


def changes(task, start: dict) -> dict:
    """Each trainable leaf's change from `start`, on the host, by name."""
    return {n: (p.detach().float() - start[n].to(p.device)).cpu()
            for n, p in task.model.named_parameters() if n in start}


def checked_groups(multi, task, state, groups: list, count: int) -> tuple:
    """The first `count` groups of the pool through the window's own program
    from the seeded start: (state, reading). The reading holds each group's
    mean loss, AdamW's moments after the first group and after the last
    (the second moment as its square root), and each trainable leaf's change
    after the last."""
    start = {n: p.detach().clone() for n, p in task.model.named_parameters()
             if p.requires_grad}
    losses = []
    for i in range(count):
        state, metrics = multi(state, groups[i])
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {"moment": moments(task, state, "exp_avg"),
                     "gradnorm": {n: v.sqrt() for n, v in
                                  moments(task, state, "exp_avg_sq").items()}}
    last = {"moment_last": moments(task, state, "exp_avg"),
            "gradnorm_last": {n: v.sqrt() for n, v in
                              moments(task, state, "exp_avg_sq").items()}}
    return state, {"losses": losses, **first, **last, "change": changes(task, start)}


def run_reference(cell, weights: dict, batches: list, device, mode: str = "f32",
                  rows_per_block: int = None, half_batch: bool = False) -> dict:
    """The reference's train steps on `batches` (f32, or the control's
    precision), AdamW's moment taken after the first group; `half_batch`
    plants the fault that drops half of each batch and takes the mean over
    the rest."""
    fam = ref_steps.family(cell.family)
    recipe = cell.traffic["recipe"]
    ref_common.strict_f32()
    model = fam.build(cell.config, recipe).to(device)
    if half_batch:
        batches = [half(b) for b in batches]
    rows = rows_per_block or cell.limits["reference_rows_per_block"]
    with ref_common.precision(mode):
        out = ref_steps.train_group(
            model, weights, batches, recipe, fam.trainable(model), rows,
            moment_after=cell.traffic["steps_per_group"])
    out = {k: ({n: t.detach().float().cpu() if t is not None else None
                for n, t in v.items()} if isinstance(v, dict) else v)
           for k, v in out.items()}
    del model
    return out


def half(batch: dict) -> dict:
    """The first half of a batch's images (and their prompt rows)."""
    b = batch["image"].shape[0] // 2
    shared = "text_index" in batch
    return {k: v if shared and k in ("input_ids", "attention_mask") else v[:b]
            for k, v in batch.items()}


def serve_numbers(got: list, want: list) -> dict:
    """{number: value} over sampled requests' probabilities (host f32)."""
    gaps = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    return {"prob_gap_max": max(float(x.max()) for x in gaps),
            "prob_gap_mean": max(float(x.mean()) for x in gaps)}


def reference_probabilities(cell, weights: dict, requests: list, device,
                            mode: str = "f32") -> list:
    fam = ref_steps.family(cell.family)
    ref_common.strict_f32()
    model = fam.build(cell.config, cell.traffic["recipe"]).to(device)
    with ref_common.precision(mode):
        out = [ref_steps.probabilities(model, weights, r, cell.limits["reference_rows_per_block"]).cpu()
               for r in requests]
    del model
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) over the numbers the cell
    compares (those its limits name): each finite and at or under its
    limit."""
    table = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in table.values())
    return ok, table

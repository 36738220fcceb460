"""The work a cell's step or request needs, counted from its shapes.

The operations are those of the plain reference's forward (and, for a train
step, the gradients autograd takes for the recipe's trainable leaves),
counted by `FlopCounterMode` on the `meta` device: no data, no kernel, the
same count whatever implementation runs the step. Attention is written there
as its two products, so it counts as 4·B·H·S·T·D a forward. Only the products
the step needs are counted: the frozen towers forward only, no
recomputation, activation gradients where no weight gradient is taken.

The attention calls of that pass give the kernels' launches: an unbiased
self-attention of 256 tokens or more is K1 (the program's dispatch rule for
its bf16 kernels), and K2 where a gradient flows back into it. Each launch's
bound reads each input once and writes each output once
(`scripts/torch_attn_bench.py`'s count): K1 q, k, v and o, and the f32
log-sum-exp of each row when a gradient is wanted; K2 q, k, v, o, do, dq, dk,
dv and the log-sum-exp, over 10·B·H·S·T·D operations.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness.peaks import bound_s
from portbench.reference import common as ref_common
from portbench.reference import steps as ref_steps

K1_MIN_SEQ = 256
BF16 = 2


def meta_batch(batch_shapes: dict) -> dict:
    """{name: (shape, dtype name)} -> meta tensors."""
    return {k: torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
            for k, (shape, dtype) in batch_shapes.items()}


def count(family: str, config: dict, recipe: dict, batch_shapes: dict,
          train: bool) -> dict:
    """{"flops": a step's (or a forward's) operations, "attention": the
    attention calls (q shape, k shape, biased, gradient)} at these shapes."""
    fam = ref_steps.family(family)
    with torch.device("meta"):
        model = fam.build(config, recipe)
    names = set(fam.trainable(model)) if train else set()
    for n, p in model.named_parameters():
        p.requires_grad_(n in names)
    batch = meta_batch(batch_shapes)
    calls: list = []
    ref_common.ATTENTION_CALLS = calls
    try:
        with FlopCounterMode(display=False) as counter:
            if train:
                logits = model(batch)
                loss = ref_common.dice_ce_per_sample(logits, batch["mask"]).mean()
                leaves = [p for n, p in model.named_parameters() if n in names]
                torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                with torch.no_grad():
                    model(batch)
    finally:
        ref_common.ATTENTION_CALLS = None
    return {"flops": float(counter.get_total_flops()), "attention": calls}


def kernel_launches(attention: list) -> dict:
    """{"K1": [(B, S, H, D, T, lse)], "K2": [(B, S, H, D, T)]} of a pass."""
    k1, k2 = [], []
    for q, k, biased, grad in attention:
        b, s, h, d = q
        t = k[1]
        if biased or s != t or s < K1_MIN_SEQ:
            continue
        k1.append((b, s, h, d, t, grad))
        if grad:
            k2.append((b, s, h, d, t))
    return {"K1": k1, "K2": k2}


def k1_bound_s(b, s, h, d, t, lse) -> float:
    tensor = b * s * h * d * BF16
    return bound_s(4 * tensor + (4 * b * h * s if lse else 0), 4 * b * h * s * t * d)


def k2_bound_s(b, s, h, d, t) -> float:
    tensor = b * s * h * d * BF16
    return bound_s(7 * tensor + 4 * b * h * s, 10 * b * h * s * t * d)


def bounds(attention: list) -> dict:
    """{"K1": summed bound s, "K2": ...} and the launch counts of a pass."""
    launches = kernel_launches(attention)
    return {"K1": sum(k1_bound_s(*x) for x in launches["K1"]),
            "K2": sum(k2_bound_s(*x) for x in launches["K2"]),
            "K1_launches": len(launches["K1"]), "K2_launches": len(launches["K2"])}


def batch_shapes(cell) -> dict:
    """{name: (shape, dtype)} of one batch of the cell's mix."""
    t, c = cell.traffic, cell.config
    b, size, seq = t["batch"], c["image_size"], c["text"]["length"]
    rows = 1 if t["shared_prompt"] else b
    out = {"image": ((b, 3, size, size), "uint8"), "mask": ((b, 1, size, size), "float32"),
           "input_ids": ((rows, seq), "int32"), "attention_mask": ((rows, seq), "int32")}
    if t["shared_prompt"]:
        out["text_index"] = ((b,), "int32")
    return out


_CACHE: dict = {}


def cell_work(cell, train: bool) -> dict:
    """{"flops", "K1", "K2" (summed bound seconds), "K1_launches",
    "K2_launches"} of one step (or one request) of the cell."""
    key = (cell.name, train)
    if key not in _CACHE:
        got = count(cell.family, cell.config, cell.traffic["recipe"], batch_shapes(cell),
                    train)
        _CACHE[key] = {"flops": got["flops"], **bounds(got["attention"])}
    return _CACHE[key]

"""The reference's train steps and forward, over any family's model.

A family module (`portbench/reference/<family>.py`) gives `build(config,
recipe)` and `trainable(model)`; its model maps a batch dict to (B, 1, H, W)
logits. The batch contract is the program's: uint8 images, {0, 1} masks,
token ids and keep-masks (one row a prompt), `text_index` when prompts are
shared.
"""
from __future__ import annotations

import importlib

import torch

from portbench.reference.common import AdamW, decaying, dice_ce_per_sample, load_weights


def family(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def row_blocks(batch: dict, rows: int):
    """The batch in blocks of `rows` images; the prompt rows go whole where
    `text_index` shares them, else with their images."""
    b = batch["image"].shape[0]
    shared = "text_index" in batch
    for lo in range(0, b, rows):
        hi = min(b, lo + rows)
        yield {k: v if shared and k in ("input_ids", "attention_mask") else v[lo:hi]
               for k, v in batch.items()}


def train_group(model, weights: dict, batches: list, recipe: dict, trainable: list,
                rows_per_block: int, moment_after: int = None) -> dict:
    """The train steps of `batches` from `weights`, as the recipe sets them
    (AdamW at its rate and decay, DiceCE over the batch's mean), in blocks of
    rows whose gradients add up. Returns the steps' losses, the first step's
    gradient of each trainable leaf, AdamW's first moments and the square
    roots of its second moments after `moment_after` steps (all by
    default) and after the last step, and each leaf's change over all the
    steps."""
    moment_after = moment_after or len(batches)
    load_weights(model, weights)
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(n in trainable)
    leaves = {n: params[n] for n in trainable}
    start = {n: p.detach().clone() for n, p in leaves.items()}
    opt = AdamW(leaves, recipe["lr"],
                {n: recipe["weight_decay"] for n in decaying(model)})
    losses, first = [], None
    for i, batch in enumerate(batches):
        b = batch["image"].shape[0]
        grads = {n: None for n in leaves}
        total = 0.0
        for block in row_blocks(batch, rows_per_block):
            loss = dice_ce_per_sample(model(block), block["mask"]).sum() / b
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for n, g in zip(leaves, got):
                if g is not None:
                    grads[n] = g if grads[n] is None else grads[n] + g
            total += float(loss.detach())
        losses.append(total)
        if first is None:
            first = grads
        opt.step(grads)
        if i + 1 == moment_after:
            moment = {n: opt.m[n].clone() for n in leaves if grads[n] is not None}
            gradnorm = {n: opt.v[n].sqrt() for n in leaves if grads[n] is not None}
    return {"losses": losses,
            "first_grad": first,
            "moment": moment,
            "gradnorm": gradnorm,
            "moment_last": {n: opt.m[n] for n in moment},
            "gradnorm_last": {n: opt.v[n].sqrt() for n in moment},
            "change": {n: (p.detach() - start[n]) for n, p in leaves.items()}}


@torch.no_grad()
def probabilities(model, weights: dict, batch: dict, rows_per_block: int) -> torch.Tensor:
    """Sigmoid probabilities (B, 1, H, W) of the batch, in blocks of rows."""
    load_weights(model, weights)
    return torch.cat([torch.sigmoid(model(block).float())
                      for block in row_blocks(batch, rows_per_block)])

"""Weights and inputs drawn from the run's seed, on the device, in bulk.

The same seed gives the same weights and the same batches on every run.
Weights are one normal draw over every parameter and buffer, carved into the
model's tensors and scaled by the configuration's `init` rules; images,
masks and prompts are drawn with generators of their own, so that a longer
pool does not move the weights.
"""
from __future__ import annotations

import re

import torch

MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator of `device` for one stream of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream * 1_000_003 + 1) & MASK)
    return g


def _rule(name: str, rules: list):
    for pattern, kind, scale in rules:
        if re.search(pattern, name):
            return kind, scale
    raise KeyError(f"no init rule of the configuration matches {name!r}")


@torch.no_grad()
def weights(shapes: dict, rules: list, seed: int, device) -> dict:
    """{name: f32 tensor} for {name: shape}: one standard normal draw,
    scaled per tensor as the first matching rule says: "fan_in" (by
    1/sqrt of the product of all but the first axis), "fan_in_rows" (the
    first axis), "normal" (by the scale), "ones" (1 + scale · draw), "const"
    (the scale itself)."""
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=generator(seed, 0, device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(torch.Size(shape).numel())
        t = flat[at:at + n].view(shape)
        at += n
        kind, scale = _rule(name, rules)
        if kind == "fan_in":
            fan = max(1, n // max(1, shape[0])) if len(shape) else 1
            t.mul_(scale / fan ** 0.5)
        elif kind == "fan_in_rows":
            t.mul_(scale / shape[0] ** 0.5)
        elif kind == "normal":
            t.mul_(scale)
        elif kind == "ones":
            t.mul_(scale).add_(1.0)
        elif kind == "const":
            t.fill_(scale)
        else:
            raise ValueError(f"unknown init kind {kind!r}")
        out[name] = t
    return out


def prompt_rows(rows: int, text: dict, lengths: list, g: torch.Generator,
                device) -> tuple:
    """(ids, keep) of `rows` prompts of a tokenizer's layout: BOS, words
    drawn from the vocabulary, EOS, then padding; each prompt's length
    (BOS and EOS counted) drawn from `lengths` [low, high]."""
    seq = text["length"]
    n = torch.randint(lengths[0], lengths[1] + 1, (rows, 1), generator=g,
                      device=device)
    pos = torch.arange(seq, device=device)[None]
    words = torch.randint(text["first_word_id"], text["bos_id"], (rows, seq),
                          generator=g, device=device, dtype=torch.int64)
    ids = torch.where(pos < n, words, torch.full_like(words, text["pad_id"]))
    ids[:, 0] = text["bos_id"]
    ids.scatter_(1, n - 1, text["eos_id"])
    keep = (pos < n).to(torch.int32)
    return ids.to(torch.int32), keep


def masks(b: int, size: int, g: torch.Generator, device, cells: int = 11) -> torch.Tensor:
    """(b, 1, size, size) {0, 1} masks: blobs, a coarse normal field
    bilinearly upsampled and cut at a level of its own for each image, so
    that the foreground ranges from about 2% to about 93% of an image, as
    objects do from one image of a data set to the next."""
    field = torch.randn(b, 1, cells, cells, generator=g, device=device)
    field = torch.nn.functional.interpolate(field, size=(size, size), mode="bilinear",
                                            align_corners=False)
    level = torch.rand(b, 1, 1, 1, generator=g, device=device) * 3.5 - 1.5
    std = field.flatten(1).std(1).reshape(b, 1, 1, 1)
    return (field > level * std).float()


def batch(traffic: dict, config: dict, g: torch.Generator, device) -> dict:
    """One batch of the mix: uint8 images, masks (for training) and the
    prompts, one row a batch with `text_index` where the mix shares one."""
    b, size = traffic["batch"], config["image_size"]
    out = {"image": torch.randint(0, 256, (b, 3, size, size), generator=g,
                                  device=device, dtype=torch.uint8)}
    if traffic.get("masks", True):
        out["mask"] = masks(b, size, g, device)
    rows = 1 if traffic["shared_prompt"] else b
    ids, keep = prompt_rows(rows, config["text"], traffic["prompt_tokens"], g, device)
    out["input_ids"], out["attention_mask"] = ids, keep
    if traffic["shared_prompt"]:
        out["text_index"] = torch.zeros(b, dtype=torch.int32, device=device)
    return out


def stacked(batches: list) -> dict:
    """Batches stacked on a leading (k, ...) axis."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}

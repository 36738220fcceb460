"""The conditioned seeded weights of a CRIS configuration: the readings its
`init` rules are set from, on the card.

    python3 portbench/calibrate_init.py --out portbench/configs/cris_rn50.json

For each of seeds 11-13, the plain float32 reference (`reference/cris.py`) runs a
forward over one batch of 16 of the cell's mix, with weights drawn by the
configuration's rules, and sets each BatchNorm's running statistics, in the
order the forward reaches them, to the mean and the variance of what that
BatchNorm sees (over the batch, the positions and the channels): every
later layer then sees inputs normalised as a trained network's are. The
statistics are averaged over the seeds and printed as `const` rules by
name, first in the rules, and the configuration written with them to
`--out`. With those, seed 14 reads how near to 1 each BatchNorm's
normalised variance comes and the scale of the projector's logits and of the
residual head's; the projector's rule (`proj.txt.weight`: the logits are
linear in it) is rescaled so that its logits have std 1. Last, the program
(bf16) and the reference (f32) on the same weights and batch, no dropout:
the relative gap of C3, C4, C5', the neck, the decoder and the logits. One
JSON line a reading.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


CELL = "cris_coop_train_b64"
SEEDS, CHECK_SEED, BATCH = (11, 12, 13), 14, 16
PROJECTOR = r"proj\.txt\.weight$"


def each_batchnorm(model, batch, pre) -> None:
    """One forward without gradients, `pre(name, module, input)` called
    before each BatchNorm runs."""
    import torch
    from portbench.reference.cris import BatchNorm
    hooks = [m.register_forward_pre_hook(
        lambda module, args, name=name: pre(name, module, args[0].detach().double()))
        for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(batch)
    for h in hooks:
        h.remove()


def matched(model, batch) -> dict:
    """{BatchNorm name: (mean, var)} of one forward, each set as the
    BatchNorm's running statistics before it runs."""
    stats = {}

    def pre(name, module, x):
        stats[name] = (float(x.mean()), float(x.var(unbiased=False)))
        module.running_mean.fill_(stats[name][0])
        module.running_var.fill_(stats[name][1])

    each_batchnorm(model, batch, pre)
    return stats


def normalised(model, batch) -> dict:
    """{BatchNorm name: mean square of (x - running_mean) over the mean
    running_var} of one forward: near 1 where the statistics match."""
    out = {}

    def pre(name, module, x):
        mean = module.running_mean.double().reshape(1, -1, *[1] * (x.dim() - 2))
        out[name] = float(((x - mean) ** 2).mean() / module.running_var.double().mean())

    each_batchnorm(model, batch, pre)
    return out


def rules_with(config: dict, stats: dict) -> list:
    """The configuration's rules with `const` rules of the statistics first
    (any earlier statistics rules by name dropped)."""
    named = []
    for name, (mean, var) in stats.items():
        pattern = "^" + re.escape(name)
        named.append([pattern + r"\.running_mean$", "const", float(f"{mean:.5g}")])
        named.append([pattern + r"\.running_var$", "const", float(f"{var:.5g}")])
    rest = [r for r in config["init"] if not r[0].startswith("^")]
    return named + rest


def reference(config: dict, recipe: dict, seed: int, device):
    from portbench.harness import inputs
    from portbench.reference import common, cris
    common.strict_f32()
    model = cris.build(config, recipe).to(device)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    common.load_weights(model, inputs.weights(shapes, config["init"], seed, device))
    return model


def stage_gaps(cell, seed: int, device) -> dict:
    """The program's stage outputs against the reference's, no dropout."""
    import torch
    from portbench.harness import inputs
    from portbench.loops import train_captured as tc
    from portbench.reference import common, cris
    task = cell.port().build_task(cell.config, cell.traffic["recipe"], device)
    weights = inputs.weights(tc.model_shapes(task), cell.config["init"], seed, device)
    task.init(params=weights)
    batch = tc.pool(cell, seed, device, 1)[0]
    batch = {k: v[0] for k, v in batch.items()}
    got, want = {}, {}

    def keep(store, name):
        def hook(module, args, out):
            store[name] = [t.detach().float() for t in (out if isinstance(out, tuple)
                                                         else (out,))]
        return hook

    for store, model in ((got, task.model), (want, None)):
        if model is None:
            common.strict_f32()
            model = cris.build(cell.config, cell.traffic["recipe"]).to(device)
            common.load_weights(model, weights)
        for name in ("visual", "neck", "decoder", "proj"):
            getattr(model, name).register_forward_hook(keep(store, name))
        with torch.no_grad():
            if store is got:
                args, kw = task.model_inputs(batch)
                store["logits"] = [task.model(*args, **kw).float()]
            else:
                store["logits"] = [model(batch).float()]
    out = {}
    for name, parts in want.items():
        for i, w in enumerate(parts):
            g = got[name][i]
            label = {"visual": ("C3", "C4", "C5")[i]}.get(name, name)
            out[label] = {"gap": float((g - w).norm() / w.norm()),
                          "rms": float(w.pow(2).mean().sqrt())}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="cris_rn50")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import dataclasses
    import statistics
    import torch
    from portbench.harness import cell as cell_lib, inputs
    from portbench.run import prepare_environment
    prepare_environment()
    device = torch.device(args.device)
    cell = cell_lib.load(CELL, ROOT)
    config = json.loads((ROOT / "portbench" / "configs" / f"{args.config}.json").read_text())
    traffic = dict(cell.traffic, batch=BATCH)
    recipe = traffic["recipe"]

    def batch(seed):
        return inputs.batch(traffic, config, inputs.generator(seed, 1, device), device)

    per_seed = []
    for seed in SEEDS:
        stats = matched(reference(config, recipe, seed, device), batch(seed))
        per_seed.append(stats)
        print(json.dumps({"seed": seed, "stats": stats}), flush=True)
    mean = {n: (statistics.fmean(s[n][0] for s in per_seed),
                statistics.fmean(s[n][1] for s in per_seed)) for n in per_seed[0]}
    spread = {n: max(s[n][1] for s in per_seed) / min(s[n][1] for s in per_seed)
              for n in per_seed[0]}
    config = dict(config, init=rules_with(config, mean))

    model = reference(config, recipe, CHECK_SEED, device)
    b = batch(CHECK_SEED)
    norm = normalised(model, b)
    parts = {}
    for name in ("proj", "additive_conv2"):
        getattr(model, name).register_forward_hook(
            lambda m, a, out, name=name: parts.__setitem__(name, out.detach()))
    with torch.no_grad():
        logits = model(b)
    print(json.dumps({"seed": CHECK_SEED, "var_ratio_max": max(spread.values()),
                      "normalised": {"min": min(norm.values()), "max": max(norm.values())},
                      "pred_std": float(parts["proj"].std()),
                      "head_std": float(parts["additive_conv2"].std()),
                      "logits_std": float(logits.std()),
                      "logits_mean": float(logits.mean())}), flush=True)
    factor = 1.0 / float(parts["proj"].std())
    for rule in config["init"]:
        if rule[0] == PROJECTOR:
            rule[2] = float(f"{rule[2] * factor:.4g}")
    print(json.dumps({"projector_scale": factor}), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(config, indent=1))
    cell = dataclasses.replace(cell, config=config)
    print(json.dumps({"seed": CHECK_SEED, "stages": stage_gaps(cell, CHECK_SEED, device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

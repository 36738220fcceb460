#!/usr/bin/env python3
"""Hyperparameter sweep of the PyTorch port: the stand-in for the reference's
Optuna TPE sweeps (configs/hparams_search/*_optuna.yaml), running
`tunevlseg_torch.train` once a trial.

Counterpart of `scripts/sweep.py` with the same flags, over the port's TPE
sampler (`tunevlseg_torch/utils/tpe.py`, which asks what the JAX sampler
asks) and the same `configs/`. The search space comes from the
`configs/hparams_search/` group (`--space coop`, or a path to a yaml file);
without `--space` the builtin CoOp space is used; `--trials`, `--metric`,
`--mode` and `--seed` override the file's. `--sampler random` never leaves
the random phase. The trials run on the CUDA card: the sweep checks the
device of the composed overrides before the first trial and raises without a
card, unless the overrides ask for the CPU (`+trainer.device=cpu`). A trial
that fails is recorded as {"error": ...} and the sweep goes on.

    python3 scripts/torch_sweep.py --space coop --trials 20 \\
        -- experiment=coop/clipseg ds_name=kvasir_polyp ...

Every trial rewrites `--results` (JSON: the best trial and every trial's
params, numeric metrics, value and seconds); `main` returns the same dict.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BUILTIN_SPACE = {"metric": "test_loss", "mode": "min", "n_trials": 20,
                 "seed": 0, "n_startup": 8}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--space", default=None,
                    help="hparams_search config name (e.g. coop, shared_attn)"
                         " or a path to a yaml file")
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--metric", default=None)
    ap.add_argument("--mode", choices=("min", "max"), default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--sampler", choices=("tpe", "random"), default="tpe")
    ap.add_argument("--results", type=Path, default=Path("sweep_results.json"))
    ap.add_argument("overrides", nargs="*")
    return ap.parse_args(argv)


def main(argv: Optional[list[str]] = None,
         train_main: Optional[Callable[[list[str]], dict]] = None) -> dict:
    """Run the sweep; `train_main` (default `tunevlseg_torch.train.main`)
    takes one trial's overrides and returns its metrics."""
    args = parse_args(argv)

    from tunevlseg_torch.config.composer import compose
    from tunevlseg_torch.train import CONFIG_DIR, resolve_device
    from tunevlseg_torch.utils.tpe import (REFERENCE_SPACES, TPESampler,
                                           load_search_config)
    if train_main is None:
        from tunevlseg_torch.train import main as train_main

    # no card and no +trainer.device=cpu: raise now, not once a trial
    resolve_device(compose(CONFIG_DIR, "train", list(args.overrides)))

    if args.space:
        path = Path(args.space)
        if not path.exists():
            path = CONFIG_DIR / "hparams_search" / f"{args.space}.yaml"
        sc = load_search_config(path)
    else:
        sc = {**BUILTIN_SPACE, "spaces": REFERENCE_SPACES}
    metric = sc["metric"] if args.metric is None else args.metric
    mode = sc["mode"] if args.mode is None else args.mode
    trials = sc["n_trials"] if args.trials is None else args.trials
    seed = sc["seed"] if args.seed is None else args.seed

    sampler = TPESampler(sc["spaces"], seed=seed, mode=mode,
                         n_startup=0 if args.sampler == "random"
                         else sc["n_startup"])
    if args.sampler == "random":
        sampler.n_startup = 10 ** 9  # never leave the random phase

    results, best = [], None
    for trial in range(trials):
        params = sampler.ask()
        trial_overrides = list(args.overrides) + [
            f"{k}={v}" for k, v in params.items()
        ] + [f"exp_name=sweep_trial{trial}"]
        t0 = time.perf_counter()
        try:
            metrics = train_main(trial_overrides)
            value = metrics.get(metric)
        except Exception as e:  # a failing trial must not kill the sweep
            print(f"trial {trial} failed: {e}")
            metrics, value = {"error": str(e)}, None
        seconds = time.perf_counter() - t0
        sampler.tell(params, value)
        results.append({"trial": trial, "params": params,
                        "metrics": {k: v for k, v in metrics.items()
                                    if isinstance(v, (int, float))},
                        "value": value, "seconds": seconds})
        if "error" in metrics:
            results[-1]["error"] = metrics["error"]
        if value is not None and (
                best is None
                or (mode == "min" and value < best["value"])
                or (mode == "max" and value > best["value"])):
            best = results[-1]
        out = {"best": best, "trials": results}
        args.results.write_text(json.dumps(out, indent=2))
        print(f"trial {trial}: {metric}={value} params={params} "
              f"({seconds:.1f} s)", flush=True)
    print(f"best: {best}")
    return {"best": best, "trials": results}


if __name__ == "__main__":
    main()

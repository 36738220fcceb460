"""Tree-structured Parzen Estimator (TPE) sampler of the port: the
stand-in for the Optuna TPE sweeper the reference configures
(configs/hparams_search/*_optuna.yaml), over the same search-space grammar.

A copy of `tunevlseg_tpu/utils/tpe.py` (pure Python: `random.Random`,
`math`, `yaml`), so that the port imports nothing of the JAX package. With
the same seed and the same values told, it asks exactly what the JAX
sampler asks, floats included (`tests/test_torch_tpe_sweep.py`).

Standard TPE: split observed trials into the best gamma-quantile l(x) and the
rest g(x), model each dimension with a kernel density over observations, and
propose the candidate maximizing l(x)/g(x). Supports log-uniform floats,
uniform floats, integer ranges and categorical choices (the reference's
spaces: lr, weight_decay, prompt_depth and the learners' knobs).
"""
from __future__ import annotations

import dataclasses
import math
import random
import re
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Space:
    kind: str          # "log" | "uniform" | "int" | "choice"
    low: float = 0.0
    high: float = 1.0
    step: int = 1                       # "int" grid step (Optuna range())
    options: tuple = ()                 # "choice" values (any YAML literal)

    def sample(self, rng: random.Random):
        if self.kind == "choice":
            return self.options[rng.randrange(len(self.options))]
        if self.kind == "log":
            return math.exp(rng.uniform(math.log(self.low),
                                        math.log(self.high)))
        if self.kind == "int":
            n = (int(self.high) - int(self.low)) // self.step
            return int(self.low) + self.step * rng.randint(0, n)
        return rng.uniform(self.low, self.high)

    def to_unit(self, x) -> float:
        if self.kind == "choice":
            # categorical -> index position on the unit interval (TPE treats
            # it as ordinal, same simplification as Optuna's default KDE)
            i = self.options.index(x)
            return i / max(len(self.options) - 1, 1)
        if self.kind == "log":
            return (math.log(x) - math.log(self.low)) / \
                (math.log(self.high) - math.log(self.low))
        return (x - self.low) / (self.high - self.low)

    def from_unit(self, u: float):
        u = min(max(u, 0.0), 1.0)
        if self.kind == "choice":
            return self.options[round(u * (len(self.options) - 1))]
        if self.kind == "log":
            x = math.exp(math.log(self.low)
                         + u * (math.log(self.high) - math.log(self.low)))
            return x
        x = self.low + u * (self.high - self.low)
        if self.kind == "int":
            g = round((x - self.low) / self.step)
            return int(self.low) + self.step * g
        return x


class TPESampler:
    def __init__(self, spaces: dict[str, Space], gamma: float = 0.25,
                 n_startup: int = 8, n_candidates: int = 24,
                 seed: int = 0, mode: str = "min"):
        self.spaces = spaces
        self.gamma = gamma
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self.mode = mode
        self.trials: list[tuple[dict, float]] = []

    def tell(self, params: dict, value: Optional[float]) -> None:
        if value is not None and math.isfinite(value):
            v = value if self.mode == "min" else -value
            self.trials.append((params, v))

    def _kde_logpdf(self, obs: Sequence[float], u: float) -> float:
        """1D Gaussian KDE on the unit interval with Scott-rule bandwidth
        (plus a uniform floor so unseen regions stay reachable)."""
        n = len(obs)
        bw = max(1.06 * (n ** -0.2) * 0.25, 0.05)
        acc = 1e-12 + 0.1  # uniform floor weight
        for o in obs:
            z = (u - o) / bw
            acc += math.exp(-0.5 * z * z) / (bw * math.sqrt(2 * math.pi)) / n
        return math.log(acc)

    def ask(self) -> dict:
        if len(self.trials) < self.n_startup:
            return {k: s.sample(self.rng) for k, s in self.spaces.items()}

        ordered = sorted(self.trials, key=lambda t: t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good, bad = ordered[:n_good], ordered[n_good:]

        best_score, best = -math.inf, None
        for _ in range(self.n_candidates):
            cand = {}
            score = 0.0
            for key, space in self.spaces.items():
                good_u = [space.to_unit(p[key]) for p, _ in good]
                bad_u = [space.to_unit(p[key]) for p, _ in bad] or [0.5]
                # draw from l(x): perturb a random good observation
                center = self.rng.choice(good_u)
                u = min(max(self.rng.gauss(center, 0.12), 0.0), 1.0)
                cand[key] = space.from_unit(u)
                score += self._kde_logpdf(good_u, u) \
                    - self._kde_logpdf(bad_u, u)
            if score > best_score:
                best_score, best = score, cand
        return best


REFERENCE_SPACES = {
    # configs/hparams_search/coop_optuna.yaml:52-57
    "model.optimizer.lr": Space("log", 1e-5, 5e-3),
    "model.weight_decay": Space("log", 1e-5, 1e-2),
    "model.prompt_depth": Space("int", 1, 10),
}


def parse_space(expr: str) -> Space:
    """Parse the Optuna/Hydra sweep grammar used by the reference's
    hparams_search configs (coop_optuna.yaml:52-57):

        tag(log, interval(a, b))   log-uniform float
        interval(a, b)             uniform float
        range(a, b[, step])        integer grid [a, b) with step
        choice(v1, v2, ...)        categorical (values parsed as YAML)
    """
    import yaml

    s = expr.strip()

    def args_of(inner: str) -> list[str]:
        out, depth, cur = [], 0, ""
        for ch in inner:
            if ch == "," and depth == 0:
                out.append(cur)
                cur = ""
                continue
            depth += ch in "([{"
            depth -= ch in ")]}"
            cur += ch
        if cur.strip():
            out.append(cur)
        return [a.strip() for a in out]

    m = re.fullmatch(r"tag\(\s*log\s*,\s*interval\((.*)\)\s*\)", s)
    if m:
        lo, hi = (float(a) for a in args_of(m.group(1)))
        return Space("log", lo, hi)
    m = re.fullmatch(r"interval\((.*)\)", s)
    if m:
        lo, hi = (float(a) for a in args_of(m.group(1)))
        return Space("uniform", lo, hi)
    m = re.fullmatch(r"range\((.*)\)", s)
    if m:
        args = [int(float(a)) for a in args_of(m.group(1))]
        lo, hi = args[0], args[1]
        step = args[2] if len(args) > 2 else 1
        return Space("int", lo, hi - 1, step=step)  # python range: [a, b)
    m = re.fullmatch(r"choice\((.*)\)", s)
    if m:
        return Space("choice",
                     options=tuple(yaml.safe_load(a)
                                   for a in args_of(m.group(1))))
    raise ValueError(f"unsupported sweep space: {expr!r}")


def load_search_config(path) -> dict:
    """Load a configs/hparams_search/*.yaml file: returns
    {metric, mode, n_trials, seed, n_startup, spaces: {key: Space}}."""
    import yaml
    from pathlib import Path

    data = yaml.safe_load(Path(path).read_text())
    sampler = data.get("sampler") or {}
    return {
        "metric": data.get("optimized_metric", "val_loss"),
        "mode": {"minimize": "min", "maximize": "max"}[
            data.get("direction", "minimize")],
        "n_trials": int(data.get("n_trials", 20)),
        "seed": int(sampler.get("seed", 0)),
        "n_startup": int(sampler.get("n_startup_trials", 10)),
        "spaces": {k: parse_space(v) for k, v in data["params"].items()},
    }

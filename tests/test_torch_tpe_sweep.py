"""The port's TPE sampler (`tunevlseg_torch/utils/tpe.py`) and hparams sweep
(`scripts/torch_sweep.py`) against the JAX package's.

The sampler is pure Python in both packages, so the asks are held exactly
equal, floats included: 30 ask / tell rounds on every
`configs/hparams_search/*.yaml` space (and the builtin space, and the random
sampler), and `parse_space` on the JAX test's grammar cases. The sweep runs
in this process on `--space tiny --trials 3` over the tiny CLIPSeg on the
synthetic folder of `tests/test_torch_cli.py`, on the CPU; every trial
returns a finite `val_loss` (the space's optimized_metric), and its params
are what a JAX `TPESampler` asks when it is told the port's values."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("yaml")
pytest.importorskip("cv2")
pytest.importorskip("regex")

from tests.test_torch_cli import _common, synth  # noqa: E402,F401
from tunevlseg_torch.train import CONFIG_DIR  # noqa: E402
from tunevlseg_torch.utils import tpe as ttpe  # noqa: E402
from tunevlseg_tpu.utils import tpe as jtpe  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SPACES = sorted(p.stem for p in (CONFIG_DIR / "hparams_search").glob("*.yaml"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: the tiny models' many small ops otherwise wait on
    descheduled OpenMP threads beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep_module():
    spec = importlib.util.spec_from_file_location(
        "torch_sweep", REPO / "scripts" / "torch_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_space(a, b) -> bool:
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def _objective(params: dict, spaces: dict) -> float:
    """A deterministic value of a trial's params (the port's spaces map
    them onto the unit interval)."""
    return sum((spaces[k].to_unit(v) - 0.3) ** 2 * (i + 1)
               for i, (k, v) in enumerate(sorted(params.items())))


def _asks_equal(jsampler, tsampler, spaces, rounds=30):
    for r in range(rounds):
        want, got = jsampler.ask(), tsampler.ask()
        assert got == want, (r, got, want)
        assert [type(v) for v in got.values()] == [type(v) for v in want.values()]
        value = _objective(got, spaces)
        jsampler.tell(want, value)
        tsampler.tell(got, value)


def test_asks_equal_on_every_search_space():
    """Every hparams_search file loads alike, and the two samplers, seeded
    as the file says (the startup phase then TPE), ask exactly the same
    params over 30 rounds."""
    assert {"coop", "cocoop", "vpt", "maple", "shared_attn",
            "shared_separate", "tiny"} <= set(SPACES)
    for name in SPACES:
        path = CONFIG_DIR / "hparams_search" / f"{name}.yaml"
        jsc, tsc = jtpe.load_search_config(path), ttpe.load_search_config(path)
        assert {k: v for k, v in tsc.items() if k != "spaces"} == \
            {k: v for k, v in jsc.items() if k != "spaces"}, name
        assert list(tsc["spaces"]) == list(jsc["spaces"])
        for key in jsc["spaces"]:
            assert _same_space(tsc["spaces"][key], jsc["spaces"][key]), (name, key)
        kwargs = dict(seed=tsc["seed"], mode=tsc["mode"], n_startup=tsc["n_startup"])
        _asks_equal(jtpe.TPESampler(jsc["spaces"], **kwargs),
                    ttpe.TPESampler(tsc["spaces"], **kwargs), tsc["spaces"])


@pytest.mark.parametrize("n_startup,mode", [(8, "min"), (2, "max"), (10 ** 9, "min")],
                         ids=["builtin", "max", "random"])
def test_asks_equal_on_the_builtin_space(n_startup, mode):
    spaces = {k: ttpe.Space(**dataclasses.asdict(v))
              for k, v in jtpe.REFERENCE_SPACES.items()}
    assert all(_same_space(spaces[k], ttpe.REFERENCE_SPACES[k]) for k in spaces)
    _asks_equal(jtpe.TPESampler(jtpe.REFERENCE_SPACES, seed=3, mode=mode,
                                n_startup=n_startup),
                ttpe.TPESampler(ttpe.REFERENCE_SPACES, seed=3, mode=mode,
                                n_startup=n_startup), spaces)


@pytest.mark.parametrize("expr", [
    "tag(log, interval(1e-5, 5e-3))", "interval(0.1, 0.55)", "range(1, 11)",
    "range(32, 97, 32)", "choice(16, 20, 32)", "choice(true, false)",
    "choice([32], [64])", "choice([32], [64], [96])"])
def test_parse_space_matches_jax(expr):
    got, want = ttpe.parse_space(expr), jtpe.parse_space(expr)
    assert _same_space(got, want)
    for u in np.linspace(0.0, 1.0, 11):
        assert got.from_unit(float(u)) == want.from_unit(float(u))


def test_parse_space_rejects_what_jax_rejects():
    for parse in (ttpe.parse_space, jtpe.parse_space):
        with pytest.raises(ValueError, match="unsupported sweep space"):
            parse("weird(1, 2)")


def test_sweep_over_the_cli_matches_the_jax_sampler(synth, tmp_path):
    """`torch_sweep --space tiny --trials 3` in process: every trial's
    `val_loss` (the file's optimized_metric, which `train.main` returns as
    the reference's train returns Lightning's callback metrics) is finite,
    no trial failed, the results file holds the returned dict, and the
    recorded params are the asks of a JAX sampler told the port's values."""
    import json
    results = tmp_path / "sweep.json"
    out = _sweep_module().main([
        "--space", "tiny", "--trials", "3", "--results", str(results),
        *_common(synth, tmp_path / "logs"), "predict=false"])
    assert json.loads(results.read_text()) == json.loads(json.dumps(out))
    trials = out["trials"]
    assert len(trials) == 3
    for t in trials:
        assert "error" not in t, t
        assert math.isfinite(t["value"]) and t["value"] == t["metrics"]["val_loss"]
        assert math.isfinite(t["metrics"]["test_loss"]) and t["seconds"] > 0
    assert out["best"]["value"] == min(t["value"] for t in trials)
    sc = jtpe.load_search_config(CONFIG_DIR / "hparams_search" / "tiny.yaml")
    sampler = jtpe.TPESampler(sc["spaces"], seed=sc["seed"], mode=sc["mode"],
                              n_startup=sc["n_startup"])
    assert sc["n_startup"] < 3     # the last trial is a TPE ask
    for t in trials:
        assert sampler.ask() == t["params"]
        sampler.tell(t["params"], t["value"])
    run = tmp_path / "logs" / "train" / "sweep_trial2"
    assert (run / "checkpoints" / "best" / "state.pt").exists()


def test_a_failing_trial_is_recorded_and_the_sweep_goes_on(synth, tmp_path):
    """As `scripts/sweep.py` does: the error is kept beside the trial, its
    value is None, the sampler is told nothing, and the next trial runs."""
    calls = []

    def train_main(overrides):
        calls.append(overrides)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return {"val_loss": 0.5, "note": "text"}

    out = _sweep_module().main(
        ["--space", "tiny", "--trials", "2", "--results",
         str(tmp_path / "r.json"), "ds_name=x", "+trainer.device=cpu"],
        train_main=train_main)
    first, second = out["trials"]
    assert first["error"] == "boom" and first["value"] is None
    assert first["metrics"] == {}
    assert second["value"] == 0.5 and second["metrics"] == {"val_loss": 0.5}
    assert out["best"] is second
    assert calls[1][-1] == "exp_name=sweep_trial1"

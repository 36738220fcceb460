"""The training slice of the port as a whole against the JAX package: tiny
CLIPSeg in f32, CoOp (prompt-dedup batch, U = 1, one padded sample) and e2e
(dense prompts), the JAX `SegmentationTask.init` weights carried over by
`state_dict_from_jax`, then three `train_step`s on one batch: loss, dice,
iou, the gradient of every trainable leaf and the weights after the steps;
frozen leaves stay as they were and the unread `residual_ratio` stays 0.5.
Also the port's `collate` / `dedup_text` against the JAX package's, and the
options of the JAX task that later slices port."""
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.data import pipeline as jpipeline  # noqa: E402
from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_tpu.training.optim import merge_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (state_dict_from_jax,  # noqa: E402
                                              trainable_from_jax)
from tunevlseg_torch.data import pipeline as tpipeline  # noqa: E402
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask as TTask  # noqa: E402

LR = 1e-3
STEPS = 3
# f32 on the CPU in both packages, same formulas, other summation order:
# scalars of order 1 agree to 1e-5 (as the serving slice's loss does)
SCALAR_TOL = 1e-5
# a gradient leaf agrees to 1e-4 of its largest entry (about ten f32 layers
# of accumulated rounding, relative to the leaf's scale). A leaf whose
# gradient is zero in exact arithmetic (an attention key bias, by the
# softmax's shift invariance) holds rounding noise only, about 1e-11 here
# where the largest gradient entry of the model is about 1e-2: the floor
GRAD_REL_TOL = 1e-4
GRAD_NOISE = 1e-9
# Adam turns g into about lr * sign(g) per step, so an entry whose gradient
# is well above the rounding noise (>= 1e-2 of the leaf's largest) moves the
# same way in both and agrees to 2% of the most it can travel, STEPS * lr;
# an entry with a gradient near the noise (or below GRAD_NOISE * 100) may
# take another sign in a step, and is only held to the travel itself (both
# start from the same value)
WEIGHT_REL_TOL = 0.02
ROBUST_GRAD = 1e-2
TRAVEL = STEPS * LR * 1.05


def _samples(seed, n, img=64, prompts=1):
    rng = np.random.default_rng(seed)
    rows = rng.integers(3, 1000, size=(prompts, 12)).astype(np.int32)
    rows[:, 0] = 49406
    rows[:, 8:] = 49407
    return [{"image": rng.integers(0, 256, (3, img, img), dtype=np.uint8),
             "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
             "input_ids": rows[i % prompts],
             "attention_mask": (rows[i % prompts] != 49407).astype(np.int32),
             "prompt": f"p{i % prompts}"}
            for i in range(n)]


def _batch(strategy):
    if strategy == "coop":      # 3 samples padded to 4: valid = [1, 1, 1, 0]
        batch = tpipeline.collate(_samples(0, 3), 4, text_dedup=1)
        assert batch["input_ids"].shape == (1, 12)
        assert batch["valid"].tolist() == [1, 1, 1, 0]
    else:                       # dense prompts, every sample valid
        batch = tpipeline.collate(_samples(1, 4, prompts=4), 4)
        assert batch["input_ids"].shape == (4, 12) and "text_index" not in batch
    return tpipeline.device_batch(batch)


@pytest.fixture(scope="module", params=["coop", "e2e"])
def trained(request):
    """Three steps of both packages from the same weights on the same batch."""
    strategy = request.param
    hp = dict(learning_rate=LR, weight_decay=0.01, grad_clip_norm=0.5)
    batch = _batch(strategy)

    jmodel, jspec = jpresets.build_clipseg(strategy, prompt_depth=3,
                                           num_context=4,
                                           config=CLIPSegConfig.tiny())
    jtask = JTask(jmodel, jspec, **hp)
    jstate, frozen = jtask.init(jax.random.PRNGKey(0), batch)
    params0 = merge_params(jstate.trainable, frozen["params"])

    tmodel, tspec = tpresets.build_clipseg(strategy, prompt_depth=3,
                                           num_context=4,
                                           config=tconfig.CLIPSegConfig.tiny(),
                                           seed=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params0, tmodel))
    ttask = TTask(tmodel, tspec, **hp)
    tstate = ttask.init()
    start = copy.deepcopy(tmodel.state_dict())

    @jax.jit
    def jstep(state, frozen, batch):
        rng = jax.random.fold_in(state.rng, state.step)
        grads = jax.grad(lambda t: jtask._loss(t, state.model_state, frozen,
                                               batch, rng)[0])(state.trainable)
        return jtask.train_step(state, frozen, batch), grads

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    steps = []
    for _ in range(STEPS):
        (jstate, jmetrics), jgrads = jstep(jstate, frozen, batch)
        tstate, tmetrics = ttask.train_step(tstate, tbatch)
        tgrads = {n: p.grad.clone() for n, p in tmodel.named_parameters()
                  if p.grad is not None}
        steps.append((jmetrics, trainable_from_jax(jgrads, tmodel),
                      tmetrics, tgrads))
    return dict(strategy=strategy, steps=steps, tmodel=tmodel, tstate=tstate,
                start=start, jstate=jstate,
                want_weights=trainable_from_jax(jstate.trainable, tmodel))


def test_step_metrics_match_jax(trained):
    assert trained["tstate"].step == STEPS == int(trained["jstate"].step)
    for jmetrics, _, tmetrics, _ in trained["steps"]:
        assert set(tmetrics) == {"loss", "dice", "iou"}
        for key, value in tmetrics.items():
            assert isinstance(value, torch.Tensor) and value.dim() == 0
            np.testing.assert_allclose(value.item(), float(jmetrics[key]),
                                       atol=SCALAR_TOL, rtol=SCALAR_TOL,
                                       err_msg=key)
    first, last = (s[2]["loss"].item() for s in (trained["steps"][0],
                                                 trained["steps"][-1]))
    assert last < first


def test_every_trainable_gradient_matches_jax(trained):
    _, jgrads, _, tgrads = trained["steps"][0]
    unread = {"residual_ratio"} if trained["strategy"] == "coop" else set()
    # JAX gives an unread trainable leaf a zero gradient, torch none at all
    assert set(jgrads) - set(tgrads) == unread
    assert set(tgrads) <= set(jgrads)
    for name in unread:
        assert not jgrads[name].any()
    assert {n for n, p in trained["tmodel"].named_parameters()
            if p.requires_grad} == set(jgrads)
    for name, got in tgrads.items():
        want = jgrads[name]
        top = want.abs().max().item()
        assert (got - want).abs().max().item() <= GRAD_REL_TOL * top + GRAD_NOISE, name
    assert len(tgrads) == (1 if trained["strategy"] == "coop" else 198)


def test_weights_after_three_steps_match_jax(trained):
    tmodel, start = trained["tmodel"], trained["start"]
    grads = [s[1] for s in trained["steps"]]
    got_all = dict(tmodel.named_parameters())
    n_robust = n_total = n_moved = 0
    for name, want in trained["want_weights"].items():
        got = got_all[name].detach()
        diff = (got - want).abs()
        assert diff.max().item() <= 2 * TRAVEL, name
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust = (gmin >= ROBUST_GRAD * gtop) & (gmin > 100 * GRAD_NOISE)
        if robust.any():
            assert diff[robust].max().item() <= WEIGHT_REL_TOL * TRAVEL, name
            n_moved += int(((want - start[name]).abs()[robust] > LR).sum())
        n_robust += int(robust.sum())
        n_total += robust.numel()
    # the comparison above is not empty, and most of what it held did move by
    # more than one step's worth
    assert n_robust > (10 if trained["strategy"] == "coop" else 1000)
    assert n_moved > 0.5 * n_robust


def test_frozen_leaves_and_unread_leaf_stay(trained):
    tmodel, start = trained["tmodel"], trained["start"]
    frozen = [n for n, p in tmodel.named_parameters() if not p.requires_grad]
    for name in frozen:
        assert torch.equal(tmodel.state_dict()[name], start[name]), name
        assert dict(tmodel.named_parameters())[name].grad is None
    if trained["strategy"] == "coop":
        assert len(frozen) == 198
        # trainable, not decayed (weight_decay > 0 here), read by nothing
        assert tmodel.residual_ratio.requires_grad
        assert tmodel.residual_ratio.detach().item() == 0.5
        assert float(trained["jstate"].trainable["residual_ratio"]) == 0.5
        assert not torch.equal(tmodel.learner.context_vectors,
                               start["learner.context_vectors"])
        # the optimizer holds state for what got a gradient only
        opt = trained["tstate"].optimizer.optimizer
        assert len(opt.state) == 1
    else:
        assert frozen == []


@pytest.mark.parametrize("text_dedup,n,prompts", [(0, 4, 2), (2, 3, 2), (4, 4, 1)])
def test_collate_matches_jax(text_dedup, n, prompts):
    got = tpipeline.collate(_samples(2, n, img=32, prompts=prompts), 4,
                            text_dedup=text_dedup)
    want = jpipeline.collate(_samples(2, n, img=32, prompts=prompts), 4,
                             text_dedup=text_dedup)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value
    assert (set(tpipeline.device_batch(got))
            == set(jpipeline.device_batch(want)))
    if text_dedup:
        assert got["input_ids"].shape[0] == text_dedup
        np.testing.assert_array_equal(
            got["input_ids"][got["text_index"]],
            np.stack([s["input_ids"] for s in _samples(2, n, 32, prompts)]
                     + [_samples(2, n, 32, prompts)[-1]["input_ids"]] * (4 - n)))


def test_dedup_overflow_raises_or_falls_back_like_jax():
    for lib in (tpipeline, jpipeline):
        with pytest.raises(ValueError, match="distinct"):
            lib.collate(_samples(3, 4, img=32, prompts=3), 4, text_dedup=2)
        dense = lib.collate(_samples(3, 4, img=32, prompts=3), 4, text_dedup=2,
                            strict_dedup=False)
        assert "text_index" not in dense and dense["input_ids"].shape[0] == 4


@pytest.mark.parametrize("kw,names", [
    # accumulation and remat are ported; a window is a whole number >= 1
    (dict(accumulate_grad_batches=0), "accumulate_grad_batches"),
    (dict(accumulate_grad_batches=1.5, remat=True), "accumulate_grad_batches"),
    # "batch_stats" is carried by the train state; no other collection is
    (dict(mutable_collections=("cache",)), "batch_stats"),
], ids=["kw0-Slice G", "kw1-Slice G", "kw2-Slice C"])   # the ids they had
def test_unported_task_options_raise(kw, names):
    model, spec = tpresets.build_clipseg(
        "coop", config=tconfig.CLIPSegConfig.tiny(), device="cpu")
    with pytest.raises((NotImplementedError, ValueError), match=names):
        TTask(model, spec, **kw)
    state = TTask(model, spec, accumulate_grad_batches=2, remat=True).init()
    assert state.optimizer.accumulate_steps == 2
    # a model without buffers takes the option and carries an empty state
    state = TTask(model, spec, mutable_collections=("batch_stats",)).init()
    assert state.model_state == {}


def test_unported_compile_entry_points_raise():
    model, spec = tpresets.build_clipseg(
        "coop", config=tconfig.CLIPSegConfig.tiny(), device="cpu")
    task = TTask(model, spec)
    # the steps under DDP / fully_shard need a process group
    # (tests/test_torch_distributed.py runs them on two ranks)
    for fsdp in (False, True):
        with pytest.raises(ValueError, match="needs a process group"):
            task.compile_steps(fsdp=fsdp)
    assert task.ddp is None
    # the multi-step program runs (on the CPU as the eager steps; the JAX
    # parity and the captured graph: tests/test_torch_multistep.py)
    batch = {k: torch.from_numpy(v) for k, v in _batch("coop").items()}
    state, metrics = task.compile_train_multistep(2)(
        task.init(), {k: torch.stack([v, v]) for k, v in batch.items()})
    assert state.step == 2 and set(metrics) == {"loss", "dice", "iou"}
    assert all(torch.isfinite(v) for v in metrics.values())

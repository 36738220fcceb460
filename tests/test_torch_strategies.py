"""The five prompt strategies beyond CoOp (CoCoOp, VPT, MaPLe,
Shared-Separate, Shared-Attention) on CLIPSeg, and CoCoOp on CRIS, against
the JAX package: f32 on the CPU, `CLIPSegConfig.tiny` / `CRISConfig.tiny` at
64^2, prompt depth 3 with 4 contexts, the JAX `SegmentationTask.init` weights
carried over by `state_dict_from_jax`. Per strategy: the logits, and through
`SegmentationTask.train_step` with dropout off the loss, the gradient of
every trainable leaf (the exactly-zero q / k gradients of the
Shared-Attention projector included) and the parameters after one AdamW
step; the trainable set and the decay labels; the parameter set (what exists
only under CoCoOp, only with an applied additive head) at tiny and at full
width. Inputs are made with numpy from a seed. On the CPU every attention of
the port takes the plain path."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_tpu.models.cris import model as jcris  # noqa: E402
from tunevlseg_tpu.training import optim as joptim  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params, port_name,  # noqa: E402
                                              state_dict_from_jax,
                                              trainable_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.models.cris import model as tcris  # noqa: E402
from tunevlseg_torch.models.prompt.learners import LEARNER_REGISTRY  # noqa: E402
from tunevlseg_torch.training import optim as toptim  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask as TTask  # noqa: E402

STRATEGIES = ("cocoop", "vpt", "maple", "shared_separate", "shared_attn")
LR = 1e-3
# f32 logits through ~10 layers, summation order differs: 1e-4; the loss is a
# reduction of those logits: 1e-5 (the tolerances of the CoOp slice's tests)
LOGIT_TOL = 1e-4
SCALAR_TOL = 1e-5
# a gradient leaf agrees to 1e-4 of its largest entry; a leaf whose gradient
# is zero in exact arithmetic (attention key biases; the q and k projections
# of the Shared-Attention projector, whose softmax runs over one key) holds
# rounding noise only, or exact zeros
GRAD_REL_TOL = 1e-4
GRAD_NOISE = 1e-9
# one AdamW step moves an entry by about lr * sign(g): an entry whose gradient
# is well above the noise agrees to 2% of that travel, any entry to twice it
WEIGHT_REL_TOL = 0.02
ROBUST_GRAD = 1e-2
TRAVEL = LR * 1.05
# the tiny widths (text 16 + vision 24 = 40) do not take the preset's 16
# heads; dropout off so that the two packages' steps can be compared
OVERRIDES = {"shared_attn": dict(proj_num_heads=2, proj_dim_feedforward=16,
                                 proj_dropout=0.0)}


def _batch(dense: bool, seed=0, b=4, img=64, unique=2):
    rng = np.random.default_rng(seed)
    rows = b if dense else unique
    ids = rng.integers(3, 1000, size=(rows, 12)).astype(np.int32)
    ids[:, 0] = 49406
    ids[0, 9:] = 49407
    ids[1:, 7:] = 49407
    batch = {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
             "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != 49407).astype(np.int32),
             "valid": np.array([1] * (b - 1) + [0], np.float32)}
    if not dense:
        batch["text_index"] = (np.arange(b) % unique).astype(np.int32)
    return batch


def _one_step(jtask, jstate, frozen, ttask, batch):
    """One train step of both packages from the same weights: returns the
    JAX metrics, gradients and new trainable tree (under the port's names),
    and the port's metrics and gradients."""
    tstate = ttask.init()
    start = copy.deepcopy(ttask.model.state_dict())

    @jax.jit
    def jstep(state, frozen, batch):
        rng = jax.random.fold_in(state.rng, state.step)
        grads = jax.grad(lambda t: jtask._loss(t, state.model_state, frozen,
                                               batch, rng)[0])(state.trainable)
        return jtask.train_step(state, frozen, batch), grads

    (jstate, jmetrics), jgrads = jstep(jstate, frozen, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # the gradients as autograd gives them: the step clips them in place
    ttask._loss(tbatch, tstate.step, tstate.model_state, {})[0].backward()
    tgrads = {n: p.grad.clone() for n, p in ttask.model.named_parameters()
              if p.grad is not None}
    tstate, tmetrics = ttask.train_step(tstate, tbatch)
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, tgrads=tgrads,
                jgrads=trainable_from_jax(jgrads, ttask.model), start=start,
                want_weights=trainable_from_jax(jstate.trainable, ttask.model),
                tstate=tstate)


@pytest.fixture(scope="module", params=STRATEGIES)
def pair(request):
    """Both packages' tasks on the same weights, the logits of both, and one
    train step of both."""
    strategy = request.param
    hp = dict(learning_rate=LR, weight_decay=0.01, grad_clip_norm=0.5)
    batch = _batch(dense=strategy == "cocoop")
    kw = dict(prompt_depth=3, num_context=4,
              learner_overrides=OVERRIDES.get(strategy))
    jmodel, jspec = jpresets.build_clipseg(strategy, config=CLIPSegConfig.tiny(),
                                           **kw)
    jtask = JTask(jmodel, jspec, **hp)
    jstate, frozen = jtask.init(jax.random.PRNGKey(0), batch)
    params = joptim.merge_params(jstate.trainable, frozen["params"])
    tmodel, tspec = tpresets.build_clipseg(
        strategy, config=tconfig.CLIPSegConfig.tiny(), seed=1, device="cpu", **kw)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel))
    ttask = TTask(tmodel, tspec, **hp)
    want_logits = np.asarray(jtask._forward(params, {}, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got_logits = ttask._forward(tbatch).numpy()
    out = dict(strategy=strategy, params=params, jspec=jspec, tspec=tspec,
               tmodel=tmodel, ttask=ttask, tbatch=tbatch,
               want_logits=want_logits, got_logits=got_logits)
    out.update(_one_step(jtask, jstate, frozen, ttask, batch))
    return out


def test_logits_match_jax(pair):
    assert pair["got_logits"].shape == (4, 1, 64, 64)
    np.testing.assert_allclose(pair["got_logits"], pair["want_logits"],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_step_metrics_match_jax(pair):
    assert pair["tstate"].step == 1
    for key, value in pair["tmetrics"].items():
        np.testing.assert_allclose(value.item(), float(pair["jmetrics"][key]),
                                   atol=SCALAR_TOL, rtol=SCALAR_TOL, err_msg=key)


def _assert_gradients_close(tgrads, jgrads):
    for name, got in tgrads.items():
        want = jgrads[name]
        top = want.abs().max().item()
        assert (got - want).abs().max().item() <= GRAD_REL_TOL * top + GRAD_NOISE, name


def test_every_trainable_gradient_matches_jax(pair):
    tgrads, jgrads, model = pair["tgrads"], pair["jgrads"], pair["tmodel"]
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == set(jgrads)
    # text-only prompting applies no head and VPT adds its head without a
    # ratio: neither reads residual_ratio. JAX gives it a zero gradient,
    # torch none at all
    unread = ({"residual_ratio"} if pair["strategy"] in ("cocoop", "vpt")
              else set())
    assert set(jgrads) - set(tgrads) == unread and set(tgrads) <= set(jgrads)
    for name in unread:
        assert not jgrads[name].any()
    _assert_gradients_close(tgrads, jgrads)
    assert tgrads["learner.context_vectors"].abs().max() > 0
    if pair["strategy"] == "shared_attn":
        # attention over ONE key: the softmax is 1 whatever q and k are
        zero = [n for n in tgrads if ".self_attn.q_proj." in n
                or ".self_attn.k_proj." in n]
        assert len(zero) == 3 * 4            # 3 depths x (q, k) x (weight, bias)
        for name in zero:
            assert not tgrads[name].any() and not jgrads[name].any(), name
        assert tgrads["learner.proj_0.self_attn.v_proj.weight"].abs().max() > 0
    # nothing of the frozen towers or the decoder got a gradient
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name


def _assert_weights_close(now, want_weights, grads, start):
    n_robust = 0
    for name, want in want_weights.items():
        diff = (now[name].detach() - want).abs()
        assert diff.max().item() <= 2 * TRAVEL, name
        g = grads[name].abs()
        robust = (g >= ROBUST_GRAD * g.max().item()) & (g > 100 * GRAD_NOISE)
        if robust.any():
            assert diff[robust].max().item() <= WEIGHT_REL_TOL * TRAVEL, name
            moved = (want - start[name]).abs()[robust]
            assert (moved > 0.5 * LR).float().mean().item() > 0.5, name
        n_robust += int(robust.sum())
    return n_robust


def test_weights_after_one_step_match_jax(pair):
    model, start = pair["tmodel"], pair["start"]
    now = dict(model.named_parameters())
    assert _assert_weights_close(now, pair["want_weights"], pair["jgrads"],
                                 start) > 50
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, start[name]), name
    # the optimizer holds state for what got a gradient only
    assert len(pair["tstate"].optimizer.optimizer.state) == len(pair["tgrads"])


def test_trainable_set_and_decay_labels_equal_jax(pair):
    jspec, tspec, model = pair["jspec"], pair["tspec"], pair["tmodel"]
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    flat = flatten_params(pair["params"])
    want = sorted(port_name(p)[0] for p in flat if jspec.path_trainable(p))
    assert sorted(n for n, p in model.named_parameters() if p.requires_grad) == want
    assert all(n.startswith(("learner.", "additive_head.", "residual_ratio"))
               for n in want)
    labels = toptim.decay_labels(model)
    assert set(labels) == {port_name(p)[0] for p in flat}
    for path, leaf in flat.items():
        name, _ = port_name(path)
        assert labels[name] == joptim.decay_label(path, leaf), name
    assert labels["learner.context_vectors"] == "no_decay"


def _expected_extras(strategy):
    pooled = strategy == "cocoop"
    head = strategy not in ("coop", "cocoop")
    return pooled, head


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_full_width_parameter_set_matches_jax(strategy):
    """rd64 at 352^2 (shapes only, no compute): Flax creates a parameter only
    when its module is called, so `visual_projection`, vision layers 10-11
    and `post_layernorm` exist only under CoCoOp, `additive_head` only where
    it is applied, and `residual_ratio` wherever the preset asks for a new
    last layer; the port builds exactly that set, with the JAX shapes."""
    dense = strategy == "cocoop"
    jmodel, _ = jpresets.build_clipseg(strategy, prompt_depth=3, num_context=4)
    kwargs = {} if dense else {"text_index": jax.ShapeDtypeStruct((2,), jnp.int32)}
    rows = 2 if dense else 1
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((rows, 77), jnp.int32),
        jax.ShapeDtypeStruct((2, 3, 352, 352), jnp.float32),
        jax.ShapeDtypeStruct((rows, 77), jnp.int32), **kwargs)["params"]
    with torch.device("meta"):
        tmodel, _ = tpresets.build_clipseg(strategy, prompt_depth=3,
                                           num_context=4, device="meta")
    want = {}
    for path, leaf in flatten_params(shapes).items():
        name, transpose = port_name(path)
        want[name] = tuple(leaf.shape[::-1] if transpose else leaf.shape)
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    pooled, head = _expected_extras(strategy)
    for prefix in ("vision_model.layers.10.", "vision_model.layers.11.",
                   "vision_model.post_layernorm.", "visual_projection."):
        assert any(k.startswith(prefix) for k in got) == pooled, prefix
    assert any(k.startswith("additive_head.conv.") for k in got) == head
    assert "residual_ratio" in got
    assert "vision_model.layers.9.mlp.fc2.weight" in got


def test_dedup_equals_dense_rows_and_cocoop_refuses_dedup(pair):
    ttask, tbatch = pair["ttask"], pair["tbatch"]
    if pair["strategy"] == "cocoop":
        dedup = dict(tbatch, text_index=torch.zeros(4, dtype=torch.int32))
        with pytest.raises(ValueError, match="image-conditioned"):
            ttask.predict_step(dedup)
        return
    dense = dict(tbatch)
    idx = dense.pop("text_index").long()
    dense["input_ids"] = tbatch["input_ids"][idx]
    dense["attention_mask"] = tbatch["attention_mask"][idx]
    torch.testing.assert_close(ttask.predict_step(tbatch),
                               ttask.predict_step(dense), rtol=0, atol=2e-6)


def test_shared_attn_dropout_follows_seed_and_step():
    """The projector's dropout (0.25) is on in a train step only, and its
    masks are a function of (seed, step): the same step twice gives the same
    loss, the next step's masks differ, eval applies none."""
    model, spec = tpresets.build_clipseg(
        "shared_attn", prompt_depth=2, num_context=4,
        config=tconfig.CLIPSegConfig.tiny(), device="cpu",
        learner_overrides=dict(proj_num_heads=2, proj_dim_feedforward=16))
    assert model.learner.proj_0.dropout_rate == 0.25
    task = TTask(model, spec)
    batch = {k: torch.from_numpy(v) for k, v in _batch(dense=False).items()}
    with torch.no_grad():
        a = task._loss(batch, step=0)[0].item()
        again = task._loss(batch, step=0)[0].item()
        other = task._loss(batch, step=1)[0].item()
        stacks = model.learner()
        noisy = model.learner(deterministic=False,
                              generator=task.dropout_generator(0))
    assert a == again and a != other
    assert not torch.equal(stacks.visual, noisy.visual)
    assert torch.equal(task.predict_step(batch), task.predict_step(batch))
    with pytest.raises(ValueError, match="Generator"):
        model.learner(deterministic=False)


def test_registry_and_depth_check():
    assert set(LEARNER_REGISTRY) == {"coop", *STRATEGIES}
    cfg = tconfig.CLIPSegConfig.tiny()
    with pytest.raises(ValueError, match="prompt_depth"):
        tpresets.build_clipseg("maple", prompt_depth=5, config=cfg, device="cpu")
    assert (tpresets.default_learner_kwargs("shared_attn", cfg)
            == jpresets.default_learner_kwargs("shared_attn", CLIPSegConfig.tiny()))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_builders_default_to_the_card(strategy):
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        tpresets.build_clipseg(strategy, config=tconfig.CLIPSegConfig.tiny(),
                               learner_overrides=OVERRIDES.get(strategy))


# --- CoCoOp on CRIS ----------------------------------------------------------

@pytest.fixture(scope="module")
def cris_pair():
    rng = np.random.default_rng(3)
    ids = np.zeros((4, 12), np.int32)
    for row, n in enumerate((6, 8, 5, 9)):
        ids[row, :n] = rng.integers(1, 40000, size=n)
        ids[row, n - 1] = 49407
    batch = {"image": rng.integers(0, 256, (4, 3, 64, 64), dtype=np.uint8),
             "mask": (rng.random((4, 1, 64, 64)) > 0.5).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}
    hp = dict(learning_rate=LR, weight_decay=0.01, grad_clip_norm=0.5)
    jm, jspec = jpresets.build_cris("cocoop", prompt_depth=2, num_context=4,
                                    config=jcris.CRISConfig.tiny())
    jtask = JTask(jm, jspec, **hp)
    jstate, frozen = jtask.init(jax.random.PRNGKey(0), batch)
    # running statistics drawn at random: init's (0, 1) would hide a swap
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, size=x.shape), jnp.float32),
        frozen["batch_stats"])
    frozen = {**frozen, "batch_stats": stats}
    params = joptim.merge_params(jstate.trainable, frozen["params"])
    tm, tspec = tpresets.build_cris("cocoop", prompt_depth=2, num_context=4,
                                    config=tcris.CRISConfig.tiny(), seed=1,
                                    device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm, stats))
    ttask = TTask(tm, tspec, **hp)
    want = np.asarray(jtask._forward(params, {"batch_stats": stats}, batch))
    with torch.no_grad():
        got = ttask._forward({k: torch.from_numpy(v) for k, v in batch.items()})
    out = dict(want_logits=want, got_logits=got.numpy(), tmodel=tm, jspec=jspec,
               tspec=tspec, params=params)
    out.update(_one_step(jtask, jstate, frozen, ttask, batch))
    return out


def test_cris_cocoop_forward_matches_jax(cris_pair):
    """5e-4, the tolerance of the CRIS slice's own tests (f32, sums in
    another order through the RN50 and the head)."""
    assert cris_pair["got_logits"].shape == (4, 1, 64, 64)
    np.testing.assert_allclose(cris_pair["got_logits"], cris_pair["want_logits"],
                               atol=5e-4, rtol=5e-4)
    assert dataclasses.asdict(cris_pair["tspec"]) == dataclasses.asdict(
        cris_pair["jspec"])


def test_cris_cocoop_step_matches_jax(cris_pair):
    for key, value in cris_pair["tmetrics"].items():
        np.testing.assert_allclose(value.item(), float(cris_pair["jmetrics"][key]),
                                   atol=SCALAR_TOL, rtol=SCALAR_TOL, err_msg=key)
    tgrads, jgrads = cris_pair["tgrads"], cris_pair["jgrads"]
    assert set(tgrads) == set(jgrads)
    assert {n.split(".")[1] for n in tgrads if n.startswith("learner.")} == {
        "context_vectors", "proj_0", "proj_1"}
    assert "learner.proj_0.norm.bias" not in tgrads      # no final bias anywhere
    _assert_gradients_close(tgrads, jgrads)
    now = dict(cris_pair["tmodel"].named_parameters())
    assert _assert_weights_close(now, cris_pair["want_weights"], jgrads,
                                 cris_pair["start"]) > 50
    for name, p in now.items():
        if not p.requires_grad:
            assert torch.equal(p, cris_pair["start"][name]), name

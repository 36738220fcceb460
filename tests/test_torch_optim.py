"""The port's optimizer module (tunevlseg_torch/training/optim.py) against
the JAX package's: the trainable/frozen partition leaf by leaf, the decay
labels leaf by leaf, AdamW / SGD / global-norm clip updates against optax on
fixed numpy gradients, the adjustable learning rate, and the host-side
schedulers on one metric sequence."""
import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_tpu.training import optim as joptim  # noqa: E402
from tunevlseg_torch.convert.from_jax import flatten_params, port_name  # noqa: E402
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.nn.layers import Dense, Embed, LayerNorm  # noqa: E402
from tunevlseg_torch.training import optim as toptim  # noqa: E402

SPEC_CASES = [
    dict(),                                            # CoOp default: all frozen
    dict(freeze_all=False),                            # e2e
    dict(freeze_all=False, freeze_encoder=True),       # zero-shot surface
    dict(freeze_all=False, freeze_decoder=True),
    dict(no_freeze_last_layer=True),
    dict(no_freeze_last_layer=True, use_new_last_layer=True),
    dict(no_freeze_last_layer=True, complex_head=True),
    dict(always_trainable=("text_projection",)),
]

HAND_PATHS = [
    ("learner", "context_vectors"), ("proj", "txt", "kernel"),
    ("proj", "vis_4", "conv", "weight"), ("proj", "vis_3", "conv", "weight"),
    ("visual", "layer1", "conv1", "weight"), ("text", "layers_0", "mlp", "fc1", "kernel"),
    ("neck", "f1_v_proj", "weight"), ("decoder", "layers_1", "norm", "scale"),
    ("text_model", "layers_0", "mlp", "fc1", "kernel"),
    ("vision_model", "patch_proj"), ("visual_projection", "kernel"),
    ("upsampler", "conv", "weight"), ("residual_ratio",),
    ("additive_head", "conv1", "weight"),
]


def _jax_shapes(strategy):
    """The tiny model's param tree as shapes (no compute, no compilation)."""
    jmodel, spec = jpresets.build_clipseg(strategy, prompt_depth=3,
                                          num_context=4,
                                          config=CLIPSegConfig.tiny())
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 12), jnp.int32),
        jax.ShapeDtypeStruct((2, 3, 64, 64), jnp.float32),
        jax.ShapeDtypeStruct((1, 12), jnp.int32),
        text_index=jax.ShapeDtypeStruct((2,), jnp.int32))["params"]
    return flatten_params(shapes), spec


def _port_model(strategy):
    return tpresets.build_clipseg(strategy, prompt_depth=3, num_context=4,
                                  config=tconfig.CLIPSegConfig.tiny(),
                                  device="cpu")


@pytest.mark.parametrize("fields", SPEC_CASES)
def test_path_trainable_equals_jax_on_every_leaf(fields):
    jspec, tspec = joptim.FreezeSpec(**fields), toptim.FreezeSpec(**fields)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    n = 0
    for strategy in ("coop", None):
        flat, _ = _jax_shapes(strategy)
        model, _ = _port_model(strategy)
        names = dict(model.named_parameters())
        for path in flat:
            want = jspec.path_trainable(path)
            assert tspec.path_trainable(path) == want, path
            # and through the port's own names, as apply_freeze reads them
            name, _ = port_name(path)
            assert name in names
            assert tspec.path_trainable(toptim.param_path(name)) == want, name
            n += 1
    assert n > 300


@pytest.mark.parametrize("family", ["cris", "trans_segmentor"])
@pytest.mark.parametrize("fields", [
    dict(), dict(freeze_all=False), dict(freeze_all=False, freeze_encoder=True),
    dict(no_freeze_last_layer=True), dict(freeze_encoder=True)])
def test_path_trainable_equals_jax_on_other_families(family, fields):
    jspec = joptim.FreezeSpec(family=family, **fields)
    tspec = toptim.FreezeSpec(family=family, **fields)
    for path in HAND_PATHS:
        assert tspec.path_trainable(path) == jspec.path_trainable(path), path


@pytest.mark.parametrize("strategy", ["coop", None])
def test_presets_spec_and_apply_freeze(strategy):
    flat, jspec = _jax_shapes(strategy)
    model, tspec = _port_model(strategy)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    trainable = toptim.apply_freeze(model, tspec)
    want = sorted(port_name(p)[0] for p in flat if jspec.path_trainable(p))
    assert sorted(trainable) == want
    assert sorted(n for n, p in model.named_parameters() if p.requires_grad) == want
    n_train = toptim.count_params(p for p in model.parameters() if p.requires_grad)
    assert n_train == sum(int(np.prod(v.shape)) for p, v in flat.items()
                          if jspec.path_trainable(p))
    # no optimizer entry, so no optimizer state, for a frozen parameter
    opt = toptim.make_optimizer(model, 1e-3, weight_decay=0.01)
    assert {id(p) for p in opt.params()} == {
        id(p) for p in model.parameters() if p.requires_grad}
    if strategy == "coop":
        assert want == ["learner.context_vectors", "residual_ratio"]


@pytest.mark.parametrize("strategy", ["coop", None])
def test_decay_labels_equal_jax_leaf_by_leaf(strategy):
    flat, _ = _jax_shapes(strategy)
    model, _ = _port_model(strategy)
    labels = toptim.decay_labels(model)
    assert set(labels) == {port_name(p)[0] for p in flat}
    for path, leaf in flat.items():
        name, _ = port_name(path)
        assert labels[name] == joptim.decay_label(path, leaf), name
    # the case a rule by name and ndim would get wrong
    assert labels["text_model.token_embedding.weight"] == "no_decay"
    assert labels["vision_model.patch_proj"] == "decay"
    assert labels["decoder.head_up.weight"] == "decay"
    assert toptim.decay_label(model.decoder.head_up, "bias") == "no_decay"


class _Net(nn.Module):
    """One parameter of each kind the decay policy tells apart."""

    def __init__(self):
        super().__init__()
        self.fc = Dense(5, 3)
        self.ln = LayerNorm(3)
        self.emb = Embed(7, 3)
        self.context_vectors = nn.Parameter(torch.empty(2, 3))
        self.residual_ratio = nn.Parameter(torch.empty(()))   # nothing reads it


def _fixed_problem(seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    params = {"fc": {"kernel": arr(5, 3), "bias": arr(3)},
              "ln": {"scale": arr(3), "bias": arr(3)},
              "emb": {"embedding": arr(7, 3)},
              "context_vectors": arr(2, 3),
              "residual_ratio": np.float32(0.5)}
    grads = [jax.tree_util.tree_map(
        lambda x: (3.0 * rng.normal(size=np.shape(x))).astype(np.float32), params)
        for _ in range(3)]
    for g in grads:                      # an unread leaf: zero gradient in JAX
        g["residual_ratio"] = np.float32(0.0)
    return params, grads


def _to_port(tree):
    out = {}
    for path, leaf in flatten_params(tree).items():
        name, transpose = port_name(path)
        arr = np.asarray(leaf, np.float32)
        out[name] = torch.from_numpy(np.array(arr.T if transpose else arr))
    return out


# three steps of each optimizer on the same gradients; f32 elementwise
# arithmetic in both, so 1e-6 absolute on values of order 1
@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.0),
    dict(weight_decay=0.05),
    dict(weight_decay=0.05, grad_clip_norm=1.0),     # norm ~ 18: clip active
    dict(weight_decay=0.05, grad_clip_norm=1e3),     # clip inactive: factor 1
    dict(optimizer="sgd", grad_clip_norm=1.0),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_optimizer_steps_match_optax(kw):
    params, grads = _fixed_problem()
    tx = joptim.make_optimizer(1e-2, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    net = _Net()
    net.load_state_dict(_to_port(params))
    opt = toptim.make_optimizer(net, 1e-2, **kw)
    named = dict(net.named_parameters())

    for step, g in enumerate(grads):
        if step == 2:                    # the learning rate changes between steps
            opt_state = joptim.set_learning_rate(opt_state, 3e-3)
            toptim.set_learning_rate(opt, 3e-3)
            assert toptim.get_learning_rate(opt) == pytest.approx(
                joptim.get_learning_rate(opt_state))
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.zero_grad()
        for name, grad in _to_port(g).items():
            if name != "residual_ratio":          # torch: an unread leaf has no grad
                named[name].grad = grad.clone()
        opt.step()
        for name, want in _to_port(jparams).items():
            np.testing.assert_allclose(named[name].detach().numpy(), want.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=f"{name} step {step}")
    assert named["residual_ratio"].detach().item() == 0.5


def test_make_optimizer_groups_and_refusals():
    net = _Net()
    one = toptim.make_optimizer(net, 1e-3, weight_decay=0.0)
    assert len(one.param_groups) == 1
    two = toptim.make_optimizer(net, 1e-3, weight_decay=0.1)
    decayed = [g for g in two.param_groups if g["weight_decay"] > 0]
    assert len(two.param_groups) == 2 and len(decayed) == 1
    assert [id(p) for p in decayed[0]["params"]] == [id(net.fc.weight)]
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer(net, 1e-3, optimizer="lion")
    # gradient accumulation: a window of a whole number of micro-steps >= 1
    assert toptim.make_optimizer(net, 1e-3, accumulate_steps=4).accumulate_steps == 4
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        toptim.make_optimizer(net, 1e-3, accumulate_steps=0)


def test_clip_uses_the_optax_formula():
    """max_norm / max(norm, max_norm): exactly 1 below the threshold, and no
    1e-6 in the denominator above it."""
    g = [torch.tensor([3.0, 0.0]), torch.tensor([[0.0, 4.0]])]
    toptim.clip_by_global_norm_(g, 10.0)
    assert torch.equal(g[0], torch.tensor([3.0, 0.0]))
    toptim.clip_by_global_norm_(g, 1.0)
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.0]), rtol=1e-7, atol=0)
    torch.testing.assert_close(g[1], torch.tensor([[0.0, 0.8]]), rtol=1e-7, atol=0)


@pytest.mark.parametrize("kw", [
    dict(factor=0.5, patience=1),
    dict(factor=0.2, patience=0, cooldown=2, min_lr=1e-4),
    dict(factor=0.5, patience=1, mode="max"),
    dict(factor=0.5, patience=1, threshold_mode="abs", threshold=0.05),
])
def test_plateau_scheduler_matches_jax(kw):
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, -0.1, -0.1, -0.2]
    js, ts = joptim.ReduceLROnPlateau(**kw), toptim.ReduceLROnPlateau(**kw)
    jlr = tlr = 1e-2
    for m in metrics:
        jlr, tlr = js.step(m, jlr), ts.step(m, tlr)
        assert tlr == jlr
        assert (ts.best, ts.num_bad_epochs, ts.cooldown_counter) == (
            js.best, js.num_bad_epochs, js.cooldown_counter)
    assert tlr < 1e-2


def test_cosine_scheduler_and_registry_match_jax():
    js = joptim.CosineAnnealingLR(1e-3, 50, eta_min=1e-5)
    ts = toptim.CosineAnnealingLR(1e-3, 50, eta_min=1e-5)
    assert [ts.lr_at(i) for i in range(0, 101, 7)] == [
        js.lr_at(i) for i in range(0, 101, 7)]
    assert set(toptim.SCHEDULER_REGISTRY) == set(joptim.SCHEDULER_REGISTRY)
    assert toptim.SCHEDULER_REGISTRY["plateau"] is toptim.ReduceLROnPlateau
    assert toptim.SCHEDULER_REGISTRY["none"] is None

"""The prompt learners and their projectors, the vision tower with visual
contexts, the text tower with a per-image context stack and the additive
head, each against its Flax module (f32, CPU, narrow widths): the Flax
module's own `init` weights are carried over by `state_dict_from_jax`, the
inputs are made with numpy from a seed, outputs agree to 1e-5 for the
learners (one or two small layers) and 1e-4 for the towers (a few layers,
sums in another order). Also the parameter names and shapes per setting, and
the gradient of each learner's stacks with respect to every parameter
against `jax.grad`."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.clip import text as jtext  # noqa: E402
from tunevlseg_tpu.models.clip import vision as jvision  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_tpu.models.clipseg import decoder as jdecoder  # noqa: E402
from tunevlseg_tpu.models.prompt import learners as jl  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params, port_name,  # noqa: E402
                                              state_dict_from_jax,
                                              trainable_from_jax)
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.models.clip import text as ttext  # noqa: E402
from tunevlseg_torch.models.clip import vision as tvision  # noqa: E402
from tunevlseg_torch.models.clipseg import decoder as tdecoder  # noqa: E402
from tunevlseg_torch.models.prompt import learners as tl  # noqa: E402
from tunevlseg_torch.nn.layers import init_params  # noqa: E402

TOL = 1e-5          # one or two f32 layers
TOWER_TOL = 1e-4    # a few f32 layers, sums in another order
KEY = jax.random.PRNGKey(0)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _load(tmodule, params):
    tmodule.load_state_dict(state_dict_from_jax(params, tmodule))
    return tmodule


def _randomised(params, seed=1):
    """Flax `init` weights with every bias and norm leaf drawn at random
    (init gives zeros and ones, which would hide a dropped bias or scale)."""
    rng = _rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.1 * rng.normal(size=x.shape), x.dtype), params)


# --- projectors --------------------------------------------------------------

PROJECTORS = {
    # bare Linear: use_final_norm / use_final_bias are ignored
    "mlp-bare": ("mlp", dict(intermediate_dims=(), use_final_norm=True,
                             use_final_bias=False)),
    "mlp-hidden": ("mlp", dict(intermediate_dims=(8, 6))),
    "mlp-norm": ("mlp", dict(intermediate_dims=(8,), use_final_norm=True)),
    # CoCoOp's: a norm with a scale and no bias, `out` without a bias
    "mlp-norm-nobias": ("mlp", dict(intermediate_dims=(8,), use_final_norm=True,
                                    use_final_bias=False)),
    "mlp-nobias": ("mlp", dict(intermediate_dims=(8,), use_final_bias=False)),
    "lora": ("lora", dict(rank=4)),
    "lora-norm": ("lora", dict(rank=4, use_final_norm=True)),
    "lora-norm-nobias": ("lora", dict(rank=4, use_final_norm=True,
                                      use_final_bias=False)),
    # rank above the output width: `down` alone
    "lora-wide": ("lora", dict(rank=20, use_final_norm=True)),
}


@pytest.mark.parametrize("case", list(PROJECTORS))
def test_projector_matches_flax(case):
    kind, kw = PROJECTORS[case]
    in_dim, out_dim = 10, 12
    x = _rng(2).normal(size=(3, 4, in_dim)).astype(np.float32)
    if kind == "mlp":
        jm = jl.MLPProjector(out_dim, **kw)
        tm = tl.MLPProjector(in_dim, out_dim, **kw)
    else:
        jm = jl.LoRAProjector(out_dim, **kw)
        tm = tl.LoRAProjector(in_dim, out_dim, **kw)
    params = _randomised(jm.init(KEY, jnp.asarray(x))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x))
    # the same leaves, no more and no fewer (state_dict_from_jax raises on either)
    _load(tm, params)
    assert {port_name(p)[0] for p in flatten_params(params)} == set(tm.state_dict())
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    if case == "mlp-bare":
        assert set(tm.state_dict()) == {"out.weight", "out.bias"}
    if case == "mlp-norm-nobias":
        assert set(tm.state_dict()) == {"hidden_0.weight", "hidden_0.bias",
                                        "out.weight", "norm.weight"}


def test_projector_init_is_kaiming_for_hidden_layers():
    proj = tl.MLPProjector(512, 64, intermediate_dims=(256,), use_final_norm=True)
    init_params(proj, torch.Generator().manual_seed(0))
    # variance 2 / fan_in for the hidden layer, 1 / fan_in (LeCun) for `out`
    assert abs(proj.hidden_0.weight.std().item() - (2 / 512) ** 0.5) < 2e-3
    assert abs(proj.out.weight.std().item() - (1 / 256) ** 0.5) < 4e-3
    assert not proj.hidden_0.bias.any() and bool((proj.norm.weight == 1).all())
    assert proj.norm.eps == 1e-5


@pytest.mark.parametrize("norm_first", [True, False])
def test_transformer_projector_layer_matches_flax(norm_first):
    """(1, n, d) is (seq = 1, batch = n): attention over one key."""
    x = _rng(3).normal(size=(1, 4, 12)).astype(np.float32)
    jm = jl.TorchTransformerEncoderLayer(num_heads=3, dim_feedforward=10,
                                         dropout_rate=0.25, norm_first=norm_first)
    params = _randomised(jm.init(KEY, jnp.asarray(x))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    tm = _load(tl.TorchTransformerEncoderLayer(12, 3, 10, 0.25, norm_first), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert tm.norm1.eps == tm.norm2.eps == 1e-5


# --- learners ----------------------------------------------------------------

BASE = dict(prompt_depth=3, num_context=4)
LEARNERS = {
    "coop": ("CoOpLearner", dict(context_dim=16)),
    "vpt": ("VPTLearner", dict(context_dim=24)),
    "cocoop-unified-bare": ("CoCoOpLearner", dict(context_dim=16, visual_dim=20)),
    "cocoop-preset": ("CoCoOpLearner", dict(
        context_dim=16, visual_dim=20, norm_image_features=False,
        use_unified_projection=False, intermediate_dims=(8,), use_proj_norm=True)),
    "cocoop-lora": ("CoCoOpLearner", dict(
        context_dim=16, visual_dim=20, use_unified_projection=False,
        intermediate_dims=(4,), use_lora_proj=True)),
    "maple-unified": ("MapleLearner", dict(context_dim=16, visual_dim=24)),
    "maple-preset": ("MapleLearner", dict(
        context_dim=16, visual_dim=24, use_unified_projection=False,
        intermediate_dims=(8,), use_proj_norm=True)),
    "maple-lora": ("MapleLearner", dict(
        context_dim=16, visual_dim=24, intermediate_dims=(4,),
        use_lora_proj=True, use_proj_norm=True)),
    "shared_separate-unified": ("SharedSeparateLearner", dict(
        context_dim=8, textual_dim=16, visual_dim=24)),
    "shared_separate-preset": ("SharedSeparateLearner", dict(
        context_dim=8, textual_dim=16, visual_dim=24,
        use_unified_projection=False, use_proj_norm=True)),
    "shared_attn-unified": ("SharedAttnLearner", dict(
        context_dim=40, textual_dim=16, visual_dim=24, proj_num_heads=4,
        proj_dim_feedforward=12)),
    "shared_attn-preset": ("SharedAttnLearner", dict(
        context_dim=40, textual_dim=16, visual_dim=24,
        use_unified_projection=False, proj_num_heads=4, proj_dim_feedforward=12)),
}


def _stacks_sum(stacks, weights):
    """A scalar that every entry of both stacks enters with its own weight."""
    total = 0.0
    for stack, w in zip(stacks, weights):
        if stack is not None:
            total = total + (stack * w).sum()
    return total


@pytest.mark.parametrize("case", list(LEARNERS))
def test_learner_matches_flax(case):
    cls, kw = LEARNERS[case]
    rng = _rng(4)
    needs_image = cls == "CoCoOpLearner"
    feats = rng.normal(size=(5, 20)).astype(np.float32) if needs_image else None
    jm = getattr(jl, cls)(**BASE, **kw)
    jfeats = None if feats is None else jnp.asarray(feats)
    params = _randomised(jm.init(KEY, jfeats)["params"])
    want = jm.apply({"params": params}, jfeats)
    tm = _load(getattr(tl, cls)(**BASE, **kw), params)
    assert {port_name(p)[0] for p in flatten_params(params)} == set(tm.state_dict())
    tfeats = None if feats is None else torch.from_numpy(feats)
    got = tm(tfeats)

    assert (got.text is None) == (want.text is None) == (not tm.has_text)
    assert (got.visual is None) == (want.visual is None) == (not tm.has_visual)
    assert tm.needs_image_features == needs_image
    for g, w in zip(got, want):
        if w is not None:
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       atol=TOL, rtol=TOL)
    if needs_image:
        assert got.text.shape == (3, 5, 4, 16)          # (D, B, n, td)
    elif tm.has_text:
        assert got.text.shape == (3, 4, 16)
    if tm.has_visual:
        assert got.visual.shape == (3, 4, 24)

    # the gradient of every parameter, for one random cotangent on the stacks
    weights = [None if w is None else rng.normal(size=w.shape).astype(np.float32)
               for w in want]
    jgrads = jax.grad(lambda p: _stacks_sum(
        jm.apply({"params": p}, jfeats),
        [None if w is None else jnp.asarray(w) for w in weights]))(params)
    _stacks_sum(got, [None if w is None else torch.from_numpy(w)
                      for w in weights]).backward()
    for name, want_grad in trainable_from_jax(jgrads, tm).items():
        grad = dict(tm.named_parameters())[name].grad
        grad = torch.zeros_like(want_grad) if grad is None else grad
        top = want_grad.abs().max().item()
        assert (grad - want_grad).abs().max().item() <= 1e-4 * top + 1e-9, name
        if ".self_attn.q_proj." in name or ".self_attn.k_proj." in name:
            assert not grad.any() and not want_grad.any(), name


def test_learner_parameter_names_follow_the_projection_settings():
    def names(cls, **kw):
        return {n.split(".")[0] for n in cls(**BASE, **kw).state_dict()}

    assert names(tl.MapleLearner, context_dim=16, visual_dim=24) == {
        "context_vectors", "proj_0"}
    assert names(tl.MapleLearner, context_dim=16, visual_dim=24,
                 use_unified_projection=False) == {
        "context_vectors", "proj_0", "proj_1", "proj_2"}
    assert names(tl.SharedSeparateLearner, context_dim=8, textual_dim=16,
                 visual_dim=24, use_unified_projection=False) == {
        "context_vectors", *(f"{p}_proj_{i}" for p in ("text", "visual")
                             for i in range(3))}
    with pytest.raises(ValueError, match="textual_dim \\+ visual_dim"):
        tl.SharedAttnLearner(**BASE, context_dim=41, textual_dim=16, visual_dim=24)
    with pytest.raises(ValueError, match="pooled image features"):
        tl.CoCoOpLearner(**BASE, context_dim=16, visual_dim=20)()


# --- towers and head ---------------------------------------------------------

@pytest.mark.parametrize("prompt_depth", [1, 3])
@pytest.mark.parametrize("early_exit", [True, False])
def test_vision_tower_with_visual_contexts_matches_jax(prompt_depth, early_exit):
    """The contexts go in after the embeddings and before `pre_layernorm`;
    the trailing slots are overwritten after layer i while i < prompt_depth;
    every hidden state keeps the context tokens (17 + 4 = 21)."""
    cfg = CLIPSegConfig.tiny()
    vcfg = cfg.vision
    rng = _rng(5)
    pix = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
    ctx = rng.normal(size=(prompt_depth, 4, vcfg.hidden_size)).astype(np.float32)
    extract = (1, 2) if early_exit else cfg.extract_layers
    jm = jvision.CLIPVisionTower(vcfg)
    kw = dict(visual_ctx=jnp.asarray(ctx), prompt_depth=prompt_depth,
              extract_layers=extract, early_exit=early_exit)
    params = _randomised(jm.init(KEY, jnp.asarray(pix), **kw)["params"])
    want_hidden, want_last, want_pooled = jm.apply({"params": params},
                                                   jnp.asarray(pix), **kw)
    tvcfg = tconfig.CLIPVisionConfig(**dataclasses.asdict(vcfg))
    tm = _load(tvision.CLIPVisionTower(tvcfg, extract, early_exit), params)
    with torch.no_grad():
        hidden, last, pooled = tm(torch.from_numpy(pix), torch.from_numpy(ctx),
                                  prompt_depth)
    assert len(hidden) == len(want_hidden) and hidden[0].shape == (2, 21, 24)
    for got, want in zip(hidden, want_hidden):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOWER_TOL,
                                   rtol=TOWER_TOL)
    if prompt_depth == 3:
        # after layers 1 and 2 the trailing slots ARE the stack's rows
        for i in (1, 2):
            assert torch.equal(hidden[i][:, -4:],
                               torch.from_numpy(ctx[i]).expand(2, 4, 24))
    if early_exit:
        assert last is None and pooled is None
    else:
        np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                                   atol=TOWER_TOL, rtol=TOWER_TOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                                   atol=TOWER_TOL, rtol=TOWER_TOL)


@pytest.mark.parametrize("prompt_depth", [1, 3])
def test_text_tower_takes_a_per_image_stack(prompt_depth):
    """CoCoOp's (depth, B, n, D) stack: row b of the batch gets its own
    contexts at the splice and at every overwrite."""
    cfg = CLIPSegConfig.tiny().text
    rng = _rng(6)
    ids = rng.integers(3, 1000, size=(3, 77)).astype(np.int32)
    ids[:, 0] = 49406
    for row, pos in enumerate((9, 30, 75)):
        ids[row, pos:] = 49407
    mask = (ids != 49407).astype(np.int32)
    ctx = (0.02 * rng.normal(size=(prompt_depth, 3, 4, cfg.hidden_size))
           ).astype(np.float32)
    jargs = (jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ctx), prompt_depth)
    jm = jtext.CLIPTextTower(cfg)
    params = jm.init(KEY, *jargs)["params"]
    want_last, want_pooled = jm.apply({"params": params}, *jargs)
    tm = _load(ttext.CLIPTextTower(
        tconfig.CLIPTextConfig(**dataclasses.asdict(cfg))), params)
    with torch.no_grad():
        last, pooled = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                          torch.from_numpy(ctx), prompt_depth)
        shared, _ = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                       torch.from_numpy(ctx[:, 0]), prompt_depth)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=TOWER_TOL, rtol=TOWER_TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled),
                               atol=TOWER_TOL, rtol=TOWER_TOL)
    # row 0 saw row 0's contexts; the other rows saw their own, not row 0's
    torch.testing.assert_close(last[0], shared[0], rtol=0, atol=1e-6)
    assert (last[1] - shared[1]).abs().max() > 1e-4


@pytest.mark.parametrize("kernel_size", [5, 3])
def test_additive_head_matches_jax(kernel_size):
    cfg = CLIPSegConfig.tiny()
    feat = _rng(7).normal(size=(2, cfg.reduce_dim, 4, 4)).astype(np.float32)
    jm = jdecoder.AdditiveHead(cfg, kernel_size)
    params = jm.init(KEY, jnp.asarray(feat))["params"]
    want = jm.apply({"params": params}, jnp.asarray(feat))
    tm = _load(tdecoder.AdditiveHead(tconfig.CLIPSegConfig.tiny(), kernel_size),
               params)
    with torch.no_grad():
        got = tm(torch.from_numpy(feat))
    assert got.shape == (2, 64, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="odd kernel"):
        tdecoder.AdditiveHead(tconfig.CLIPSegConfig.tiny(), 4)


@pytest.mark.parametrize("num_visual_ctx", [0, 4])
def test_decoder_strips_the_context_tokens_after_its_blocks(num_visual_ctx):
    cfg = CLIPSegConfig.tiny()
    rng = _rng(8)
    tokens = 17 + num_visual_ctx
    acts = [rng.normal(size=(2, tokens, cfg.vision.hidden_size)).astype(np.float32)
            for _ in cfg.extract_layers]
    cond = rng.normal(size=(2, cfg.projection_dim)).astype(np.float32)
    jm = jdecoder.CLIPSegDecoder(cfg)
    jargs = ([jnp.asarray(a) for a in acts], jnp.asarray(cond), num_visual_ctx)
    params = jm.init(KEY, *jargs)["params"]
    want_logits, want_feat = jm.apply({"params": params}, *jargs)
    tm = _load(tdecoder.CLIPSegDecoder(tconfig.CLIPSegConfig.tiny()), params)
    with torch.no_grad():
        logits, feat = tm([torch.from_numpy(a) for a in acts],
                          torch.from_numpy(cond), num_visual_ctx)
    assert feat.shape == (2, cfg.reduce_dim, 4, 4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(want_feat),
                               atol=TOWER_TOL, rtol=TOWER_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=TOWER_TOL, rtol=TOWER_TOL)

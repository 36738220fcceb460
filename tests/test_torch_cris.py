"""The CRIS slice of the port against the JAX package, f32 on the CPU: each
module that the slice adds (conv2d / Conv2d, resize_2d, BatchNorm with
running statistics, ModifiedResNet, FPN, the decoder, the projector, the
text transformer) on the JAX module's own `init` weights carried over by
`state_dict_from_jax`, then the whole model (e2e, CoOp at depth 1 and 3, with
prompt dedup), the trainable set, one CoOp train step (loss and every
gradient), the weights after three steps, and the dropout masks' (seed, step)
rule. Sizes are `CRISConfig.tiny` at 64^2. On the CPU every attention of the
port takes the plain path."""
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
from tunevlseg_tpu.models.cris import layers as jlayers  # noqa: E402
from tunevlseg_tpu.models.cris import model as jmodel  # noqa: E402
from tunevlseg_tpu.models.cris import resnet as jresnet  # noqa: E402
from tunevlseg_tpu.nn import conv as jconv  # noqa: E402
from tunevlseg_tpu.ops import image as jimage  # noqa: E402
from tunevlseg_tpu.training.optim import merge_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params, port_name,  # noqa: E402
                                              state_dict_from_jax,
                                              trainable_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.cris import layers as tlayers  # noqa: E402
from tunevlseg_torch.models.cris import model as tmodel  # noqa: E402
from tunevlseg_torch.models.cris import resnet as tresnet  # noqa: E402
from tunevlseg_torch.nn import conv as tconv  # noqa: E402
from tunevlseg_torch.nn.layers import init_params  # noqa: E402
from tunevlseg_torch.ops import image as timage  # noqa: E402
from tunevlseg_torch.serving import task_predict_fn  # noqa: E402
from tunevlseg_torch.training import optim as toptim  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask as TTask  # noqa: E402

# f32 on the CPU in both packages, the same formulas, sums in another order
# (the tolerance of tests/test_cris_parity.py)
TOL = 5e-4
KEY = jax.random.PRNGKey(0)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _random_stats(variables, seed=7):
    """A JAX variable dict with its BatchNorm running statistics drawn at
    random (init gives mean 0, var 1, which would hide a swapped pair)."""
    rng = _rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, size=x.shape), jnp.float32),
        variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(
        variables["params"], module, variables.get("batch_stats")))
    return module


# --- conv2d / Conv2d --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(stride=1, padding=0),
    dict(stride=2, padding=1),
    dict(padding="same"),
    dict(padding="same", pad_mode="replicate"),
    dict(padding=2, pad_mode="reflect"),
    dict(padding=1, dilation=2),
    dict(padding=1, groups=2),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("k", [3, 4])
def test_conv2d_matches_jax(kw, k):
    rng = _rng(0)
    groups = kw.get("groups", 1)
    x = rng.normal(size=(2, 4, 9, 10)).astype(np.float32)
    w = rng.normal(size=(6, 4 // groups, k, k)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = tconv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), **kw)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=1, use_bias=False),
    dict(kernel_size=3, stride=2, padding=1, use_bias=False),
    dict(kernel_size=5, padding="same", pad_mode="replicate"),
])
def test_conv2d_module_matches_jax(kw):
    x = _rng(1).normal(size=(2, 4, 8, 8)).astype(np.float32)
    jm = jconv.Conv2d(4, 3, **kw)
    variables = jm.init(KEY, jnp.asarray(x))
    tkw = {("bias" if key == "use_bias" else key): v for key, v in kw.items()}
    tm = _load(tconv.Conv2d(4, 3, **tkw), variables)
    _close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)), 1e-5)
    # torch's conv init from the explicit generator: U(-b, b), b = fan_in^-1/2
    init_params(tm, torch.Generator().manual_seed(0))
    bound = (4 * tm.weight.shape[2] * tm.weight.shape[3]) ** -0.5
    assert tm.weight.abs().max().item() <= bound
    assert tm.weight.abs().max().item() > 0.5 * bound
    constant = tconv.Conv2d(4, 3, 1, bias_init_value=0.25)
    init_params(constant, torch.Generator().manual_seed(0))
    assert bool((constant.bias == 0.25).all())


# --- resize_2d --------------------------------------------------------------

@pytest.mark.parametrize("out_pad", [0, 2])
@pytest.mark.parametrize("method,align_corners", [
    ("bilinear", False), ("bilinear", True), ("bicubic", False),
    ("bicubic", True), ("nearest", False)])
def test_resize_2d_matches_jax(method, align_corners, out_pad):
    img = _rng(2).normal(size=(2, 3, 7, 5)).astype(np.float32)
    want = jimage.resize_2d(jnp.asarray(img), (13, 12), method,
                            align_corners=align_corners, out_pad=out_pad)
    got = timage.resize_2d(torch.from_numpy(img), (13, 12), method,
                           align_corners=align_corners, out_pad=out_pad)
    assert got.shape == (2, 3, 13 + 2 * out_pad, 12 + 2 * out_pad)
    _close(got, want, 1e-5)


def test_resize_2d_edges_and_upsample_scale():
    img = torch.from_numpy(_rng(3).normal(size=(2, 6, 6)).astype(np.float32))
    assert timage.resize_2d(img, (6, 6)) is img
    padded = timage.resize_2d(img, (6, 6), out_pad=1)     # pad only
    assert padded.shape == (2, 8, 8)
    assert torch.equal(padded[:, 1:-1, 1:-1], img)
    assert torch.equal(padded[:, 0, 1:-1], img[:, 0])
    _close(timage.upsample_scale(img, 2),
           jimage.upsample_scale(jnp.asarray(img.numpy()), 2, "bilinear"), 1e-5)
    with pytest.raises(ValueError, match="unknown resize mode"):
        timage.resize_2d(img, (3, 3), "lanczos")
    half = timage.resize_2d(img.bfloat16(), (9, 9), "bicubic")
    assert half.dtype == torch.bfloat16


# --- BatchNorm --------------------------------------------------------------

@pytest.mark.parametrize("cls,shape", [("BatchNorm2d", (3, 5, 4, 4)),
                                       ("BatchNorm1d", (6, 5))])
def test_batchnorm_running_statistics_match_jax(cls, shape):
    x = _rng(4).normal(size=shape).astype(np.float32)
    jm = getattr(jresnet, cls)(5, use_running_average=True)
    variables = _random_stats(jm.init(KEY, jnp.asarray(x)))
    rng = _rng(5)
    variables["params"] = {k: jnp.asarray(rng.normal(size=(5,)), jnp.float32)
                           for k in ("weight", "bias")}
    tm = _load(getattr(tresnet, cls)(5), variables)
    want = jm.apply(variables, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), want, 1e-5)
    # nn.Module.train() does not switch it to batch statistics
    tm.train()
    _close(tm(torch.from_numpy(x)), want, 1e-5)
    assert set(dict(tm.named_buffers())) == {"running_mean", "running_var"}
    # statistics and affine in f32, one rounding to the input's dtype
    half = tm(torch.from_numpy(x).bfloat16())
    assert half.dtype == torch.bfloat16
    _close(half.float(), want, 2e-2)
    with pytest.raises(NotImplementedError, match="Slice C"):
        getattr(tresnet, cls)(5, use_running_average=False)(torch.from_numpy(x))


# --- the towers and the head, module by module -------------------------------

def test_modified_resnet_matches_jax():
    kw = dict(layers=(1, 2, 1, 1), output_dim=24, heads=8, input_resolution=64,
              width=16)
    x = _rng(6).normal(size=(2, 3, 96, 96)).astype(np.float32)   # resizes pos
    jm = jresnet.ModifiedResNet(**kw)
    variables = _random_stats(jm.init(KEY, jnp.asarray(x)))
    tm = _load(tresnet.ModifiedResNet(**kw), variables)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 128, 12, 12), (2, 256, 6, 6),
                                             (2, 24, 3, 3)]
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(NotImplementedError, match="K4"):
        tresnet.ModifiedResNet(layout="flat", **kw)
    with pytest.raises(ValueError, match="TPU layout experiment"):
        tresnet.ModifiedResNet(layout="nhwc", **kw)


def _pyramid(rng, b=2):
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, 12, 8, 8), (b, 10, 4, 4), (b, 8, 2, 2))]


def test_fpn_matches_jax():
    rng = _rng(8)
    feats, state = _pyramid(rng), rng.normal(size=(2, 8)).astype(np.float32)
    jm = jlayers.FPN((12, 10, 8), (6, 8, 10))
    variables = _random_stats(jm.init(KEY, [jnp.asarray(f) for f in feats],
                                      jnp.asarray(state)))
    tm = _load(tlayers.FPN((12, 10, 8), (6, 8, 10)), variables)
    want = jm.apply(variables, [jnp.asarray(f) for f in feats], jnp.asarray(state))
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats], torch.from_numpy(state))
    assert got.shape == (2, 8, 4, 4)
    _close(got, want)


def test_decoder_matches_jax():
    rng = _rng(9)
    fq = rng.normal(size=(2, 16, 5, 6)).astype(np.float32)
    txt = rng.normal(size=(2, 9, 16)).astype(np.float32)
    pad = np.zeros((2, 9), bool)
    pad[0, 6:] = pad[1, 4:] = True
    jm = jlayers.CRISTransformerDecoder(2, 16, 2, 24, dropout=0.1)
    variables = jm.init(KEY, jnp.asarray(fq), jnp.asarray(txt), jnp.asarray(pad))
    tm = _load(tlayers.CRISTransformerDecoder(2, 16, 2, 24, dropout=0.1), variables)
    want = jm.apply(variables, jnp.asarray(fq), jnp.asarray(txt), jnp.asarray(pad))
    with torch.no_grad():
        got = tm(torch.from_numpy(fq), torch.from_numpy(txt), torch.from_numpy(pad))
    _close(got, want)
    # padded text tokens are not attended to
    txt2 = txt.copy()
    txt2[0, 6:] = 50.0
    with torch.no_grad():
        again = tm(torch.from_numpy(fq), torch.from_numpy(txt2),
                   torch.from_numpy(pad))
    _close(again[0], got[0], 1e-6)
    np.testing.assert_array_equal(tlayers.sincos_pos_2d(16, 5, 6),
                                  jlayers.sincos_pos_2d(16, 5, 6))
    np.testing.assert_array_equal(tlayers.sincos_pos_1d(16, 9),
                                  jlayers.sincos_pos_1d(16, 9))
    coords = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    _close(tlayers.add_coords(torch.from_numpy(coords)),
           jlayers.add_coords(jnp.asarray(coords)), 1e-6)


def test_projector_matches_jax():
    rng = _rng(10)
    x = rng.normal(size=(3, 16, 4, 4)).astype(np.float32)
    word = rng.normal(size=(3, 12)).astype(np.float32)
    jm = jlayers.Projector(12, 8, 3)
    variables = _random_stats(jm.init(KEY, jnp.asarray(x), jnp.asarray(word)))
    tm = _load(tlayers.Projector(12, 8, 3), variables)
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(word))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(word))
    assert got.shape == (3, 1, 16, 16)
    _close(got, want)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_dynamic_conv_is_the_grouped_convolution(k):
    """The projector's tap-product formulation against the reference's
    `F.conv2d(groups=B)` (f32: 1e-5) and its gradients."""
    rng = _rng(12)
    x, w, b = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .requires_grad_() for s in ((3, 5, 7, 6), (3, 5, k, k), (3,)))
    got = tlayers.dynamic_conv(x, w, b)
    want = torch.nn.functional.conv2d(x.reshape(1, 15, 7, 6), w, b,
                                      padding=k // 2, groups=3).transpose(0, 1)
    assert got.shape == (3, 1, 7, 6)
    _close(got, want.detach(), 1e-5)
    g = torch.from_numpy(rng.normal(size=(3, 1, 7, 6)).astype(np.float32))
    for a, e in zip(torch.autograd.grad(got, (x, w, b), g),
                    torch.autograd.grad(want, (x, w, b), g)):
        _close(a, e, 1e-5)


def test_backbone_follows_its_weights_memory_format():
    """`build_cris` stores the backbone's 4-D weights channels-last and the
    backbone then keeps its activations so; shapes, names and results are
    those of the contiguous model."""
    model, _ = tpresets.build_cris("coop", config=tmodel.CRISConfig.tiny(),
                                   device="cpu")
    x = torch.from_numpy(_rng(13).normal(size=(2, 3, 64, 64)).astype(np.float32))
    cl = torch.channels_last
    assert model.visual.conv1.weight.is_contiguous(memory_format=cl)
    assert model.neck.f2_v_proj.conv.weight.is_contiguous()
    with torch.no_grad():
        c3, c4, c5 = model.visual(x)
        assert c3.is_contiguous(memory_format=cl) and c3.shape == (2, 128, 8, 8)
        names = set(model.state_dict())
        model.to(memory_format=torch.contiguous_format)
        d3, d4, d5 = model.visual(x)
    assert d3.is_contiguous() and set(model.state_dict()) == names
    for a, b in ((c3, d3), (c4, d4), (c5, d5)):
        _close(a, b, 1e-5)


def _ids(rng, rows, seq=12, vocab=49408):
    """CLIP-style ids with 0 padding: BOS, words, EOS (the largest id), pads."""
    ids = rng.integers(3, 1000, size=(rows, seq)).astype(np.int32)
    ids[:, 0] = vocab - 2
    for r in range(rows):
        eos = seq - 3 - 2 * r
        ids[r, eos] = vocab - 1
        ids[r, eos + 1:] = 0
    return ids


@pytest.mark.parametrize("depth,seq", [(0, 12), (1, 12), (3, 12), (2, 77)])
def test_text_transformer_matches_jax(depth, seq):
    """depth 0: no contexts. With contexts the overwrite runs after block i
    for the 0-BASED i < depth: depth 1 re-injects ctx[0] after block 0. At 77
    tokens the splice clips to the context length, and the pooled index is
    clamped to 76."""
    cfg = jmodel.CRISConfig.tiny()
    rng = _rng(11)
    ids = _ids(rng, 2, seq)
    if seq == 77:
        ids[0, -1] = cfg.vocab_size - 1     # EOS at the very end: clamped
    num_ctx = 4 if depth else 0
    pad = np.concatenate([np.zeros((2, num_ctx), bool), ids == 0],
                         axis=1)[:, :cfg.context_length]
    ctx = (rng.normal(size=(max(depth, 1), 4, 24)).astype(np.float32)
           if depth else None)
    jm = jmodel.CLIPTextTransformer(cfg)
    kw = dict(prompt_depth=depth, max_length=cfg.context_length)
    jctx = None if ctx is None else jnp.asarray(ctx)
    variables = jm.init(KEY, jnp.asarray(ids), jnp.asarray(pad), jctx, **kw)
    tm = _load(tmodel.CLIPTextTransformer(tmodel.CRISConfig.tiny()), variables)
    want = jm.apply(variables, jnp.asarray(ids), jnp.asarray(pad), jctx, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(pad),
                 None if ctx is None else torch.from_numpy(ctx), **kw)
    assert got[0].shape == (2, min(seq + num_ctx, 77), 24)
    for g, w in zip(got, want):
        _close(g, w)
    if depth == 1:
        # the quirk: after block 0 the context slots hold ctx[0] again, so a
        # port with CLIPSeg's 1-based loop (no overwrite at depth 1) differs
        with torch.no_grad():
            other = tm(torch.from_numpy(ids), torch.from_numpy(pad),
                       torch.from_numpy(ctx), prompt_depth=0,
                       max_length=cfg.context_length)
        assert (other[1] - got[1]).abs().max().item() > 1e-3


# --- the slice as a whole ----------------------------------------------------

def _batch(seed=0, b=4, unique=2, img=64):
    rng = _rng(seed)
    ids = _ids(rng, unique)
    return {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
            "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "valid": np.array([1] * (b - 1) + [0], np.float32),
            "text_index": (np.arange(b) % unique).astype(np.int32)}


def _pair(strategy, depth, **task_kw):
    """The JAX task and the port's on the same weights: JAX `init`, random
    running statistics, carried over by `state_dict_from_jax`."""
    batch = _batch()
    jm, jspec = jpresets.build_cris(strategy, prompt_depth=depth, num_context=4,
                                    config=jmodel.CRISConfig.tiny())
    jtask = JTask(jm, jspec, **task_kw)
    jstate, frozen = jtask.init(KEY, batch)
    frozen = {**frozen, "batch_stats": _random_stats(frozen)["batch_stats"]}
    params = merge_params(jstate.trainable, frozen["params"])
    tm, tspec = tpresets.build_cris(strategy, prompt_depth=depth, num_context=4,
                                    config=tmodel.CRISConfig.tiny(), seed=1,
                                    device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, tm, frozen["batch_stats"]))
    return jtask, jstate, frozen, params, TTask(tm, tspec, **task_kw), batch


@pytest.mark.parametrize("strategy,depth", [("e2e", 1), ("coop", 1), ("coop", 3)])
def test_cris_slice_matches_jax(strategy, depth):
    jtask, jstate, frozen, params, ttask, batch = _pair(strategy, depth)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    extras = {"batch_stats": frozen["batch_stats"]}
    want = np.asarray(jtask._forward(params, extras, batch))
    with torch.no_grad():
        got = ttask._forward(tbatch)
    assert got.shape == (4, 1, 64, 64)
    _close(got, want)
    probs = ttask.predict_step(tbatch)
    _close(probs, jtask.predict_step(jstate, frozen, batch))
    # the serving function takes parameters and buffers alike
    served = task_predict_fn(ttask)(dict(ttask.model.state_dict()), tbatch)
    torch.testing.assert_close(served, probs, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="running_mean"):
        task_predict_fn(ttask)(dict(ttask.model.named_parameters()), tbatch)
    # prompt dedup equals the dense call
    dense = dict(tbatch)
    idx = dense.pop("text_index").long()
    dense["input_ids"] = tbatch["input_ids"][idx]
    dense["attention_mask"] = tbatch["attention_mask"][idx]
    torch.testing.assert_close(ttask.predict_step(dense), probs, rtol=0, atol=2e-6)
    # without an attention mask the pad mask is ids == 0: the same here
    no_mask = {k: v for k, v in tbatch.items() if k != "attention_mask"}
    torch.testing.assert_close(ttask.predict_step(no_mask), probs, rtol=0, atol=0)


@pytest.mark.parametrize("strategy,kw", [
    ("coop", {}), ("coop", dict(no_freeze_last_layer=True, use_new_last_layer=False)),
    ("e2e", {}), ("e2e", dict(freeze_encoder=False))])
def test_trainable_set_and_decay_labels_match_jax(strategy, kw):
    from tunevlseg_tpu.training import optim as joptim
    cfg = jmodel.CRISConfig.tiny()
    batch = _batch()
    jm, jspec = jpresets.build_cris(strategy, prompt_depth=2, config=cfg, **kw)
    params = jm.init(KEY, batch["input_ids"], batch["image"].astype(np.float32),
                     batch["attention_mask"], text_index=batch["text_index"])["params"]
    tm, tspec = tpresets.build_cris(strategy, prompt_depth=2,
                                    config=tmodel.CRISConfig.tiny(), device="cpu",
                                    **kw)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    flat = flatten_params(params)
    # every JAX leaf has its port parameter, and the other way round
    assert {port_name(p)[0] for p in flat} == set(dict(tm.named_parameters()))
    want_trainable = {port_name(p)[0] for p in flat if jspec.path_trainable(p)}
    assert set(toptim.apply_freeze(tm, tspec)) == want_trainable
    assert want_trainable
    want_labels = {port_name(p)[0]: joptim.decay_label(p, v) for p, v in flat.items()}
    assert toptim.decay_labels(tm) == want_labels
    assert want_labels["visual.conv1.weight"] == "decay"
    assert want_labels["visual.bn1.weight"] == "no_decay"
    assert want_labels["text.text_projection"] == "no_decay"


LR, STEPS = 1e-3, 3
TRAVEL = STEPS * LR * 1.05


@pytest.fixture(scope="module")
def trained():
    """Three CoOp steps of both packages from the same weights on one batch
    (dropout 0 in the tiny config; U = 2 prompt rows, one padded sample)."""
    hp = dict(learning_rate=LR, weight_decay=0.01, grad_clip_norm=0.5)
    jtask, jstate, frozen, _, ttask, batch = _pair("coop", 3, **hp)
    tstate = ttask.init()
    start = copy.deepcopy(ttask.model.state_dict())

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
        tgrads = {n: p.grad.clone() for n, p in ttask.model.named_parameters()
                  if p.grad is not None}
        steps.append((jmetrics, trainable_from_jax(jgrads, ttask.model),
                      tmetrics, tgrads))
    return dict(steps=steps, model=ttask.model, tstate=tstate, start=start,
                want_weights=trainable_from_jax(jstate.trainable, ttask.model))


def test_coop_train_step_loss_and_gradients_match_jax(trained):
    """Loss, dice and iou within 1e-5; every gradient within 1e-4 of its
    largest entry (f32, about ten layers of accumulated rounding)."""
    for jmetrics, _, tmetrics, _ in trained["steps"]:
        for key, value in tmetrics.items():
            np.testing.assert_allclose(value.item(), float(jmetrics[key]),
                                       atol=1e-5, rtol=1e-5, err_msg=key)
    _, jgrads, _, tgrads = trained["steps"][0]
    assert set(tgrads) == set(jgrads) == {
        "learner.context_vectors", "additive_conv1.weight",
        "additive_conv2.weight", "additive_conv2.bias", "residual_ratio"}
    for name, got in tgrads.items():
        want = jgrads[name]
        top = want.abs().max().item()
        assert top > 0, name
        assert (got - want).abs().max().item() <= 1e-4 * top, name
    first, last = (s[2]["loss"].item() for s in (trained["steps"][0],
                                                 trained["steps"][-1]))
    assert last < first


def test_coop_weights_after_three_steps_match_jax(trained):
    """Adam moves an entry by about lr * sign(g) a step: an entry whose
    gradient stays well above the rounding noise (>= 1e-2 of its leaf's
    largest) agrees to 2% of the most it can travel, 3 * lr; any entry to
    twice that travel. Frozen tensors and BatchNorm buffers do not move."""
    model, start = trained["model"], trained["start"]
    grads = [s[1] for s in trained["steps"]]
    now = model.state_dict()
    n_robust = 0
    for name, want in trained["want_weights"].items():
        diff = (now[name] - want).abs()
        assert diff.max().item() <= 2 * TRAVEL, name
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust = gmin >= 1e-2 * gtop
        if robust.any():
            assert diff[robust].max().item() <= 0.02 * TRAVEL, name
        n_robust += int(robust.sum())
        assert not torch.equal(now[name], start[name]), name
    assert n_robust > 100
    moved = set(trained["want_weights"])
    for name, value in now.items():
        if name not in moved:
            assert torch.equal(value, start[name]), name
    assert sum("running_" in n for n in now) > 50
    assert len(trained["tstate"].optimizer.optimizer.state) == len(moved)


def test_dropout_masks_are_a_function_of_seed_and_step():
    cfg = tmodel.CRISConfig.tiny(dropout=0.2)
    model, spec = tpresets.build_cris("coop", prompt_depth=2, config=cfg,
                                      device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    task = TTask(model, spec, seed=3)
    task.init()
    with torch.no_grad():
        a, b = task._loss(batch, 0)[0].item(), task._loss(batch, 0)[0].item()
        c = task._loss(batch, 1)[0].item()
        other_seed = TTask(model, spec, seed=4)._loss(batch, 0)[0].item()
        # eval, predict and serving draw no mask: the same answer twice
        p1, p2 = task.predict_step(batch), task.predict_step(batch)
    assert a == b
    assert a != c and a != other_seed
    assert torch.equal(p1, p2)
    # the train step uses its state's step: two tasks from the same weights
    # take the same two steps, and the second step is not the first
    start = copy.deepcopy(model.state_dict())
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        state = task.init()
        losses = []
        for _ in range(2):
            state, metrics = task.train_step(state, batch)
            losses.append(metrics["loss"].item())
        runs.append(losses)
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="Generator"):
        tlayers.dropout(torch.ones(4), 0.5, False, None)


def test_what_waits_for_a_later_slice_raises():
    cfg = tmodel.CRISConfig.tiny()
    with pytest.raises(NotImplementedError, match="Slice B"):
        tpresets.build_cris("cocoop", config=cfg, device="cpu")
    with pytest.raises(ValueError, match="coop/cocoop"):
        tpresets.build_cris("vpt", config=cfg, device="cpu")
    model, spec = tpresets.build_cris("e2e", config=cfg, device="cpu")
    task = TTask(model, spec)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(NotImplementedError, match="Slice C"):
        task.train_step(task.init(), batch)
    with pytest.raises(NotImplementedError, match="K4"):
        tmodel.CRISForSegmentation(cfg, layout="flat")
    with pytest.raises(ValueError, match="prompt_depth"):
        tpresets.build_cris("coop", prompt_depth=4, config=cfg, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
def test_build_cris_defaults_to_the_card_and_never_falls_back_to_the_cpu():
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        tpresets.build_cris("coop", config=tmodel.CRISConfig.tiny())


def test_port_config_is_its_own_copy_of_the_jax_one():
    assert tmodel.CRISConfig is not jmodel.CRISConfig
    for make in (lambda c: c(), lambda c: c.tiny(), lambda c: c.tiny(img_size=96)):
        assert (dataclasses.asdict(make(tmodel.CRISConfig))
                == dataclasses.asdict(make(jmodel.CRISConfig)))
    assert (dataclasses.asdict(tpresets.cris_rn50_config())
            == dataclasses.asdict(jpresets.cris_rn50_config()))


def test_full_width_param_and_buffer_set_matches_jax():
    """cris_rn50_config(416) + CoOp(3, 4): the JAX trees (shapes only, no
    compute) and the port's state_dict hold the same leaves."""
    jm, _ = jpresets.build_cris("coop", prompt_depth=3, num_context=4)
    shapes = jax.eval_shape(
        jm.init, KEY, jax.ShapeDtypeStruct((1, 77), jnp.int32),
        jax.ShapeDtypeStruct((2, 3, 416, 416), jnp.float32),
        jax.ShapeDtypeStruct((1, 77), jnp.int32),
        text_index=jax.ShapeDtypeStruct((2,), jnp.int32))
    with torch.device("meta"):
        tm = tmodel.CRISForSegmentation(
            tpresets.cris_rn50_config(),
            tpresets.CoOpLearner(prompt_depth=3, num_context=4, context_dim=512),
            additive_mode="residual")
    want = {}
    for tree in (shapes["params"], shapes["batch_stats"]):
        for path, leaf in flatten_params(tree).items():
            name, transpose = port_name(path)
            want[name] = tuple(leaf.shape[::-1] if transpose else leaf.shape)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert got["visual.layer3.5.conv2.weight"] == (256, 256, 3, 3)
    assert got["text.resblocks.11.mlp.fc1.weight"] == (2048, 512)
    assert got["visual.attnpool.positional_embedding"] == (50, 2048)

"""The CRIS slice of the port against the JAX package, f32 on the CPU: each
module that the slice adds (conv2d / Conv2d, resize_2d, BatchNorm with
running statistics, ModifiedResNet, FPN, the decoder, the projector, the
text transformer) on the JAX module's own `init` weights carried over by
`state_dict_from_jax`, then the whole model (e2e, CoOp at depth 1 and 3, with
prompt dedup), the trainable set, one CoOp train step (loss and every
gradient), the weights after three steps, and the dropout masks' (seed, step)
rule; the backbone's flat layout (the flat convolution K4, on the CPU its
plain version against the JAX package's Pallas kernel in interpret mode or
its plain reference) alone and in the whole model; BatchNorm batch statistics
and three e2e train steps (towers frozen, and the full fine-tune on the flat
layout) with loss, every gradient, weights and running statistics. Sizes are
`CRISConfig.tiny` at 64^2. On the CPU every attention of the port takes the
plain path."""
import contextlib
import copy
import dataclasses
import os

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
from tunevlseg_tpu.ops import conv_pallas as jconv_flat  # noqa: E402
from tunevlseg_tpu.ops import image as jimage  # noqa: E402
from tunevlseg_tpu.training.optim import merge_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params,  # noqa: E402
                                              model_state_from_jax,
                                              model_state_to_jax, port_name,
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


def _live_stats(variables, seed=7):
    """Running statistics that keep a randomly initialised network alive:
    means in (-0.2, 0.2) and variances in (0.1, 0.3), about what its
    convolutions put out, so that the ReLUs pass a good part of the signal
    (with `_random_stats`' means near 1 most of them are shut, and a deep
    stack then carries constants)."""
    rng = _rng(seed)

    def draw(path, x):
        lo, hi = (0.1, 0.3) if path[-1].key == "running_var" else (-0.2, 0.2)
        return jnp.asarray(rng.uniform(lo, hi, size=x.shape), jnp.float32)

    stats = jax.tree_util.tree_map_with_path(draw, variables["batch_stats"])
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
    # the frozen BatchNorm as the flat convolution's (scale, offset)
    scale, offset = tm.folded_affine()
    shape = (1, 5) + (1,) * (x.ndim - 2)
    _close(torch.from_numpy(x) * scale.reshape(shape) + offset.reshape(shape),
           want, 1e-5)
    with pytest.raises(AssertionError, match="frozen"):
        getattr(tresnet, cls)(5, use_running_average=False).folded_affine()


@pytest.mark.parametrize("cls,shape", [("BatchNorm2d", (3, 5, 4, 4)),
                                       ("BatchNorm1d", (6, 5)),
                                       ("BatchNorm1d", (1, 5))])
@pytest.mark.parametrize("at_call", [False, True])
def test_batchnorm_batch_statistics_match_jax(cls, shape, at_call):
    """`use_running_average=False`, at construction or as the call-time
    override: batch mean and biased variance in f32, the running statistics
    moved with momentum 0.1 towards the batch mean and the unbiased variance
    var * n / max(n - 1, 1) (n = 1: a variance of 0). The port hands the new
    statistics to `updates` and leaves its buffers alone."""
    x = _rng(4).normal(size=shape).astype(np.float32)
    jm = getattr(jresnet, cls)(5, use_running_average=False)
    variables = _random_stats(jm.init(KEY, jnp.asarray(x)))
    rng = _rng(5)
    variables["params"] = {k: jnp.asarray(rng.normal(size=(5,)), jnp.float32)
                           for k in ("weight", "bias")}
    want, mutated = jm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tm = _load(getattr(tresnet, cls)(5, use_running_average=at_call), variables)
    before = {k: v.clone() for k, v in tm.named_buffers()}
    updates = {}
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, False, updates) if at_call else tm(xt, updates=updates)
    _close(got, want, 1e-5)
    mean, var = updates[tm]
    _close(mean, mutated["batch_stats"]["running_mean"], 1e-6)
    _close(var, mutated["batch_stats"]["running_var"], 1e-6)
    assert not mean.requires_grad and not var.requires_grad
    for k, v in tm.named_buffers():
        assert torch.equal(v, before[k]), k
    # the gradient runs through the batch statistics
    cot = _rng(6).normal(size=shape).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jm.apply(variables, a, mutable=["batch_stats"])[0]
                                       * cot))(jnp.asarray(x))
    got.backward(torch.from_numpy(cot))
    _close(xt.grad, jgrad, 1e-4)
    # without `updates` the statistics are used and not reported
    assert torch.equal(tm(xt, False), got)


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
    with pytest.raises(ValueError, match="TPU layout experiment"):
        tresnet.ModifiedResNet(layout="nhwc", **kw)
    with pytest.raises(ValueError, match="frozen BatchNorm"):
        tresnet.ModifiedResNet(layout="flat", use_running_average=False, **kw)


@pytest.mark.parametrize("flat_stages", [("stem", "1", "2", "4"),
                                         ("stem", "1", "2", "3", "4"), ("3",)])
def test_modified_resnet_flat_matches_jax_and_nchw(flat_stages, monkeypatch):
    """`layout="flat"`: the listed stages through the flat convolution (here
    its plain version; the JAX package runs its Pallas kernel in interpret
    mode), the rest as before, against the JAX flat backbone and against the
    port's own "nchw" layout from one `state_dict`."""
    monkeypatch.setattr(jconv_flat, "_INTERPRET", True)
    kw = dict(layers=(1, 2, 1, 1), output_dim=24, heads=8, input_resolution=64,
              width=16)
    x = _rng(6).normal(size=(2, 3, 64, 64)).astype(np.float32)
    jm = jresnet.ModifiedResNet(layout="flat", flat_stages=flat_stages, **kw)
    variables = _live_stats(jm.init(KEY, jnp.asarray(x)))
    flat = _load(tresnet.ModifiedResNet(layout="flat", flat_stages=flat_stages,
                                        **kw), variables)
    nchw = tresnet.ModifiedResNet(**kw)
    nchw.load_state_dict(flat.state_dict())          # the same names and shapes
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = flat(torch.from_numpy(x))
        plain = nchw(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 128, 8, 8), (2, 256, 4, 4),
                                             (2, 24, 2, 2)]
    for g, w, p in zip(got, want, plain):
        _close(g, w)
        _close(g, p)
        # a live network: a good part of every map is non-zero and it varies
        assert (g != 0).float().mean().item() > 0.2 and g.std().item() > 0.05
    # channels-last weights: stage entry reads the NHWC view in place, and
    # the stage's output is a view of the last flat tensor
    flat.to(memory_format=torch.channels_last)
    with torch.no_grad():
        again = flat(torch.from_numpy(x))
    for g, a in zip(got, again):
        _close(a, g, 1e-5)
    spec = tresnet.make_flat_spec(8, 8, 1)
    f = tresnet.to_flat(torch.from_numpy(x[:, :, :8, :8]).contiguous(
        memory_format=torch.channels_last), spec)
    out = tresnet.from_flat(f, spec)
    assert out.shape == (2, 3, 8, 8) and out.stride(1) == 1
    assert out.untyped_storage().data_ptr() == f.untyped_storage().data_ptr()
    assert torch.equal(out, torch.from_numpy(x[:, :, :8, :8]))


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


def _pair(strategy, depth, stats=_random_stats, **task_kw):
    """The JAX task and the port's on the same weights: JAX `init`, random
    running statistics, carried over by `state_dict_from_jax`."""
    batch = _batch()
    jm, jspec = jpresets.build_cris(strategy, prompt_depth=depth, num_context=4,
                                    config=jmodel.CRISConfig.tiny())
    jtask = JTask(jm, jspec, **task_kw)
    jstate, frozen = jtask.init(KEY, batch)
    frozen = {**frozen, "batch_stats": stats(frozen)["batch_stats"]}
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


@contextlib.contextmanager
def _jax_flat_backbone(value="1"):
    """The JAX package reads TUNEVLSEG_PALLAS_CONV when a model is traced."""
    old = os.environ.get("TUNEVLSEG_PALLAS_CONV")
    os.environ["TUNEVLSEG_PALLAS_CONV"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["TUNEVLSEG_PALLAS_CONV"]
        else:
            os.environ["TUNEVLSEG_PALLAS_CONV"] = old


@pytest.mark.parametrize("pconv,flat_stages", [
    ("1", ("stem", "1", "2", "3", "4")), ("stem,1,2,4", ("stem", "1", "2", "4"))])
def test_cris_coop_flat_layout_matches_jax(pconv, flat_stages, monkeypatch):
    """The whole CoOp model with the backbone on the flat layout, against the
    JAX model under TUNEVLSEG_PALLAS_CONV (its plain reference on the CPU),
    and against the port's "nchw" model on the same weights."""
    monkeypatch.setenv("TUNEVLSEG_PALLAS_CONV", pconv)
    jtask, jstate, frozen, params, ttask, batch = _pair("coop", 3, stats=_live_stats)
    tflat, _ = tpresets.build_cris("coop", prompt_depth=3, num_context=4,
                                   config=tmodel.CRISConfig.tiny(), layout="flat",
                                   flat_stages=flat_stages, device="cpu")
    assert tflat.visual.layout == "flat"
    assert ttask.model.visual.layout == "nchw"          # the default
    tflat.load_state_dict(ttask.model.state_dict())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jtask.predict_step(jstate, frozen, batch)
    got = TTask(tflat).predict_step(tbatch)
    _close(got, want)
    _close(got, ttask.predict_step(tbatch))
    # the backbone is alive and its pyramid reaches the output
    with torch.no_grad():
        c3, c4, c5 = tflat.visual(ttask._prep_image(tbatch["image"]))
    for g in (c3, c4, c5):
        assert (g != 0).float().mean().item() > 0.2 and g.std().item() > 0.05
    assert got.std().item() > 1e-3
    served = task_predict_fn(TTask(tflat))(dict(tflat.state_dict()), tbatch)
    torch.testing.assert_close(served, got, rtol=0, atol=2e-6)


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
    # CoCoOp builds; its text stack is per image, so prompt dedup raises
    cocoop, _ = tpresets.build_cris("cocoop", config=cfg, device="cpu")
    dedup = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with pytest.raises(ValueError, match="image-conditioned"):
        TTask(cocoop).predict_step(dedup)
    with pytest.raises(ValueError, match="coop/cocoop"):
        tpresets.build_cris("vpt", config=cfg, device="cpu")
    with pytest.raises(ValueError, match="TPU layout experiment"):
        tmodel.CRISForSegmentation(cfg, layout="nhwc")
    with pytest.raises(ValueError, match="prompt_depth"):
        tpresets.build_cris("coop", prompt_depth=4, config=cfg, device="cpu")
    # the e2e model's train step updates BatchNorm statistics: a task that
    # does not carry them refuses it (Flax refuses to write an immutable
    # collection); eval and predict need nothing
    model, spec = tpresets.build_cris("e2e", config=cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    task = TTask(model, spec)
    with pytest.raises(ValueError, match="mutable_collections"):
        task.train_step(task.init(), batch)
    assert task.predict_step(batch).shape == (4, 1, 64, 64)
    with pytest.raises(ValueError, match="batch_stats"):
        TTask(model, spec, mutable_collections=("cache",))
    assert tmodel.CRISForSegmentation(cfg, layout="flat").visual.layout == "flat"


# --- the e2e train step: BatchNorm batch statistics in the train state ------

E2E_CASES = {
    # the CRIS default: towers frozen, the head trains with train-mode BN
    "default": dict(build={}, flat=False),
    # full fine-tune on the flat layout: K4's backward (here its plain version)
    "full_flat": dict(build=dict(freeze_encoder=False), flat=True),
}


@pytest.fixture(scope="module", params=list(E2E_CASES))
def e2e_trained(request):
    """Three e2e steps of both packages from the same weights and running
    statistics on one batch, with `mutable_collections=("batch_stats",)`."""
    case = E2E_CASES[request.param]
    hp = dict(learning_rate=LR, weight_decay=0.01, grad_clip_norm=0.5,
              mutable_collections=("batch_stats",))
    batch = _batch()
    cfg = jmodel.CRISConfig.tiny()
    with _jax_flat_backbone("1" if case["flat"] else "0"):
        jm, jspec = jpresets.build_cris("e2e", config=cfg, **case["build"])
        jtask = JTask(jm, jspec, **hp)
        jstate, frozen = jtask.init(KEY, batch)
        assert "batch_stats" not in frozen
        stats = _live_stats({"params": {}, **jstate.model_state})["batch_stats"]
        jstate = jstate._replace(model_state={"batch_stats": stats})
        params = merge_params(jstate.trainable, frozen["params"])

        tm, tspec = tpresets.build_cris(
            "e2e", config=tmodel.CRISConfig.tiny(), seed=1, device="cpu",
            layout="flat" if case["flat"] else "nchw", **case["build"])
        tm.load_state_dict(state_dict_from_jax(params, tm, stats))
        ttask = TTask(tm, tspec, **hp)
        tstate = ttask.init()
        start = copy.deepcopy(tm.state_dict())
        start_stats = dict(tstate.model_state)

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
            # the raw gradients: the step's own are clipped in place (the
            # global norm is above 0.5 here)
            leaves = {n: p for n, p in tm.named_parameters() if p.requires_grad}
            loss, _ = ttask._loss(tbatch, tstate.step, tstate.model_state, {})
            tgrads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            tstate, tmetrics = ttask.train_step(tstate, tbatch)
            steps.append((jmetrics, trainable_from_jax(jgrads, tm), tmetrics,
                          tgrads, model_state_from_jax(jstate.model_state, tm),
                          dict(tstate.model_state)))
            if len(steps) == 1:
                after_first = (trainable_from_jax(jstate.trainable, tm),
                               copy.deepcopy(tm.state_dict()))
        jprobs = jtask.predict_step(jstate, frozen, batch)
        jfinal = state_dict_from_jax(
            merge_params(jstate.trainable, frozen["params"]), tm,
            jstate.model_state["batch_stats"])
    return dict(case=request.param, steps=steps, model=tm, task=ttask,
                tstate=tstate, start=start, start_stats=start_stats,
                jstate=jstate, jprobs=jprobs, tbatch=tbatch,
                after_first=after_first, jfinal=jfinal,
                want_weights=trainable_from_jax(jstate.trainable, tm))


def test_e2e_train_step_loss_and_gradients_match_jax(e2e_trained):
    """The loss within 5e-5 at every step (f32, a live train-mode network;
    the first step is 1.1e-5 apart), dice and iou within 2e-3 (a pixel that
    crosses the threshold moves them by 1e-4). Every gradient of the first
    step within 5e-4 of its largest entry, or of 1e-3 of the largest entry of
    any leaf where that is more: some leaves have a gradient that is zero in
    exact arithmetic and rounding noise here, 1e-6 of the others (a key bias
    shifts every score of a row alike; the text projection's Linear and
    BatchNorm and f1_v_proj's BatchNorm scale a channel that the next
    train-mode BatchNorm normalises again). The full fine-tune sends
    gradients into the backbone's convolution weights and, through the folded
    affine, into its BatchNorm weight and bias."""
    for jmetrics, _, tmetrics, *_ in e2e_trained["steps"]:
        for key, value in tmetrics.items():
            tol = 5e-5 if key == "loss" else 2e-3
            np.testing.assert_allclose(value.item(), float(jmetrics[key]),
                                       atol=tol, rtol=0, err_msg=key)
    _, jgrads, _, tgrads, *_ = e2e_trained["steps"][0]
    assert set(tgrads) == set(jgrads)
    full = e2e_trained["case"] == "full_flat"
    for name in ("visual.conv1.weight", "visual.layer2.0.conv2.weight",
                 "visual.layer1.0.bn3.weight", "visual.bn2.bias",
                 "visual.layer3.0.downsample_conv.weight",
                 "text.resblocks.0.mlp.fc1.weight"):
        assert (name in tgrads) == full, name
    assert "neck.f2_cat.bn.weight" in tgrads and "proj.vis_1.conv.weight" in tgrads
    overall = max(g.abs().max().item() for g in jgrads.values())
    for name, got in tgrads.items():
        want = jgrads[name]
        bound = 5e-4 * max(want.abs().max().item(), 1e-3 * overall)
        assert (got - want).abs().max().item() <= bound, name
    if full:
        for name in ("visual.conv1.weight", "visual.layer2.0.conv2.weight",
                     "visual.layer1.0.bn3.weight", "visual.bn2.bias"):
            assert jgrads[name].abs().max().item() > 1e-2 * overall, name


def test_e2e_running_statistics_follow_the_train_state(e2e_trained):
    """The state's running statistics equal the JAX task's: 1e-5 after the
    first step, 2e-3 after the later ones (they are statistics of
    activations, and the weights have by then moved apart by up to a few lr
    = 1e-3, see the weights test); the FPN's and the projector's move, the
    backbone's do not; the module's own buffers are never written; and
    `model_state_to_jax` is the inverse of `model_state_from_jax`."""
    model, start = e2e_trained["model"], e2e_trained["start"]
    for i, (*_, want_stats, got_stats) in enumerate(e2e_trained["steps"]):
        assert set(got_stats) == set(want_stats) == {
            n for n, _ in model.named_buffers()}
        for name, want in want_stats.items():
            _close(got_stats[name], want, 1e-5 if i == 0 else 2e-3)
    final = e2e_trained["tstate"].model_state
    moved = {n for n in final
             if not torch.equal(final[n], e2e_trained["start_stats"][n])}
    assert moved == {n for n in final if n.startswith(("neck.", "proj."))}
    assert len(moved) == 2 * 15      # 13 BatchNorms in the FPN, 2 in the projector
    for name, buf in model.named_buffers():
        assert torch.equal(buf, start[name]), name
    back = model_state_to_jax(final)
    flat_back = flatten_params(back["batch_stats"])
    flat_want = flatten_params(e2e_trained["jstate"].model_state["batch_stats"])
    assert set(flat_back) == set(flat_want)
    for path, value in flat_back.items():
        np.testing.assert_allclose(value, np.asarray(flat_want[path]), atol=2e-3)
    assert model_state_to_jax({}) == {}


def test_e2e_weights_after_three_steps_and_eval_match_jax(e2e_trained):
    """Adam moves an entry by about lr * sign(g) a step. After the FIRST step
    an entry whose gradient is well above the rounding noise (>= 1e-2 of its
    leaf's largest and >= 1e-3 of the largest of any leaf) agrees to 2% of
    lr. Entries with a gradient of rounding noise move by lr either way, so
    from the second step on the two packages differentiate slightly
    different functions: after three steps every entry agrees to twice the
    most it can travel, 3 * lr, and of the robust entries at least 99% to a
    tenth of that travel (measured 99.6% and 99.9%). Frozen tensors do not
    move. Eval and predict read the state's statistics: on the JAX task's
    final weights and statistics they agree with its prediction, and on the
    port's own they differ from a prediction with the module's stale
    buffers."""
    model, start = e2e_trained["model"], e2e_trained["start"]
    grads = [s[1] for s in e2e_trained["steps"]]
    overall = max(g.abs().max().item() for g in grads[0].values())
    want_first, got_first = e2e_trained["after_first"]
    n_first = 0
    for name, want in want_first.items():
        g = grads[0][name].abs()
        robust = (g >= 1e-2 * g.max()) & (g >= 1e-3 * overall)
        if robust.any():
            diff = (got_first[name] - want).abs()
            assert diff[robust].max().item() <= 0.02 * LR, name
            assert not torch.equal(got_first[name], start[name]), name
        n_first += int(robust.sum())
    assert n_first > 10000
    now = model.state_dict()
    robust_diffs = []
    for name, want in e2e_trained["want_weights"].items():
        diff = (now[name] - want).abs()
        assert diff.max().item() <= 2 * TRAVEL, name
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust_diffs.append(diff[gmin >= 1e-2 * gtop].flatten())
    robust_diffs = torch.cat(robust_diffs)
    assert robust_diffs.numel() > 10000
    assert (robust_diffs <= 0.1 * TRAVEL).float().mean().item() >= 0.99
    trainable = set(e2e_trained["want_weights"])
    for name, p in model.named_parameters():
        assert (name in trainable) == p.requires_grad, name
        if name not in trainable:
            assert torch.equal(now[name], start[name]), name
    task, tstate, tbatch = (e2e_trained[k] for k in ("task", "tstate", "tbatch"))
    probs = task.predict_step(tbatch, tstate)
    stale = task.predict_step(tbatch)
    assert (probs - stale).abs().max().item() > 1e-3
    jfinal = e2e_trained["jfinal"]
    final_model = copy.deepcopy(model)
    final_model.load_state_dict(jfinal)
    final_state = dataclasses.replace(tstate, model_state={
        n: jfinal[n] for n in tstate.model_state})
    on_jax_weights = TTask(final_model, task.freeze_spec).predict_step(tbatch)
    _close(on_jax_weights, e2e_trained["jprobs"])
    # the same statistics through the state, over the module's stale ones
    final_model.load_state_dict({**jfinal, **e2e_trained["start_stats"]})
    _close(TTask(final_model, task.freeze_spec, mutable_collections=("batch_stats",))
           .predict_step(tbatch, final_state), on_jax_weights, 1e-6)
    from tunevlseg_torch.ops.metrics import SegMetricState
    _, aux = task.eval_step(SegMetricState.zeros(), tbatch, tstate)
    _, aux_stale = task.eval_step(SegMetricState.zeros(), tbatch)
    assert bool(aux["loss_sum"].isfinite()) and aux["loss_sum"] != aux_stale["loss_sum"]


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

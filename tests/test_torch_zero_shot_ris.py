"""The zero-shot RIS slice of the port against the JAX package, f32 on the
CPU, on the same weights in both: the device crop-resize (also against the
port's host crops), FreeSOLO's D2ResNet + D2FPN on both layouts (the flat one
through K4's plain version here, the JAX one through its flat path under
`TUNEVLSEG_PALLAS_CONV=1`), SOLOv2's raw outputs, its fixed-shape inference
fed the same raw predictions (ties included), MaskedCLIP and BiomedCLIP
features, `ZeroShotRIS` end to end (`__call__`, `predict_fused`,
`predict_fused_many`, a cache written by the JAX package read by the port),
the `eval_zeroshot` CLI on a synthetic folder, and the failure cases.

The JAX parameter trees come from `jax.eval_shape(model.init, ...)` filled
from a seeded numpy generator (Flax's `init` of a full-width R50 takes tens
of seconds on the CPU); the port loads them by `state_dict_from_jax`. Every
JAX apply runs under `jax.jit`.

Tolerances: outputs 1e-4 of the largest |reference| (f32, the same formulas,
sums in another order); the crop-resize 1e-5 of the largest |value| (the
same gathers and products); masks, validity and boxes of the fixed-shape
inference exactly, scores and embeddings 1e-5; the picked masks exactly."""
import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.clip import config as jclip_config  # noqa: E402
from tunevlseg_tpu.models.solov2 import backbone as jbackbone  # noqa: E402
from tunevlseg_tpu.models.solov2 import model as jsolo  # noqa: E402
from tunevlseg_tpu.models.zero_shot_ris import biomed_clip as jbiomed  # noqa: E402
from tunevlseg_tpu.models.zero_shot_ris import model as jris  # noqa: E402
from tunevlseg_tpu.ops import image as jimage  # noqa: E402
from tunevlseg_torch import eval_zeroshot  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params, port_name,  # noqa: E402
                                              state_dict_from_jax)
from tunevlseg_torch.models.solov2 import backbone as tbackbone  # noqa: E402
from tunevlseg_torch.models.solov2 import model as tsolo  # noqa: E402
from tunevlseg_torch.models.zero_shot_ris import biomed_clip as tbiomed  # noqa: E402
from tunevlseg_torch.models.zero_shot_ris import model as tris  # noqa: E402
from tunevlseg_torch.ops import image as timage  # noqa: E402

TOL = 1e-4
KEY = jax.random.PRNGKey(0)
IMG = 64
# the zsseg CLI's tiny models (eval_zeroshot.ris_configs with tiny_model);
# random heads score their cells near 0.5, the thresholds keep the JAX
# package's defaults
TINY_CFG = {"model": {}, "tiny_model": True}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: the tiny models run many small ops, whose OpenMP
    teams otherwise wait on descheduled threads beside the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, (err, scale)


def _filled(shapes, seed: int) -> dict:
    """A JAX parameter tree of `shapes` (from `jax.eval_shape`) filled from a
    seeded numpy generator: weights at 1/sqrt(fan_in), norms' scales near 1,
    FrozenBN variances positive, embeddings at 0.02."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "running_mean" or name in ("bias", "patch_bias"):
            v = rng.normal(0.0, 0.1, shape)
        elif name == "scale" or (name == "weight" and len(shape) == 1):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "weight":                      # OIHW convolution
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif name in ("kernel", "patch_proj"):
            v = rng.normal(size=shape) / np.sqrt(shape[0])
        else:                                       # embeddings, cls tokens
            v = rng.normal(0.0, 0.02, shape)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and k in out else v
    return out


def _loaded(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax(params, module))
    return module.eval()


def _jcfg(cfg):
    """The JAX package's config dataclass of the same name and fields as the
    port's `cfg` (nested configs included)."""
    name = type(cfg).__name__
    cls = next(getattr(m, name) for m in (jsolo, jclip_config, jbiomed)
               if hasattr(m, name))
    return cls(**{k: _jcfg(v) if dataclasses.is_dataclass(v) else v
                  for k, v in vars(cfg).items()})


def _jit(module, method=None, **static):
    fn = functools.partial(module.apply, method=method, **static)
    return jax.jit(fn)


def _image(seed=1, size=IMG):
    return np.random.default_rng(seed).normal(size=(3, size, size)).astype(np.float32)


def _text_ids(vocab=49408, length=12, seed=2):
    """[phrase, class name] rows: BOS, words, EOS (the largest id), padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (2, length)).astype(np.int32)
    ids[:, 0] = vocab - 2
    ids[0, 7:], ids[1, 4:] = 0, 0
    ids[0, 6], ids[1, 3] = vocab - 1, vocab - 1
    return ids, (np.arange(length)[None] <= np.array([[6], [3]])).astype(np.int32)


# --- shared models ------------------------------------------------------------

@pytest.fixture(scope="module")
def solo():
    """The CLI's tiny SOLOv2 (full-width R50, narrow heads) on one set of
    weights: port config, JAX module, its params, the port's on "nchw" and
    "flat", and an image with the JAX model's raw outputs on it."""
    _, cfg, _ = eval_zeroshot.ris_configs(TINY_CFG)
    jm = jsolo.SOLOv2(_jcfg(cfg))
    shapes = jax.eval_shape(jm.init, KEY, jnp.zeros((1, 3, IMG, IMG)))["params"]
    params = _filled(shapes, 10)
    x = _image(5)[None]
    raw = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    return types.SimpleNamespace(
        cfg=cfg, jm=jm, params=params, x=x,
        raw=jax.tree_util.tree_map(np.array, list(raw)),
        tm=_loaded(tsolo.SOLOv2(cfg), params),
        tm_flat=_loaded(tsolo.SOLOv2(cfg, layout="flat"), params))


@pytest.fixture(scope="module")
def clip():
    """(port config, JAX MaskedCLIP, its params, port MaskedCLIP), tiny."""
    cfg, _, size = eval_zeroshot.ris_configs(TINY_CFG)
    jm = jris.MaskedCLIP(_jcfg(cfg))
    image = jax.eval_shape(functools.partial(
        jm.init, method=jm.get_image_features), KEY,
        jnp.zeros((1, 3, size, size)))["params"]
    text = jax.eval_shape(functools.partial(
        jm.init, method=jm.get_text_features), KEY,
        jnp.zeros((2, 12), jnp.int32), jnp.ones((2, 12), jnp.int32))["params"]
    params = _filled(_merge(image, text), 11)
    return cfg, jm, params, _loaded(tris.MaskedCLIP(cfg), params)


@pytest.fixture(scope="module")
def biomed():
    cfg = tbiomed.BiomedCLIPConfig.tiny()
    jm = jbiomed.BiomedCLIP(_jcfg(cfg))
    image = jax.eval_shape(functools.partial(
        jm.init, method=jm.get_image_features), KEY,
        jnp.zeros((1, 3, 32, 32)))["params"]
    text = jax.eval_shape(functools.partial(
        jm.init, method=jm.get_text_features), KEY,
        jnp.zeros((2, 10), jnp.int32))["params"]
    params = _filled(_merge(image, text), 12)
    return cfg, jm, params, _loaded(tbiomed.BiomedCLIP(cfg), params)


# --- the device crop-resize ---------------------------------------------------

def test_crop_resize_matches_jax_and_the_host_crops():
    """Boxes past every edge of the image, negative, fractional (truncated
    toward zero), 1-px and degenerate (x2 < x1: clamped to 1 px), on random
    masks; against the JAX op and against the port's host crops of the valid
    ones."""
    rng = np.random.default_rng(3)
    image = rng.normal(size=(3, 40, 48)).astype(np.float32)
    masks = rng.random((7, 40, 48)) > 0.4
    boxes = np.array([[4.7, 3.2, 30.9, 25.1], [-6, -3, 20, 12], [30, 20, 60, 55],
                      [10, 10, 11, 11], [12, 5, 9, 30], [-10, -10, 70, 70],
                      [0, 0, 48, 40]], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    size = 24
    got = timage.crop_resize_bicubic_masked(
        torch.from_numpy(image), torch.from_numpy(masks),
        torch.from_numpy(boxes), size)
    want = jax.jit(jimage.crop_resize_bicubic_masked, static_argnums=3)(
        jnp.asarray(image), jnp.asarray(masks), jnp.asarray(boxes), size)
    _close(got, want, 1e-5)
    host = tris.ZeroShotRIS.host_crop_canvases(image, boxes, masks, valid, size)
    _close(got[torch.from_numpy(valid)], host[valid], 1e-5)
    assert not host[~valid].any()


# --- FreeSOLO -----------------------------------------------------------------

def test_resnet_fpn_matches_jax(monkeypatch):
    """D2ResNet (R50) + D2FPN at 64^2 on both of the port's layouts against
    the JAX package's flat path (TUNEVLSEG_PALLAS_CONV=1, as
    tests/test_conv_pallas.py runs it, which that file holds to its NCHW
    path; the whole SOLOv2 below holds the port's "nchw" to the JAX NCHW
    path). The port's flat layout chains 2 + 3 + 5 + 2 blocks through K4's
    plain version. Narrow stem and res2 (the widths are the modules'
    arguments)."""
    monkeypatch.setenv("TUNEVLSEG_PALLAS_CONV", "1")
    jr = jbackbone.D2ResNet(50, stem_out=8, res2_out=32)
    jf = jbackbone.D2FPN(16, (32, 64, 128, 256))
    x = _image(4)[None]
    rparams = _filled(jax.eval_shape(jr.init, KEY, jnp.asarray(x))["params"], 20)
    want = jax.jit(jr.apply)({"params": rparams}, jnp.asarray(x))
    fparams = _filled(jax.eval_shape(jf.init, KEY, want)["params"], 21)
    want_p = jax.jit(jf.apply)({"params": fparams}, want)
    tf = _loaded(tbackbone.D2FPN(16, (32, 64, 128, 256)), fparams)
    for layout in ("nchw", "flat"):
        tr = _loaded(tbackbone.D2ResNet(50, stem_out=8, res2_out=32,
                                        layout=layout), rparams)
        with torch.no_grad():
            got = tr(torch.from_numpy(x))
            got_p = tf(got)
        for k in want:
            _close(got[k], want[k])
        for k in want_p:
            _close(got_p[k], want_p[k])


def test_solov2_raw_outputs_match_jax(solo):
    with torch.no_grad():
        got = solo.tm(torch.from_numpy(solo.x))
        got_flat = solo.tm_flat(torch.from_numpy(solo.x))
    for g_all in (got, got_flat):
        for g, w in zip(g_all[:3], solo.raw[:3]):       # cate, kernel, emb
            assert len(g) == len(w) == 5
            for gl, wl in zip(g, w):
                _close(gl, wl)
        _close(g_all[3], solo.raw[3])                   # mask features


def _tied_predictions(cfg, seed=6):
    """Raw predictions whose category scores take three values (many cells
    tie, most above the threshold) and whose kernels are copies of four
    prototypes (tied cells make identical masks, so the rescored values tie
    too)."""
    rng = np.random.default_rng(seed)
    levels = (-4.0, 0.4, 1.5)
    cate, kern, emb = [], [], []
    for g in cfg.num_grids:
        cate.append(rng.choice(levels, (1, cfg.num_classes, g, g)))
        proto = rng.normal(size=(4, cfg.num_kernels))
        kern.append(proto[rng.integers(0, 4, g * g)].T.reshape(
            1, cfg.num_kernels, g, g))
        emb.append(rng.normal(size=(1, cfg.num_embs, g, g)))
    mask_feats = rng.normal(size=(1, cfg.num_masks, 16, 16))
    f32 = [[a.astype(np.float32) for a in lv] for lv in (cate, kern, emb)]
    return f32 + [mask_feats.astype(np.float32)]


@pytest.mark.parametrize("case", ["tied", "model"])
def test_solov2_inference_matches_jax(case, solo):
    """point_nms, matrix_nms and the fixed-shape inference fed the same raw
    predictions: the tiny model's, and a set with ties everywhere (the
    selections' tie order is JAX's: lower index first)."""
    cfg = solo.cfg
    if case == "tied":
        raw = _tied_predictions(cfg)
        cur, ori = (64, 64), (60, 52)
    else:
        raw, cur, ori = solo.raw, (IMG, IMG), (IMG, IMG)
    heat = raw[0][0]
    _close(tsolo.point_nms(torch.from_numpy(heat)), jsolo.point_nms(heat), 0)
    want = jax.jit(jsolo.solov2_inference, static_argnums=(4, 5, 6))(
        *jax.tree_util.tree_map(jnp.asarray, raw), _jcfg(cfg), cur, ori)
    got = tsolo.solov2_inference(*jax.tree_util.tree_map(torch.from_numpy, raw),
                                 cfg, cur, ori)
    masks, boxes, scores, embs, valid = (np.asarray(w) for w in want)
    assert valid.sum() >= 3, "the case must have valid proposals"
    np.testing.assert_array_equal(got[0].numpy(), masks)
    np.testing.assert_array_equal(got[4].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), boxes)
    _close(got[2], scores, 1e-5)
    _close(got[3], embs, 1e-5)


def test_matrix_nms_matches_jax():
    rng = np.random.default_rng(8)
    seg = rng.random((12, 9, 9)) > 0.5
    seg[3] = seg[1]                                   # a duplicate mask
    sums = seg.sum(axis=(1, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 12)
    scores = np.sort(rng.random(12).astype(np.float32))[::-1].copy()
    valid = rng.random(12) > 0.2
    want = jax.jit(jsolo.matrix_nms)(jnp.asarray(seg), jnp.asarray(sums),
                                     jnp.asarray(labels), jnp.asarray(scores),
                                     jnp.asarray(valid), 2.0)
    got = tsolo.matrix_nms(*(torch.from_numpy(np.asarray(a)) for a in
                             (seg, sums, labels, scores, valid)), 2.0)
    _close(got, want, 1e-6)


def test_preprocess_pads_without_normalizing(solo):
    cfg = solo.cfg
    image = _image(9, 50)
    got = tsolo.preprocess_image(torch.from_numpy(image), cfg)
    want = jsolo.preprocess_image(jnp.asarray(image), _jcfg(cfg))
    assert got.shape == (1, 3, 64, 64)
    _close(got, want, 0)
    _close(tsolo.preprocess_image(torch.from_numpy(image), cfg, normalize=True),
           jsolo.preprocess_image(jnp.asarray(image), _jcfg(cfg), normalize=True),
           1e-6)


# --- the dual encoders --------------------------------------------------------

def test_masked_clip_features_match_jax(clip):
    """Image features masked from layer -3 on, with no masking layer (None:
    the image's own features, batch 1) and without masks; text features."""
    cfg, jm, params, tm = clip
    rng = np.random.default_rng(13)
    pixels = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    grid = 32 // cfg.vision.patch_size
    pred = (rng.random((5, grid, grid)) > 0.5).astype(np.float32)
    ids, mask = _text_ids()
    for idx, rows in ((-3, 5), (None, 1)):
        want = _jit(jm, jm.get_image_features, masking_block_idx=idx)(
            {"params": params}, jnp.asarray(pixels), jnp.asarray(pred))
        with torch.no_grad():
            got = tm.get_image_features(torch.from_numpy(pixels),
                                        torch.from_numpy(pred), idx)
        assert got.shape == (rows, cfg.projection_dim)
        _close(got, want)
    plain = _jit(jm, jm.get_image_features)({"params": params},
                                            jnp.asarray(pixels))
    want_t = _jit(jm, jm.get_text_features)({"params": params},
                                            jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        _close(tm.get_image_features(torch.from_numpy(pixels)), plain)
        _close(tm.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask)),
               want_t)


def test_biomed_clip_features_match_jax(biomed):
    cfg, jm, params, tm = biomed
    rng = np.random.default_rng(14)
    pixels = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    pred = (rng.random((4, 4, 4)) > 0.5).astype(np.float32)
    ids = rng.integers(4, cfg.text.vocab_size, (2, 10)).astype(np.int32)
    ids[0, 7:], ids[1, 5:] = 0, 0                      # padding: the pad id
    want = _jit(jm, jm.get_image_features, masking_block_idx=-2)(
        {"params": params}, jnp.asarray(pixels), jnp.asarray(pred))
    want_t = _jit(jm, jm.get_text_features)({"params": params}, jnp.asarray(ids))
    # positions resized: a 48^2 input on the 32^2 pretraining grid
    big = rng.normal(size=(2, 3, 48, 48)).astype(np.float32)
    want_big = _jit(jm, jm.get_image_features)({"params": params},
                                               jnp.asarray(big))
    with torch.no_grad():
        got = tm.get_image_features(torch.from_numpy(pixels),
                                    torch.from_numpy(pred), -2)
        got_t = tm.get_text_features(torch.from_numpy(ids))
        got_big = tm.get_image_features(torch.from_numpy(big))
    _close(got, want)
    _close(got_t, want_t)
    _close(got_big, want_big)


def test_name_maps_cover_every_leaf(solo, clip, biomed):
    """Every JAX leaf of SOLOv2, MaskedCLIP and BiomedCLIP names a port
    tensor and every port tensor is named (`state_dict_from_jax` raises on
    either); the FrozenBN statistics are parameters in both."""
    for params, module in ((solo.params, solo.tm), (clip[2], clip[3]),
                           (biomed[2], biomed[3])):
        names = {port_name(p)[0] for p in flatten_params(params)}
        assert names == set(module.state_dict())
    assert "backbone.res4.5.conv2_norm.running_var" in dict(
        solo.tm.named_parameters())


# --- ZeroShotRIS end to end ---------------------------------------------------

@pytest.fixture(scope="module")
def ris(solo, clip, tmp_path_factory):
    """The JAX package's fused requests at alpha 0.95 (writing its npz cache)
    and 1.0 on the solo fixture's image, and a port `ZeroShotRIS` per alpha
    on the same weights."""
    ccfg, jclip, cparams, tclip = clip
    cache = tmp_path_factory.mktemp("zs_cache")
    ids, mask = _text_ids()
    image = solo.x[0]
    out = {"image": image, "ids": ids, "mask": mask, "cache": cache}
    for alpha in (0.95, 1.0):
        writes = alpha == 0.95
        jr = jris.ZeroShotRIS(_jcfg(ccfg), _jcfg(solo.cfg), cparams, solo.params,
                              alpha=alpha, clip_image_size=32,
                              cache_dir=cache if writes else None,
                              write_cache=writes)
        picked, extras = jr._jit_fused(
            solo.params, cparams, jnp.asarray(image), jnp.asarray(ids),
            jnp.asarray(mask), image.shape[-2:])
        if writes:      # the same executable, through the cache writer
            np.testing.assert_array_equal(
                jr.predict_fused(image, ids, mask, cache_name="img0.png"), picked)
        out[alpha] = (np.asarray(picked), jax.tree_util.tree_map(np.asarray, extras),
                      tris.ZeroShotRIS(ccfg, solo.cfg, tclip, solo.tm,
                                       alpha=alpha, clip_image_size=32))
    return out


@pytest.mark.parametrize("alpha", [0.95, 1.0])
def test_zero_shot_ris_matches_jax(alpha, ris):
    """`predict_fused` and `__call__` pick JAX's mask; the proposals, the
    visual and text features and the similarities agree on the way."""
    want, extras, tr = ris[alpha]
    image, ids, mask = ris["image"], ris["ids"], ris["mask"]
    assert extras["valid"].sum() >= 2, "the request must choose between proposals"
    with torch.no_grad():
        picked, got = tr._fused_forward(torch.from_numpy(image),
                                        torch.from_numpy(ids),
                                        torch.from_numpy(mask), image.shape[-2:])
    for k in ("masks", "boxes", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), extras[k])
    for k in ("mask_features", "crop_features", "phrase_features",
              "class_features"):
        _close(got[k], extras[k])
    sims = got["sims"][got["valid"]]
    assert float((sims.max() - sims.sort().values[-2])) > 1e-3  # no near tie
    np.testing.assert_array_equal(picked.numpy(), want)
    np.testing.assert_array_equal(tr.predict_fused(image, ids, mask), want)
    np.testing.assert_array_equal(tr(image, ids, mask), want)
    assert want.shape == (1, 1, IMG, IMG) and want.any()


def test_predict_fused_many_equals_sequential(ris, solo):
    _, _, tr = ris[0.95]
    ids, mask = ris["ids"], ris["mask"]
    images = [ris["image"], _image(30), _image(31)[:, :48, :56]]
    items = [{"image": im, "input_ids": ids, "attention_mask": mask}
             for im in images]
    seq = [tr.predict_fused(im, ids, mask) for im in images]
    for depth in (0, 2):
        got = list(tr.predict_fused_many(iter(items), depth=depth))
        assert len(got) == 3
        for g, w in zip(got, seq):
            np.testing.assert_array_equal(g, w)


def test_jax_cache_read_by_the_port(ris, clip, solo):
    """The npz files the JAX package wrote (same names, same keys) read by
    the port's host path give JAX's mask, without the models' outputs."""
    want, _, _ = ris[0.95]
    names = sorted(p.name for p in ris["cache"].glob("*.npz"))
    assert names == ["img0_freesolo.npz", "img0_textual_feature.npz",
                     "img0_visual_feature.npz"]
    tr = tris.ZeroShotRIS(clip[0], solo.cfg, clip[3], solo.tm, alpha=0.95,
                          clip_image_size=32, cache_dir=ris["cache"],
                          read_cache=True)
    got = tr(ris["image"] * 0, ris["ids"] * 0, ris["mask"], cache_name="img0.png")
    np.testing.assert_array_equal(got, want)


def test_no_valid_proposal_gives_a_zero_mask(clip, solo):
    """The reference's contract: zeros of (1, 1, H, W), on both paths."""
    cfg = dataclasses.replace(solo.cfg, score_threshold=2.0)
    tr = tris.ZeroShotRIS(clip[0], cfg, clip[3], solo.tm, clip_image_size=32)
    ids, mask = _text_ids()
    for out in (tr(solo.x[0], ids, mask), tr.predict_fused(solo.x[0], ids, mask)):
        assert out.shape == (1, 1, IMG, IMG) and not out.any()


# --- the CLI and the failure cases ----------------------------------------------

MERGES = ["p o", "l y", "po ly", "polyp </w>", "t h", "th e</w>", "a </w>"]


@pytest.mark.parametrize("variant", ["clip", "biomedclip"])
def test_eval_zeroshot_cli(variant, tmp_path):
    """`python -m tunevlseg_torch.eval_zeroshot` on a synthetic folder with
    the tiny models on the CPU (a BPE merges file, or a WordPiece vocabulary
    for BiomedCLIP): it returns the test metrics, and with a cache directory
    writes the npz files."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path / "data" / "zsds"
    for sub in ("images", "masks", "anns"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    tasks = []
    for i in range(2):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 255, (IMG, IMG, 3), dtype=np.uint8))
        cv2.imwrite(str(root / "masks" / f"{i}.png"),
                    np.full((IMG, IMG), 255, np.uint8))
        tasks.append({"img_name": f"{i}.png", "mask_name": f"{i}.png",
                      "prompts": {"p0": "a polyp"}, "object_class": "polyp"})
    (root / "anns" / "test.json").write_text(json.dumps(tasks))
    if variant == "clip":
        vocab = tmp_path / "merges.txt"
        vocab.write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
        extra = []
    else:
        vocab = tmp_path / "vocab.txt"
        vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a",
                                    "polyp", "."]))
        extra = ["experiment=zsseg_biomedclip", "max_length=16"]
    result = eval_zeroshot.main(extra + [
        "ds_name=zsds", f"paths.data_root={tmp_path / 'data'}",
        f"paths.log_dir={tmp_path / 'logs'}", f"vocab_path={vocab}",
        "+tiny_model=true", f"img_size={IMG}", "+trainer.device=cpu",
        f"model.cache_dir={tmp_path / 'cache'}", "model.write_cache=true"])
    assert set(result) == {"test_dice", "test_iou"}
    assert all(0.0 <= v <= 1.0 for v in result.values())
    assert len(list((tmp_path / "cache").glob("*_freesolo.npz"))) == 2


def _cfg(**model):
    return {"model": dict(model), "tiny_model": True, "seed": 0}


def test_failure_cases(tmp_path):
    """n_devices = 2 puts the proposals over the CPU twice, and more
    devices than visible cards raise; the checkpoint loaders fill the
    models from their files (FreeSOLO's detectron2 payload, a CLIPSeg-layout
    CLIP), each beside the other model's seeded weights; without a card
    `build_ris` raises unless given the CPU; the train CLI names this
    family's entry point."""
    pytest.importorskip("transformers")
    from tests.test_torch_convert import (hf_clipseg, ris_clip_cfg,
                                          tiny_freesolo, to_torch)
    assert len(eval_zeroshot.build_ris(dict(_cfg(), n_devices=2),
                                       device="cpu").devices) == 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="n_devices=2 but only"):
            eval_zeroshot.proposal_devices(2, torch.device("cuda"))
    solo_sd = tiny_freesolo()
    torch.save({"model": to_torch(solo_sd)}, tmp_path / "solo.pt")
    hf, clip_sd = hf_clipseg(False, ris_clip_cfg())
    torch.save(hf.state_dict(), tmp_path / "clip.bin")
    seeded = eval_zeroshot.build_ris(_cfg(), device="cpu")
    for key, name in (("solo_checkpoint", "solo.pt"), ("clip_checkpoint", "clip.bin")):
        loaded = eval_zeroshot.build_ris(_cfg(**{key: str(tmp_path / name)}),
                                         device="cpu")
        solo_w = loaded.solo.backbone.res3[1].conv2.weight.detach().numpy()
        clip_w = loaded.clip.vision_model.layers[1].mlp.fc1.weight.detach().numpy()
        if key == "solo_checkpoint":
            np.testing.assert_array_equal(
                solo_w, solo_sd["backbone.bottom_up.res3.1.conv2.weight"])
            np.testing.assert_array_equal(
                clip_w, seeded.clip.vision_model.layers[1].mlp.fc1.weight.detach())
        else:
            np.testing.assert_array_equal(
                clip_w, clip_sd["clip.vision_model.encoder.layers.1.mlp.fc1.weight"])
            np.testing.assert_array_equal(
                solo_w, seeded.solo.backbone.res3[1].conv2.weight.detach())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            eval_zeroshot.build_ris(_cfg())
    ris = eval_zeroshot.build_ris(_cfg(alpha=1.0, layout="flat"), device="cpu")
    assert ris.device.type == "cpu" and ris.solo.backbone.layout == "flat"
    assert isinstance(eval_zeroshot.build_ris(
        _cfg(is_hf_model=False), device="cpu").clip, tbiomed.BiomedCLIP)

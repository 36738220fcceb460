"""The DenseCLIP slice of the port against the JAX package, f32 on the CPU,
on the same weights in both (the port's seeded weights as a JAX tree, read
back by `state_dict_from_jax`; the JAX `init`'s tree shapes in the name-map
test): the RN backbone
(tiny, and tiny with RN101's deep stage 3) with running and with batch
statistics, and the updated running statistics; the flat backbone (K4's
plain version here) against the JAX NCHW path; the ViT backbone with patch
16 (also at 96^2, positions resized) and patch 8; `CLIPFPNBaseline` on both
backbones; the text context encoder; the context decoder; the whole model
with its score map; the losses (ignore labels, both denominators); slide
inference on a grid that does not divide; the poly + warm-up schedule; the
paramwise group of every parameter; three `DenseCLIPTask` train steps (loss,
its parts, acc, the first step's gradients, every trainable leaf and the
BatchNorm statistics afterwards, the text encoder untouched and without
optimizer state); `eval_step`; the name map over every JAX leaf and port
tensor; `build_denseclip`'s device rule; and the port's trainer script
(`scripts/torch_train_denseclip.py`) on the CPU. Sizes are
`DenseCLIPConfig.tiny` / `tiny_vit` at 64^2. On the CPU every attention of
the port takes the plain path and the flat convolution its plain version.

Tolerances: outputs 1e-4 of the largest |reference| (f32, the same
formulas, sums in another order, as tests/test_torch_trans_segmentor.py),
losses 1e-5; gradients 1e-4 of their leaf's largest entry; pixel accuracy
to one pixel (an argmax may flip on a near tie)."""
import copy
import functools
import importlib.util
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.denseclip import inference as jinference  # noqa: E402
from tunevlseg_tpu.models.denseclip import loss as jloss  # noqa: E402
from tunevlseg_tpu.models.denseclip import model as jmodel  # noqa: E402
from tunevlseg_tpu.training import denseclip_task as jtask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params,  # noqa: E402
                                              port_name, state_dict_from_jax,
                                              trainable_from_jax)
from tunevlseg_torch.models.cris.resnet import name_stats_updates  # noqa: E402
from tunevlseg_torch.models.denseclip import inference as tinference  # noqa: E402
from tunevlseg_torch.models.denseclip import loss as tloss  # noqa: E402
from tunevlseg_torch.models.denseclip import model as tmodel  # noqa: E402
from tunevlseg_torch.models.presets import build_denseclip  # noqa: E402
from tunevlseg_torch.nn.layers import (Dense, Embed, GroupNorm,  # noqa: E402
                                       LayerNorm, init_params)
from tunevlseg_torch.training import denseclip_task as ttask  # noqa: E402
from tunevlseg_torch.training.optim import param_path  # noqa: E402

TOL = 1e-4
LOSS_TOL = 1e-5
KEY = jax.random.PRNGKey(0)
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
ROOT = Path(__file__).resolve().parents[1]

CONFIGS = {
    "rn": dict(),
    # RN101's structure at toy widths: a deeper stage 3, a joint dim of its own
    "rn101": dict(vision_layers=(1, 1, 2, 1), embed_dim=16),
    "vit16": dict(backbone_type="vit", patch_size=16, vit_width=16, vit_layers=4,
                  vit_heads=2, vit_out_indices=(0, 1, 2, 3), score_concat_index=2),
    # patch 8: 8 x 8 tokens, the score map joins stage 1
    "vit8": dict(backbone_type="vit", patch_size=8, vit_width=16, vit_layers=4,
                 vit_heads=2, vit_out_indices=(0, 1, 2, 3), score_concat_index=1),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: the tiny models run many small ops, whose
    OpenMP teams otherwise wait on descheduled threads beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _class_ids(cfg, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size - 1,
                       (cfg.num_classes, cfg.text_context_length)).astype(np.int32)
    ids[:, -1] = cfg.vocab_size - 1
    return ids


def _images(b=2, size=64, seed=1):
    return np.random.default_rng(seed).normal(size=(b, 3, size, size)).astype(np.float32)


def _jax_tree(model: torch.nn.Module) -> tuple[dict, dict]:
    """The port's weights as the JAX (params, batch_stats) trees:
    `state_dict_from_jax`'s mapping run backwards. Building the JAX tree from
    the port's seeded weights spares the tests Flax's `init` (tens of seconds
    op by op on the CPU); the name-map test holds the mapping against the
    JAX `init`'s tree (by `jax.eval_shape`)."""
    params, stats = {}, {}
    persistent = model.state_dict()
    for prefix, module in model.named_modules():
        for leaf, p in itertools.chain(module.named_parameters(recurse=False),
                                       module.named_buffers(recurse=False)):
            name = f"{prefix}.{leaf}" if prefix else leaf
            if name not in persistent:
                continue
            path = list(param_path(name))
            value = p.detach().numpy()
            if leaf == "weight" and isinstance(module, Dense):
                path[-1], value = "kernel", value.T
            elif leaf == "weight" and isinstance(module, (LayerNorm, GroupNorm)):
                path[-1] = "scale"
            elif leaf == "weight" and isinstance(module, Embed):
                path[-1] = "embedding"
            node = stats if leaf in ("running_mean", "running_var") else params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = jnp.asarray(value)
    return params, stats


def _randomise_stats(model: torch.nn.Module, seed: int = 7) -> None:
    """Running statistics away from (0, 1), so that normalising with them is
    seen."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))


def _built(case, seed=3, cfg_kw=None, **kw):
    """(config, class ids, the port's DenseCLIP, its JAX variables)."""
    cfg = tmodel.DenseCLIPConfig.tiny(**CONFIGS[case], **(cfg_kw or {}))
    ids = _class_ids(cfg)
    tm = build_denseclip(cfg, ids, device="cpu", seed=seed, **kw)
    _randomise_stats(tm)
    params, stats = _jax_tree(tm)
    back = state_dict_from_jax(params, tm, stats)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    return cfg, ids, tm, {"params": params, "batch_stats": stats}


def _jcfg(cfg):
    return jmodel.DenseCLIPConfig(**{f.name: getattr(cfg, f.name)
                                     for f in cfg.__dataclass_fields__.values()})


def _sub(variables, name):
    return {k: v[name] for k, v in variables.items() if name in v}


def _apply(module, variables, *args, **kwargs):
    """`module.apply` under `jax.jit` (compiling a tiny module takes less
    than running it op by op the first time)."""
    return jax.jit(functools.partial(module.apply, **kwargs))(variables, *args)


# --- modules ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rn", "rn101"])
@pytest.mark.parametrize("bn_train", [False, True], ids=["running", "batch_stats"])
def test_rn_backbone_matches_jax(case, bn_train):
    cfg, _, tm, variables = _built(case)
    x = _images()
    jb = jmodel.CLIPResNetWithAttention(_jcfg(cfg))
    if bn_train:
        want, new = _apply(jb, _sub(variables, "backbone"), x,
                           use_running_average=False, mutable=["batch_stats"])
    else:
        want = _apply(jb, _sub(variables, "backbone"), x)
    updates, named = {}, {}
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(x), not bn_train,
                          updates if bn_train else None)
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)
    _close(got[4][0], want[4][0])
    _close(got[4][1], want[4][1])
    if bn_train:
        name_stats_updates(tm.backbone, updates, named)
        want_stats = {n: v for n, v in trainable_from_jax(
            new["batch_stats"], tm.backbone).items()}
        assert set(named) == set(want_stats) and len(named) == 2 * (
            3 + 3 * sum(cfg.vision_layers) + 4)
        for name, value in want_stats.items():
            _close(named[name], value)


def test_flat_backbone_matches_jax_nchw():
    """The flat layout (K4's plain version on the CPU) against the JAX NCHW
    path; a batch-statistics call of the flat model runs NCHW and matches
    the NCHW model exactly."""
    cfg, _, tm, variables = _built("rn")
    flat = build_denseclip(cfg, _class_ids(cfg), backbone_layout="flat",
                           device="cpu")
    flat.load_state_dict(tm.state_dict())
    x = _images()
    want = _apply(jmodel.CLIPResNetWithAttention(_jcfg(cfg)),
                  _sub(variables, "backbone"), x)
    with torch.no_grad():
        got = flat.backbone(torch.from_numpy(x))
        for g, w in zip(got[:4], want[:4]):
            _close(g, w)
        _close(got[4][1], want[4][1])
        a, b = {}, {}
        nchw = tm.backbone(torch.from_numpy(x), False, a)
        both = flat.backbone(torch.from_numpy(x), False, b)
    assert all(torch.equal(p, q) for p, q in zip(nchw[:4], both[:4]))


@pytest.mark.parametrize("case,size", [("vit16", 64), ("vit16", 96), ("vit8", 64)])
def test_vit_backbone_matches_jax(case, size):
    """Patch 16 and 8, and at 96^2 the positions resized from 4 x 4 to 6 x 6;
    the CLS-position quirk is in both."""
    cfg, _, tm, variables = _built(case)
    x = _images(size=size)
    want = _apply(jmodel.CLIPVisionTransformerBackbone(_jcfg(cfg)),
                  _sub(variables, "backbone"), x)
    with torch.no_grad():
        got = tm.backbone(torch.from_numpy(x))
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)
    _close(got[4][0], want[4][0])
    _close(got[4][1], want[4][1])


@pytest.mark.parametrize("case", ["rn", "vit16"])
def test_fpn_baseline_matches_jax(case):
    cfg = tmodel.DenseCLIPConfig.tiny(**CONFIGS[case])
    tm = tmodel.CLIPFPNBaseline(cfg)
    init_params(tm, torch.Generator().manual_seed(5))
    _randomise_stats(tm)
    params, stats = _jax_tree(tm)
    assert set(state_dict_from_jax(params, tm, stats)) == set(tm.state_dict())
    x = _images()
    want = _apply(jmodel.CLIPFPNBaseline(_jcfg(cfg)),
                  {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)


def test_text_context_encoder_matches_jax():
    """[BOS, context, class tokens] at batch 2 of contexts, EOS pooled at
    argmax + the context length, the causal bias at f32 dtype-min."""
    cfg, ids, tm, variables = _built("rn")
    ctx = np.random.default_rng(4).normal(
        size=(2, cfg.context_length, cfg.transformer_width)).astype(np.float32)
    want = _apply(jmodel.CLIPTextContextEncoder(_jcfg(cfg)),
                  _sub(variables, "text_encoder"), ids, ctx)
    with torch.no_grad():
        got = tm.text_encoder(torch.from_numpy(ids), torch.from_numpy(ctx))
    _close(got, want)


def test_context_decoder_matches_jax():
    cfg, _, tm, variables = _built("rn")
    rng = np.random.default_rng(5)
    text = rng.normal(size=(2, cfg.num_classes, cfg.embed_dim)).astype(np.float32)
    visual = rng.normal(size=(2, 5, cfg.embed_dim)).astype(np.float32)
    want = _apply(jmodel.ContextDecoder(_jcfg(cfg)),
                  _sub(variables, "context_decoder"), text, visual)
    with torch.no_grad():
        got = tm.context_decoder(torch.from_numpy(text), torch.from_numpy(visual))
    _close(got, want)


@pytest.mark.parametrize("case", ["rn", "vit16"])
def test_forward_with_score_map_matches_jax(case):
    cfg, ids, tm, variables = _built(case)
    x = _images()
    want, want_score = _apply(jmodel.DenseCLIP(_jcfg(cfg), class_token_ids=ids),
                              variables, x, with_score_map=True)
    with torch.no_grad():
        got, score = tm(torch.from_numpy(x), with_score_map=True)
    assert tuple(got.shape) == (2, cfg.num_classes, 64, 64)
    _close(got, want)
    _close(score, want_score)


# --- losses, inference, schedule, groups --------------------------------------

def _labels(b=2, k=5, h=16, w=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, (b, h, w)).astype(np.int32)
    labels[0, :5] = 255
    labels[1, :, :3] = 255
    return labels


@pytest.mark.parametrize("avg_non_ignore", [False, True])
def test_cross_entropy_seg_matches_jax(avg_non_ignore):
    logits = np.random.default_rng(1).normal(size=(2, 5, 16, 16)).astype(np.float32)
    labels = _labels()
    want = jloss.cross_entropy_seg(logits, labels, avg_non_ignore=avg_non_ignore)
    got = tloss.cross_entropy_seg(torch.from_numpy(logits), torch.from_numpy(labels),
                                  avg_non_ignore=avg_non_ignore)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    # every pixel ignored: zero, not a division by zero
    ignored = np.full_like(labels, 255)
    assert tloss.cross_entropy_seg(torch.from_numpy(logits),
                                   torch.from_numpy(ignored),
                                   avg_non_ignore=avg_non_ignore).item() == 0.0


def test_denseclip_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 16, 16)).astype(np.float32)
    score = (0.3 * rng.normal(size=(2, 5, 4, 4))).astype(np.float32)
    labels = _labels()
    want = jloss.denseclip_losses(logits, score, labels)
    got = tloss.denseclip_losses(torch.from_numpy(logits), torch.from_numpy(score),
                                 torch.from_numpy(labels))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=key)


def test_slide_inference_matches_jax():
    """A 64 x 150 image, crop 64, stride 43: one row of ceil((150 - 64) / 43)
    + 1 = 3 windows, the last clamped to start at 86; logits that depend on
    each window's content; the averaged logits and the argmax map, and a
    crop as large as the image equals whole inference."""
    img = np.random.default_rng(6).normal(size=(2, 3, 64, 150)).astype(np.float32)
    weight = np.random.default_rng(7).normal(size=(4, 3)).astype(np.float32)

    def jfn(x):
        x = jnp.asarray(x)
        return jnp.einsum("kc,bchw->bkhw", weight, x) + x.mean(axis=(1, 2, 3))[
            :, None, None, None]

    def tfn(x):
        return (torch.einsum("kc,bchw->bkhw", torch.from_numpy(weight), x)
                + x.mean(dim=(1, 2, 3))[:, None, None, None])

    assert tinference.window_starts(150, 64, 43) == [0, 43, 86]
    want = jinference.slide_inference(jfn, img, (64, 64), (43, 43))
    got = tinference.slide_inference(tfn, torch.from_numpy(img), (64, 64), (43, 43))
    _close(got, want)
    np.testing.assert_array_equal(
        tinference.slide_predict(tfn, torch.from_numpy(img), (64, 64),
                                 (43, 43)).numpy(),
        np.asarray(jinference.slide_predict(jfn, img, (64, 64), (43, 43))))
    whole = tinference.whole_inference(tfn, torch.from_numpy(img))
    _close(tinference.slide_inference(tfn, torch.from_numpy(img), (64, 150),
                                      (43, 43)), whole.numpy())


def test_poly_warmup_schedule_matches_jax():
    """At step 0, at the end of warm-up, mid-run, at the total and past it.
    The JAX schedule computes in f32, where 1 - 1e-6 rounds to 1 - 1.0133e-6
    (the spacing of f32 near 1 is 6e-8), so step 0's warm-up factor is 1.3%
    above the exact 1e-6: 2e-2 there; at step 1 the factor 1 - (1 - 1/1500)
    (1 - 1e-6) = 6.7e-4 cancels to 9e-5 of itself in f32: 1e-4 there."""
    kw = dict(power=0.9, min_lr=1e-6, warmup_iters=1500, warmup_ratio=1e-6)
    want = jtask.poly_warmup_schedule(1e-4, 80_000, **kw)
    got = ttask.poly_warmup_schedule(1e-4, 80_000, **kw)
    np.testing.assert_allclose(got(0), float(want(0)), rtol=2e-2)
    np.testing.assert_allclose(got(0), 1e-4 * 1e-6, rtol=1e-9)
    np.testing.assert_allclose(got(1), float(want(1)), rtol=1e-4)
    for step in (750, 1500, 40_000, 80_000, 90_000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   err_msg=str(step))
    assert got(80_000) == got(90_000) == pytest.approx(1e-6)


@pytest.mark.parametrize("case", ["rn", "vit16"])
def test_name_map_and_group_labels_match_jax(case):
    """Every leaf of the JAX DenseCLIP's `init` (params and batch_stats) maps
    onto exactly one tensor of the port's `state_dict` at the same shape
    (transposed for Dense kernels), nothing left over either way; every
    parameter's paramwise group is the JAX `_group_label`'s."""
    cfg = tmodel.DenseCLIPConfig.tiny(**CONFIGS[case])
    ids = _class_ids(cfg)
    shapes = jax.eval_shape(jmodel.DenseCLIP(_jcfg(cfg), class_token_ids=ids).init,
                            KEY, _images())
    tm = build_denseclip(cfg, ids, device="cpu")
    own = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    mapped = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in flatten_params(shapes.get(collection, {})).items():
            name, transpose = port_name(path)
            assert name not in mapped, name
            mapped[name] = tuple(leaf.shape)[::-1] if transpose else tuple(leaf.shape)
    assert mapped == own
    params = flatten_params(shapes["params"])
    want = {port_name(p)[0]: jtask._group_label(p, v) for p, v in params.items()}
    assert ttask.group_labels(tm) == want
    for name in ("contexts", "gamma", "text_encoder.text_projection",
                 "text_encoder.positional_embedding"):
        assert want[name] == "base_no_decay", name
    assert want["decode_head.cls_seg.weight"] == "base_decay"
    assert want["backbone.conv1.weight"] == "backbone_decay"
    if case == "vit16":
        assert want["backbone.proj"] == "backbone_no_decay"
        assert want["backbone.fpn1_deconv1.weight"] == "backbone_decay"
        assert want["backbone.fpn1_gn.weight"] == "backbone_no_decay"


def test_fpn_baseline_name_map_covers_every_leaf():
    for case in ("rn", "vit8"):
        cfg = tmodel.DenseCLIPConfig.tiny(**CONFIGS[case])
        shapes = jax.eval_shape(jmodel.CLIPFPNBaseline(_jcfg(cfg)).init, KEY,
                                _images())
        tm = tmodel.CLIPFPNBaseline(cfg)
        mapped = {port_name(p)[0] for c in shapes.values()
                  for p in flatten_params(c)}
        assert mapped == set(tm.state_dict()), case


# --- the task -------------------------------------------------------------------

LR, STEPS = 1e-3, 3
TASK_KW = dict(learning_rate=LR, weight_decay=1e-2, total_iters=10,
               warmup_iters=2, image_stats=IMAGENET)


def _train_batch(cfg, b=2, size=64, seed=8):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    labels = np.broadcast_to((yy // 16 + xx // 16) % cfg.num_classes,
                             (b, size, size)).astype(np.int32).copy()
    labels[:, :4] = 255
    return {"image": rng.integers(0, 256, (b, 3, size, size), dtype=np.uint8),
            "label": labels}


@pytest.fixture(scope="module")
def trained():
    """Three train steps of both packages from the same weights on one batch:
    tiny RN, head dropout 0, `bn_train`, uint8 images. The JAX state is the
    one `DenseCLIPTask.init` builds (text encoder in `frozen`, batch
    statistics in `model_state`, AdamW state over the rest), around the
    port's seeded weights as a JAX tree rather than Flax's `init`."""
    from tunevlseg_tpu.training.task import TrainState as JTrainState
    torch.set_num_threads(1)
    cfg, ids, tm, variables = _built("rn", cfg_kw=dict(head_dropout=0.0),
                                     bn_train=True)
    batch = _train_batch(cfg)
    jt = jtask.DenseCLIPTask(
        jmodel.DenseCLIP(_jcfg(cfg), class_token_ids=ids, bn_train=True), **TASK_KW)
    params = variables["params"]
    trainable = {k: v for k, v in params.items() if k != "text_encoder"}
    frozen = {"params": {"text_encoder": params["text_encoder"]}}
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable, jt.tx.init(trainable),
                         jax.random.fold_in(KEY, 1),
                         {"batch_stats": variables["batch_stats"]})
    tt = ttask.DenseCLIPTask(tm, **TASK_KW)
    tstate = tt.init()
    start = copy.deepcopy(tm.state_dict())

    @jax.jit
    def jstep(state, batch):
        rng = jax.random.fold_in(state.rng, state.step)
        grads = jax.grad(lambda t: jt._loss(t, state.model_state, frozen, batch,
                                            rng)[0])(state.trainable)
        return jt.train_step(state, frozen, batch), grads

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    steps = []
    for _ in range(STEPS):
        (jstate, jmetrics), jgrads = jstep(jstate, batch)
        tstate, tmetrics = tt.train_step(tstate, tbatch)
        tgrads = {n: p.grad.clone() for n, p in tm.named_parameters()
                  if p.grad is not None}
        steps.append((jmetrics, trainable_from_jax(jgrads, tm), tmetrics, tgrads))
    return dict(cfg=cfg, batch=batch, steps=steps, jt=jt, jstate=jstate,
                frozen=frozen, tt=tt, tstate=tstate, start=start,
                want_weights=trainable_from_jax(jstate.trainable, tm),
                want_stats=trainable_from_jax(jstate.model_state["batch_stats"], tm))


def test_train_steps_losses_and_first_gradients_match_jax(trained):
    n_valid = int((trained["batch"]["label"] != 255).sum())
    for jmetrics, _, tmetrics, _ in trained["steps"]:
        assert set(tmetrics) == set(jmetrics) == {"loss", "loss_decode",
                                                  "loss_aux_identity", "acc"}
        for key in ("loss", "loss_decode", "loss_aux_identity"):
            np.testing.assert_allclose(tmetrics[key].item(), float(jmetrics[key]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=key)
        assert abs(tmetrics["acc"].item() - float(jmetrics["acc"])) <= 1.01 / n_valid
    _, jgrads, _, tgrads = trained["steps"][0]
    assert set(tgrads) == set(jgrads)
    assert not any(n.startswith("text_encoder.") for n in tgrads)
    overall = max(g.abs().max().item() for g in jgrads.values())
    for name, g in jgrads.items():
        if name.endswith("k_proj.bias"):
            # zero in exact arithmetic (a softmax does not see a shift shared
            # by all its keys): rounding noise on both sides
            assert max(g.abs().max().item(),
                       tgrads[name].abs().max().item()) <= 1e-6 * overall, name
            continue
        top = g.abs().max().item()
        assert top > 0, name
        assert (tgrads[name] - g).abs().max().item() <= TOL * top, name


def test_weights_and_running_statistics_after_three_steps_match_jax(trained):
    """Adam moves an entry by about lr_t * sign(g) a step: an entry whose
    gradient stays well above the rounding noise (>= 1e-2 of its leaf's
    largest) agrees to 2% of the most its group can travel (lr_mult x the
    sum of the three learning rates); any entry to twice that travel. The
    running statistics of every backbone BatchNorm move in the state and
    agree with the JAX state's; the module's buffers do not move."""
    tt, tm, start = trained["tt"], trained["tt"].model, trained["start"]
    lrs = sum(tt.schedule(s) for s in range(STEPS)) * 1.05
    labels = ttask.group_labels(tm)
    grads = [s[1] for s in trained["steps"]]
    now = tm.state_dict()
    n_robust = 0
    for name, want in trained["want_weights"].items():
        travel = lrs * (tt.backbone_lr_mult if labels[name].startswith("backbone")
                        else 1.0)
        diff = (now[name] - want).abs()
        assert diff.max().item() <= 2 * travel, name
        assert not torch.equal(now[name], start[name]), name
        if name.endswith("k_proj.bias"):
            continue        # Adam steps by the sign of rounding noise there
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust = gmin >= 1e-2 * gtop
        if robust.any():
            assert diff[robust].max().item() <= 0.02 * travel, name
        n_robust += int(robust.sum())
    assert n_robust > 1000
    state = trained["tstate"].model_state
    assert set(state) == set(trained["want_stats"]) and len(state) > 30
    for name, want in trained["want_stats"].items():
        assert not torch.equal(state[name], start[name]), name
        assert torch.equal(now[name], start[name]), name
        _close(state[name], want.numpy())


def test_text_encoder_frozen_and_without_optimizer_state(trained):
    tm, start = trained["tt"].model, trained["start"]
    text = [n for n, _ in tm.named_parameters() if n.startswith("text_encoder.")]
    assert text and all(torch.equal(tm.state_dict()[n], start[n]) for n in text)
    named = dict(tm.named_parameters())
    assert all(not named[n].requires_grad and named[n].grad is None for n in text)
    opt = trained["tstate"].optimizer
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    assert not held & {id(named[n]) for n in text}
    assert len(opt.optimizer.state) == len(named) - len(text) == len(held)
    groups = {g["name"]: g for g in opt.param_groups}
    assert set(groups) == {"backbone_decay", "backbone_no_decay", "base_decay",
                           "base_no_decay"}
    assert groups["backbone_decay"]["lr"] == pytest.approx(
        0.1 * groups["base_decay"]["lr"])
    assert groups["base_no_decay"]["weight_decay"] == 0.0
    assert groups["base_decay"]["weight_decay"] == 1e-2
    assert trained["tstate"].step == STEPS


def test_eval_step_matches_jax(trained):
    want = jax.jit(trained["jt"].eval_step)(trained["jstate"], trained["frozen"],
                                           trained["batch"])
    got = trained["tt"].eval_step(trained["tstate"], {
        k: torch.from_numpy(v) for k, v in trained["batch"].items()})
    n_valid = int((trained["batch"]["label"] != 255).sum())
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=10 * LOSS_TOL, atol=10 * LOSS_TOL)
    assert abs(got["acc"].item() - float(want["acc"])) <= 1.01 / n_valid


def test_multistep_equals_sequential_steps():
    """`compile_train_multistep(2)` takes the same two eager steps: the
    weights bit-identical, the metrics the mean of the two."""
    cfg = tmodel.DenseCLIPConfig.tiny(head_dropout=0.1)
    ids = _class_ids(cfg)
    b1, b2 = (_train_batch(cfg, seed=s) for s in (1, 2))
    b1, b2 = ({k: torch.from_numpy(v) for k, v in b.items()} for b in (b1, b2))
    runs = []
    for multi in (False, True):
        tm = build_denseclip(cfg, ids, bn_train=True, device="cpu", seed=2)
        task = ttask.DenseCLIPTask(tm, **TASK_KW)
        state = task.init()
        if multi:
            state, m = task.compile_train_multistep(2)(
                state, {k: torch.stack([b1[k], b2[k]]) for k in b1})
        else:
            state, m1 = task.train_step(state, b1)
            state, m2 = task.train_step(state, b2)
            m = {k: (m1[k] + m2[k]) / 2 for k in m1}
        runs.append((tm.state_dict(), state, m))
    (w0, s0, m0), (w1, s1, m1) = runs
    assert s0.step == s1.step == 2
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
    assert all(torch.equal(s0.model_state[k], s1.model_state[k]) for k in s0.model_state)
    for k in m0:
        np.testing.assert_allclose(m1[k].item(), m0[k].item(), rtol=1e-6)


def test_unported_task_options_raise():
    tm = build_denseclip(tmodel.DenseCLIPConfig.tiny(), device="cpu")
    # remat and accumulation are ported; a window is a whole number >= 1
    task = ttask.DenseCLIPTask(tm, remat=True, accumulate_grad_batches=2)
    assert task.init().optimizer.accumulate_steps == 2
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        ttask.DenseCLIPTask(tm, accumulate_grad_batches=0)
    task = ttask.DenseCLIPTask(tm)
    # DDP / fully_shard need a process group (tests/test_torch_distributed.py
    # runs two ranks)
    with pytest.raises(ValueError, match="needs a process group"):
        task.compile_steps()
    with pytest.raises(ValueError, match="needs a process group"):
        task.state_fsdp_shardings(task.init())


def test_build_denseclip_needs_a_card_unless_given_the_cpu():
    cfg = tmodel.DenseCLIPConfig.tiny()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build_denseclip(cfg)
    model = build_denseclip(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    again = build_denseclip(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    with pytest.raises(ValueError, match="class_token_ids"):
        model(torch.zeros(1, 3, 64, 64))


# --- the trainer script ---------------------------------------------------------

@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "torch_train_denseclip", ROOT / "scripts" / "torch_train_denseclip.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


BASE_ARGS = ["--synthetic", "--tiny", "--device", "cpu", "--batch", "4",
             "--warmup-iters", "2", "--lr", "3e-3"]


def test_trainer_script_runs_and_resumes(script, tmp_path):
    out = tmp_path / "dc"
    final = script.main(BASE_ARGS + ["--iters", "6", "--val-every", "3",
                                     "--log-every", "2", "--out", str(out)])
    assert np.isfinite(final["loss"])
    assert (out / "checkpoints" / "last").exists()
    assert (out / "checkpoints" / "frozen").exists()
    first = [json.loads(ln)["iter"]
             for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert first[-1] == 6 and max(first) == 6
    final_r = script.main(BASE_ARGS + ["--iters", "10", "--val-every", "3",
                                       "--log-every", "2", "--resume",
                                       "--out", str(out)])
    assert np.isfinite(final_r["loss"])
    iters = [json.loads(ln)["iter"]
             for ln in (out / "metrics.jsonl").read_text().splitlines()]
    # the resumed run logged only iterations past the saved 6, up to 10
    assert iters[:len(first)] == first
    assert min(iters[len(first):]) > 6 and iters[-1] == 10


def test_trainer_script_spe_equals_sequential_steps(script, tmp_path):
    """`--spe 4` takes the same four steps on the same batches: the saved
    trainable weights, AdamW moments and step bit-identical, and the same
    validation on the same batch after them."""
    args = BASE_ARGS + ["--iters", "4", "--val-every", "4", "--log-every", "1"]
    script.main(args + ["--out", str(tmp_path / "seq")])
    script.main(args + ["--spe", "4", "--out", str(tmp_path / "spe")])
    a, b = (torch.load(tmp_path / run / "checkpoints" / "last" / "state.pt",
                       map_location="cpu", weights_only=True)
            for run in ("seq", "spe"))
    assert a["step"] == b["step"] == 4
    assert set(a["trainable"]) == set(b["trainable"])
    assert all(torch.equal(a["trainable"][k], b["trainable"][k])
               for k in a["trainable"])
    moments = [[(s["exp_avg"], s["exp_avg_sq"]) for s in x["optimizer"]["state"].values()]
               for x in (a, b)]
    assert all(torch.equal(p, q) for m, n in zip(*moments) for p, q in zip(m, n))
    metas = [json.loads((tmp_path / run / "checkpoints" / "best.json").read_text())
             for run in ("seq", "spe")]
    assert metas[0]["val_loss"] == metas[1]["val_loss"]


@pytest.mark.parametrize("backbone", ["vitb16", "rn101"])
def test_trainer_script_backbones(script, tmp_path, backbone):
    final = script.main(BASE_ARGS + ["--backbone", backbone, "--iters", "2",
                                     "--val-every", "2", "--log-every", "1",
                                     "--out", str(tmp_path / backbone)])
    assert np.isfinite(final["loss"])


# --fsdp runs, with --remat and --accumulate too: over one rank there is
# nothing to shard, so the script runs the plain path and makes no group
@pytest.mark.parametrize("flag", [["--fsdp"], ["--remat", "--fsdp"],
                                  ["--accumulate", "2", "--fsdp"]])
def test_trainer_script_unported_flags_raise(script, tmp_path, flag,
                                             monkeypatch):
    from tunevlseg_torch.parallel import data_parallel, distributed

    def no_shard(*args, **kwargs):
        raise AssertionError("fully_shard over one rank")
    monkeypatch.setattr(data_parallel, "shard", no_shard)
    final = script.main(BASE_ARGS + flag + ["--iters", "2", "--val-every", "2",
                                            "--out", str(tmp_path / "x")])
    assert np.isfinite(final["loss"])
    assert (tmp_path / "x" / "checkpoints" / "last").is_dir()
    assert not distributed.is_initialized()


def test_trainer_script_remat_and_accumulate(script, tmp_path):
    """`--remat --accumulate 2`: two micro-steps, one update, under the
    loss's checkpoint."""
    final = script.main(BASE_ARGS + ["--remat", "--accumulate", "2", "--iters", "2",
                                     "--val-every", "2", "--out", str(tmp_path / "ra")])
    assert np.isfinite(final["loss"])


def test_trainer_script_class_names_through_the_tokenizer(script, tmp_path):
    """`--classes/--vocab` on a synthetic CLIP merges file, DenseCLIP vocab
    layout: the model takes one class a name."""
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\np o\nl y\npo ly\npolyp </w>\nw a\nwa ll</w>\n")
    classes = tmp_path / "classes.txt"
    classes.write_text("polyp\nwall\nsky\n")
    final = script.main(BASE_ARGS + ["--classes", str(classes), "--vocab", str(merges),
                                     "--iters", "2", "--val-every", "2",
                                     "--out", str(tmp_path / "names")])
    assert np.isfinite(final["loss"])

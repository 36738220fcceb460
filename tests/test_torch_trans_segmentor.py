"""The TransformerSegmentor slice of the port against the JAX package, f32 on
the CPU, on the same weights in both (the port's seeded weights as a JAX
tree, or the JAX task's `init` carried over by `state_dict_from_jax`): the
whole model for both encoder families and both
projection modes, with the position encoding, prompt dedup, no attention
mask, the three upsampler norms, an output bias and an input larger than
the towers' pretraining grid (position embeddings resized, CLS strip); the
SigLIP towers alone with the attention-pool head; the upsampler on the flat
layout (K4's plain version here) against the JAX model under
TUNEVLSEG_PALLAS_CONV and against the port's "nchw", and the channel padding
around K4 with its gradients; a train step's loss and every gradient and
the weights after three steps against the JAX `SegmentationTask`, with the
towers trained and frozen; the trainable set and decay labels against the
JAX `FreezeSpec`; the dropout masks' (seed, step) rule; and the full-width
parameter set of the bench and PhraseCut configurations. Sizes are
`TransSegmentorConfig.tiny` at 32^2 (48^2 where stated). On the CPU every
attention of the port takes the plain path.

Tolerances: logits and probabilities 1e-4 (f32, the same formulas, sums in
another order, as tests/test_torch_clipseg.py), loss 1e-5, every gradient
1e-4 of its leaf's largest entry (the key projections' biases, whose
gradient is zero in exact arithmetic, under 1e-6 of the largest of all)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.trans_segmentor import model as jmodel  # noqa: E402
from tunevlseg_tpu.models.trans_segmentor import siglip as jsiglip  # noqa: E402
from tunevlseg_tpu.training import optim as joptim  # noqa: E402
from tunevlseg_tpu.training.optim import merge_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params,  # noqa: E402
                                              port_name, state_dict_from_jax,
                                              trainable_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.trans_segmentor import model as tmodel  # noqa: E402
from tunevlseg_torch.models.trans_segmentor import siglip as tsiglip  # noqa: E402
from tunevlseg_torch.nn.conv import Conv2d  # noqa: E402
from tunevlseg_torch.nn.layers import (Dense, Embed, LayerNorm,  # noqa: E402
                                       init_params)
from tunevlseg_torch.serving import task_predict_fn  # noqa: E402
from tunevlseg_torch.training import optim as toptim  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask as TTask  # noqa: E402

TOL = 1e-4
LOSS_TOL = 1e-5
KEY = jax.random.PRNGKey(0)


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
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _batch(seed=0, b=4, unique=2, img=32, dedup=True, mask=True):
    """uint8 images, {0, 1} masks, CLIP-style ids (BOS, words, EOS, padding
    with 0) with their attention mask, one padded sample (`valid` 0), and
    `unique` prompt rows with `text_index` (or the dense rows)."""
    rng = np.random.default_rng(seed)
    rows = unique if dedup else b
    ids = rng.integers(3, 1000, (rows, 12)).astype(np.int32)
    ids[:, 0] = 49406
    lengths = [12 - 4 * (i % 2) for i in range(rows)]
    for i, n in enumerate(lengths):
        ids[i, n - 1] = 49407
        ids[i, n:] = 0
    batch = {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
             "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
             "input_ids": ids,
             "valid": np.array([1] * (b - 1) + [0], np.float32)}
    if mask:
        batch["attention_mask"] = (ids != 0).astype(np.int32)
    if dedup:
        batch["text_index"] = (np.arange(b) % unique).astype(np.int32)
    return batch


def _jax_params(model):
    """The port's weights as the JAX param tree: `state_dict_from_jax`'s
    mapping run backwards (Dense weights transposed to `kernel`, norm
    weights to `scale`, embedding tables to `embedding`). Building the JAX
    tree from the port's seeded weights spares the tests Flax's `init`
    (seconds a model on the CPU); `_pair` and the trainable-set test use the
    JAX `init` itself."""
    scaled = (LayerNorm, tmodel.GroupNorm)
    tree = {}
    for prefix, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            path = list(toptim.param_path(f"{prefix}.{leaf}" if prefix else leaf))
            value = p.detach().numpy()
            if leaf == "weight" and isinstance(module, Dense):
                path[-1], value = "kernel", value.T
            elif leaf == "weight" and isinstance(module, scaled):
                path[-1] = "scale"
            elif leaf == "weight" and isinstance(module, Embed):
                path[-1] = "embedding"
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = jnp.asarray(value)
    return tree


def _models(cfg_kw, layout="nchw"):
    """The port's model (seeded weights) and the JAX model with the same
    weights, as (port model, JAX module, JAX params)."""
    tm, _ = tpresets.build_trans_segmentor(
        tmodel.TransSegmentorConfig.tiny(**cfg_kw), upsampler_layout=layout,
        device="cpu", seed=1)
    params = _jax_params(tm)
    back = state_dict_from_jax(params, tm)
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    return tm, jmodel.TransformerSegmentor(
        jmodel.TransSegmentorConfig.tiny(**cfg_kw)), params


def _jax_logits(jm, params, batch):
    return np.asarray(jax.jit(jm.apply)(
        {"params": params}, batch["input_ids"],
        (batch["image"].astype(np.float32) / 255.0 - 0.45) / 0.25,
        batch.get("attention_mask"),
        **({"text_index": batch["text_index"]} if "text_index" in batch else {})))


def _port_logits(tm, batch):
    tb = _torch(batch)
    with torch.no_grad():
        return tm(tb["input_ids"], (tb["image"].float() / 255.0 - 0.45) / 0.25,
                  tb.get("attention_mask"), text_index=tb.get("text_index"))


def _same_gradients(got: dict, want: dict) -> None:
    """Every gradient within TOL of its leaf's largest entry. The key
    projections' biases get a zero gradient in exact arithmetic (the softmax
    does not see a shift of every score of a row), so theirs is rounding
    noise on both sides: held under 1e-6 of the largest gradient of all."""
    overall = max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        if name.endswith("k_proj.bias"):
            assert max(g.abs().max().item(),
                       got[name].abs().max().item()) <= 1e-6 * overall, name
            continue
        top = g.abs().max().item()
        assert top > 0, name
        assert (got[name] - g).abs().max().item() <= TOL * top, name


def _pair(cfg_kw, batch, freeze_encoders=False, **task_kw):
    """The JAX task and the port's on the same weights (JAX `init`)."""
    jc = jmodel.TransSegmentorConfig.tiny(**cfg_kw)
    jm = jmodel.TransformerSegmentor(jc)
    always = () if jc.use_existing_proj else ("text_projection",)
    jspec = joptim.FreezeSpec(freeze_all=False, freeze_encoder=freeze_encoders,
                              family="trans_segmentor", always_trainable=always)
    jtask = JTask(jm, jspec, **task_kw)
    jstate, frozen = jtask.init(KEY, batch)
    params = merge_params(jstate.trainable, frozen["params"])
    tm, tspec = tpresets.build_trans_segmentor(
        tmodel.TransSegmentorConfig.tiny(**cfg_kw), freeze_encoders,
        device="cpu", seed=1)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    return jtask, jstate, frozen, params, TTask(tm, tspec, **task_kw)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --- the whole model ----------------------------------------------------------

FORWARD_CASES = {
    # bench's trans_seg shape: CLIP, existing projections; prompt dedup
    "clip-proj-dedup-output_bias": (dict(output_bias=-1.75), {}),
    "clip-fresh_proj-pos_enc-no_mask": (
        dict(use_existing_proj=False, add_pos_enc=True), dict(mask=False)),
    # PhraseCut's shape: SigLIP with the existing projections, an input
    # larger than the pretraining grid (positions resized, 3 x 3 tokens)
    "siglip-proj-group_norm-48": (
        dict(encoder_family="siglip", upsampler_norm="group",
             upsampler_group_channels=5, image_size=48), dict(img=48)),
    "siglip-fresh_proj-no_norm-dense": (
        dict(encoder_family="siglip", use_existing_proj=False,
             upsampler_norm=None), dict(dedup=False)),
    # 3 x 3 patches + CLS = 10 tokens: the CLS strip
    "clip-48-two_outputs": (dict(image_size=48, num_output_channels=2),
                            dict(img=48)),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_trans_segmentor_matches_jax(case):
    cfg_kw, batch_kw = FORWARD_CASES[case]
    batch = _batch(**batch_kw)
    tm, jm, params = _models(cfg_kw)
    want = _jax_logits(jm, params, batch)
    got = _port_logits(tm, batch)
    img = batch["image"].shape[-1]
    assert got.shape == (4, cfg_kw.get("num_output_channels", 1), img, img)
    assert np.abs(want).max() > 1e-2
    _close(got, want)
    ttask = TTask(tm)
    tbatch = _torch(batch)
    probs = ttask.predict_step(tbatch)
    served = task_predict_fn(ttask)(dict(tm.state_dict()), tbatch)
    torch.testing.assert_close(served, probs, rtol=0, atol=0)
    if "text_index" in tbatch:       # prompt dedup equals the dense call
        dense = dict(tbatch)
        idx = dense.pop("text_index").long()
        dense["input_ids"] = tbatch["input_ids"][idx]
        if "attention_mask" in tbatch:
            dense["attention_mask"] = tbatch["attention_mask"][idx]
        torch.testing.assert_close(ttask.predict_step(dense), probs, rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("use_head", [False, True])
def test_siglip_towers_match_jax(use_head):
    """Both towers alone; the vision tower at 48^2 over its 32^2 grid
    (bilinear position resize), with the attention-pool head when asked;
    the text tower with a padding mask and without one."""
    cfg = jmodel.TransSegmentorConfig.tiny(encoder_family="siglip")
    rng = np.random.default_rng(3)
    pix = rng.normal(size=(2, 3, 48, 48)).astype(np.float32)
    jv = jsiglip.SiglipVisionTower(cfg.vision, use_head=use_head)
    tv = tsiglip.SiglipVisionTower(
        tmodel.TransSegmentorConfig.tiny().vision, use_head=use_head)
    init_params(tv, torch.Generator().manual_seed(2))
    vv = {"params": _jax_params(tv)}
    want_hidden, want_last, want_pooled = jax.jit(jv.apply)(vv, pix)
    with torch.no_grad():
        hidden, last, pooled = tv(torch.from_numpy(pix))
    assert len(hidden) == len(want_hidden) == 3
    for got, want in zip(hidden + [last], list(want_hidden) + [want_last]):
        _close(got, want)
    assert last.shape == (2, 9, 24)
    if use_head:
        assert pooled.shape == (2, 24)
        _close(pooled, want_pooled)
    else:
        assert pooled is None and want_pooled is None

    ids = rng.integers(3, 1000, (3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    jt = jsiglip.SiglipTextTower(cfg.text)
    tt = tsiglip.SiglipTextTower(tmodel.TransSegmentorConfig.tiny().text)
    init_params(tt, torch.Generator().manual_seed(3))
    vt = {"params": _jax_params(tt)}
    for m in (mask, None):
        want_x, want_p = jax.jit(jt.apply)(vt, ids, m)
        with torch.no_grad():
            x, p = tt(torch.from_numpy(ids),
                      None if m is None else torch.from_numpy(m))
        _close(x, want_x)
        _close(p, want_p)


# --- the flat upsampler (K4) ---------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [dict(output_bias=-1.5),
                                    dict(encoder_family="siglip",
                                         upsampler_norm=None, image_size=48)],
                         ids=["clip-layer_norm", "siglip-no_norm-48"])
def test_flat_upsampler_matches_jax_and_nchw(cfg_kw, monkeypatch):
    """The whole model with `upsampler_layout="flat"` against the JAX model
    under TUNEVLSEG_PALLAS_CONV=1 (its flat upsampler; the jnp reference of
    the Pallas kernel on the CPU) and against the port's "nchw" on the same
    weights; the gradients of every parameter for one loss agree too."""
    monkeypatch.setenv("TUNEVLSEG_PALLAS_CONV", "1")
    batch = _batch(img=cfg_kw.get("image_size", 32))
    tflat, jm, params = _models(cfg_kw, layout="flat")
    assert tflat.upsampler.layout == "flat"
    nchw, _ = tpresets.build_trans_segmentor(
        tmodel.TransSegmentorConfig.tiny(**cfg_kw), device="cpu")
    assert nchw.upsampler.layout == "nchw"          # the default
    nchw.load_state_dict(tflat.state_dict())
    got = _port_logits(tflat, batch)
    _close(got, _jax_logits(jm, params, batch))
    _close(got, _port_logits(nchw, batch))
    assert got.std().item() > 1e-3
    tbatch = _torch(batch)

    def grads(model):
        model.zero_grad()
        TTask(model)._forward(tbatch).square().mean().backward()
        return {n: p.grad for n, p in model.named_parameters()
                if p.grad is not None}

    g_flat, g_nchw = grads(tflat), grads(nchw)
    assert set(g_flat) == set(g_nchw)
    _same_gradients(g_flat, g_nchw)


@pytest.mark.parametrize("c,cout,bias", [(10, 1, True), (20, 10, False),
                                         (16, 8, True)])
def test_conv3_flat_pads_channels_around_k4(c, cout, bias):
    """`conv3_flat` (C and Cout zero-padded to multiples of 8 around the
    flat convolution, the bias as its offset, sliced back) is the VALID 3x3
    convolution of the replicate-padded input, forward and every gradient;
    at bf16 its output is K4's plain version's, cast once."""
    g = torch.Generator().manual_seed(0)
    conv = Conv2d(c, cout, 3, bias=bias)
    init_params(conv, g)
    if bias:
        with torch.no_grad():
            conv.bias.normal_(generator=g)
    x = torch.randn(2, c, 9, 9, generator=g, requires_grad=True)
    dy = torch.randn(2, cout, 7, 7, generator=g)
    got = tmodel.conv3_flat(x, conv)
    want = F.conv2d(x, conv.weight, conv.bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    got_grads = torch.autograd.grad(got, [x, *conv.parameters()], dy)
    want_grads = torch.autograd.grad(want, [x, *conv.parameters()], dy)
    for a, b in zip(got_grads, want_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    low = tmodel.conv3_flat(x.detach().bfloat16(), conv)
    assert low.dtype == torch.bfloat16 and low.shape == want.shape
    assert (low.float() - want).abs().max().item() <= 0.05 * want.abs().max().item()


def test_upsampler_stages_and_layouts():
    full = tmodel.TransSegmentorConfig(image_size=352)
    assert tmodel.upsampler_stages(full) == [
        (512, 410, 39), (410, 308, 68), (308, 206, 119), (206, 104, 208),
        (104, 1, 352)]
    for layout in ("nchw", "flat"):
        assert tmodel.Upsampler(full, layout).sizes == [39, 68, 119, 208, 352]
    with pytest.raises(ValueError, match="TPU layout experiment"):
        tmodel.Upsampler(full, "nhwc")
    # the JAX upsampler walks the same sizes
    cfg = jmodel.TransSegmentorConfig(image_size=352)
    x = jax.ShapeDtypeStruct((1, 512, 22, 22), jnp.float32)
    shapes = jax.eval_shape(jmodel.Upsampler(cfg).init, KEY, x)["params"]
    assert [shapes[f"block{i}_norm"]["scale"].shape[1] for i in range(4)] == [
        39, 68, 119, 208]


# --- training ------------------------------------------------------------------

LR, STEPS = 1e-3, 3
TRAVEL = STEPS * LR * 1.05
TRAIN_CASES = {
    # the bench row at tiny size: CLIP, everything trains
    "clip-full_finetune": (dict(), False),
    # PhraseCut's at tiny size: SigLIP, frozen towers, output bias
    "siglip-frozen_towers": (dict(encoder_family="siglip", output_bias=-1.7),
                             True),
}
# trainable parameters that nothing the loss reads depends on: the CLIP
# vision tower's post_layernorm (feeds only the pooled output) and the SigLIP
# text tower's head (the pooled last token); JAX gives them zero gradients
NO_GRADIENT = ("vision_model.post_layernorm.", "text_model.head.")


@pytest.fixture(scope="module", params=list(TRAIN_CASES))
def trained(request):
    """Three train steps of both packages from the same weights on one
    batch (dropout 0 in the tiny config; U = 2 prompt rows, one padded
    sample)."""
    cfg_kw, freeze = TRAIN_CASES[request.param]
    torch.set_num_threads(1)
    clip = 0.5
    hp = dict(learning_rate=LR, weight_decay=0.01, grad_clip_norm=clip)
    batch = _batch()
    jtask, jstate, frozen, _, ttask = _pair(cfg_kw, batch, freeze_encoders=freeze,
                                            **hp)
    tstate = ttask.init()
    start = copy.deepcopy(ttask.model.state_dict())

    @jax.jit
    def jstep(state, frozen, batch):
        rng = jax.random.fold_in(state.rng, state.step)
        grads = jax.grad(lambda t: jtask._loss(t, state.model_state, frozen,
                                               batch, rng)[0])(state.trainable)
        return jtask.train_step(state, frozen, batch), grads

    tbatch = _torch(batch)
    steps = []
    for _ in range(STEPS):
        (jstate, jmetrics), jgrads = jstep(jstate, frozen, batch)
        tstate, tmetrics = ttask.train_step(tstate, tbatch)
        # the port's step leaves the gradients clipped in place: clip the
        # JAX ones by the same global norm
        norm = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2)
                                  for g in jax.tree_util.tree_leaves(jgrads))))
        jgrads = jax.tree_util.tree_map(lambda g: g * (clip / max(norm, clip)),
                                        jgrads)
        tgrads = {n: p.grad.clone() for n, p in ttask.model.named_parameters()
                  if p.grad is not None}
        steps.append((jmetrics, trainable_from_jax(jgrads, ttask.model),
                      tmetrics, tgrads))
    return dict(case=request.param, freeze=freeze, steps=steps,
                model=ttask.model, tstate=tstate, start=start,
                want_weights=trainable_from_jax(jstate.trainable, ttask.model))


def test_train_step_loss_and_gradients_match_jax(trained):
    for jmetrics, _, tmetrics, _ in trained["steps"]:
        for key, value in tmetrics.items():
            np.testing.assert_allclose(value.item(), float(jmetrics[key]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=key)
    _, jgrads, _, tgrads = trained["steps"][0]
    unread = {n for n in jgrads if n.startswith(NO_GRADIENT)}
    assert set(tgrads) == set(jgrads) - unread
    for name in unread:
        assert not jgrads[name].any(), name
    _same_gradients(tgrads, {n: jgrads[n] for n in tgrads})
    towers = any(n.startswith("vision_model.layers.0.") for n in tgrads)
    assert towers == (not trained["freeze"])
    assert any(n.startswith("decoder_layers.1.") for n in tgrads)
    assert any(n.startswith("upsampler.out_conv") for n in tgrads)
    first, last = (s[2]["loss"].item() for s in (trained["steps"][0],
                                                 trained["steps"][-1]))
    assert last < first


def test_weights_after_three_steps_match_jax(trained):
    """Adam moves an entry by about lr * sign(g) a step: an entry whose
    gradient stays well above the rounding noise (>= 1e-2 of its leaf's
    largest) agrees to 2% of the most it can travel, 3 * lr; any entry to
    twice that travel (the key projections' biases, whose gradient is
    rounding noise, only to that). Frozen tensors and the trainable ones
    nothing reads do not move."""
    model, start = trained["model"], trained["start"]
    grads = [s[1] for s in trained["steps"]]
    now = model.state_dict()
    n_robust = 0
    moved = set()
    for name, want in trained["want_weights"].items():
        diff = (now[name] - want).abs()
        assert diff.max().item() <= 2 * TRAVEL, name
        if name.startswith(NO_GRADIENT):
            assert torch.equal(now[name], start[name]), name
            continue
        moved.add(name)
        assert not torch.equal(now[name], start[name]), name
        if name.endswith("k_proj.bias"):
            continue        # Adam steps by the sign of rounding noise there
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust = gmin >= 1e-2 * gtop
        if robust.any():
            assert diff[robust].max().item() <= 0.02 * TRAVEL, name
        n_robust += int(robust.sum())
    assert n_robust > 100
    for name, value in now.items():
        if name not in trained["want_weights"]:
            assert torch.equal(value, start[name]), name
    assert len(trained["tstate"].optimizer.optimizer.state) == len(moved)


@pytest.mark.parametrize("cfg_kw,freeze", [
    (dict(), False), (dict(), True),
    (dict(encoder_family="siglip", use_existing_proj=False), True),
    (dict(encoder_family="siglip", use_existing_proj=False, upsampler_norm="group",
          upsampler_group_channels=8), False)],
    ids=["clip", "clip-frozen", "siglip-fresh_proj-frozen", "siglip-group"])
def test_trainable_set_and_decay_labels_match_jax(cfg_kw, freeze):
    batch = _batch()
    jc = jmodel.TransSegmentorConfig.tiny(**cfg_kw)
    params = jax.eval_shape(
        jmodel.TransformerSegmentor(jc).init, KEY, batch["input_ids"],
        batch["image"].astype(np.float32), batch["attention_mask"],
        text_index=batch["text_index"])["params"]
    always = () if jc.use_existing_proj else ("text_projection",)
    jspec = joptim.FreezeSpec(freeze_all=False, freeze_encoder=freeze,
                              family="trans_segmentor", always_trainable=always)
    tm, tspec = tpresets.build_trans_segmentor(
        tmodel.TransSegmentorConfig.tiny(**cfg_kw), freeze, device="cpu")
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    flat = flatten_params(params)
    assert {port_name(p)[0] for p in flat} == set(dict(tm.named_parameters()))
    want_trainable = {port_name(p)[0] for p in flat if jspec.path_trainable(p)}
    assert set(toptim.apply_freeze(tm, tspec)) == want_trainable
    assert ("text_projection.weight" in want_trainable) == (
        not freeze or not jc.use_existing_proj)
    want_labels = {port_name(p)[0]: joptim.decay_label(p, v) for p, v in flat.items()}
    assert toptim.decay_labels(tm) == want_labels
    assert want_labels["upsampler.block0_conv.weight"] == "decay"
    assert want_labels["upsampler.block0_norm.weight"] == "no_decay"
    assert want_labels["decoder_layers.1.multihead_attn.q_proj.weight"] == "decay"


def test_dropout_masks_are_a_function_of_seed_and_step():
    cfg = tmodel.TransSegmentorConfig.tiny(decoder_dropout=0.2)
    model, spec = tpresets.build_trans_segmentor(cfg, device="cpu")
    batch = _torch(_batch())
    task = TTask(model, spec, seed=3)
    task.init()
    with torch.no_grad():
        a, b = task._loss(batch, 0)[0].item(), task._loss(batch, 0)[0].item()
        c = task._loss(batch, 1)[0].item()
        other_seed = TTask(model, spec, seed=4)._loss(batch, 0)[0].item()
        p1, p2 = task.predict_step(batch), task.predict_step(batch)
    assert a == b
    assert a != c and a != other_seed
    assert torch.equal(p1, p2)
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


# --- configurations --------------------------------------------------------------

def test_port_config_is_its_own_copy_of_the_jax_one():
    assert tmodel.TransSegmentorConfig is not jmodel.TransSegmentorConfig
    for make in (lambda c: c(), lambda c: c.tiny(), lambda c: c.siglip_base(),
                 lambda c: c.tiny(encoder_family="siglip", image_size=48)):
        want = make(jmodel.TransSegmentorConfig)
        got = make(tmodel.TransSegmentorConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.effective_projection_dim == want.effective_projection_dim


@pytest.mark.parametrize("name,config", [
    ("bench trans_seg 352", dict(image_size=352)),
    ("phrasecut 384", dict(base="siglip", use_existing_proj=True,
                           decoder_num_heads=16, output_bias=-1.748,
                           image_size=384))])
def test_full_width_param_set_matches_jax(name, config):
    """The JAX trees (shapes only, no compute) and the port's parameters at
    full width hold the same leaves, and the head dims are those the
    kernels are built for."""
    kw = dict(config)
    base = kw.pop("base", "clip")
    make = (lambda c: c.siglip_base(**kw)) if base == "siglip" else (
        lambda c: c(**kw))
    jc, tc = make(jmodel.TransSegmentorConfig), make(tmodel.TransSegmentorConfig)
    img, seq = jc.image_size, jc.text.max_position_embeddings
    shapes = jax.eval_shape(
        jmodel.TransformerSegmentor(jc).init, KEY,
        jax.ShapeDtypeStruct((2, seq), jnp.int32),
        jax.ShapeDtypeStruct((2, 3, img, img), jnp.float32),
        jax.ShapeDtypeStruct((2, seq), jnp.int32))["params"]
    with torch.device("meta"):
        tm = tmodel.TransformerSegmentor(tc)
    want = {}
    for path, leaf in flatten_params(shapes).items():
        port, transpose = port_name(path)
        want[port] = tuple(leaf.shape[::-1] if transpose else leaf.shape)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert set(tpresets.trans_segmentor_head_dims(tc).values()) <= {32, 64}
    if base == "clip":
        assert got["upsampler.block3_norm.weight"] == (104, 208, 208)
        assert got["upsampler.out_conv.weight"] == (1, 104, 3, 3)
        assert got["vision_model.post_layernorm.weight"] == (768,)
    else:
        assert got["vision_model.position_embedding"] == (196, 768)
        assert got["text_model.head.weight"] == (768, 768)
        assert got["visual_projection.weight"] == (512, 768)

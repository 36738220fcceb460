"""Per-layer rematerialisation (`tunevlseg_torch/nn/remat.py`) in the port.

Remat changes when activations are computed, never what: over three train
steps with `remat=True` the losses, every weight and the BatchNorm
statistics of `TrainState.model_state` are bit-identical (`torch.equal`) to
a plain run on the CPU, for CLIPSeg CoOp, CRIS CoOp on "nchw" (the frozen
ResNet's blocks rematted) with decoder dropout, CRIS e2e on "flat" (each
bottleneck's flat convolutions rematted), the TransformerSegmentor
with `decoder_dropout` 0.1 (its decoder layers rematted with the masks
drawn inside them, which the recompute must draw again from the restored
generator), and DenseCLIP `bn_train` under its one checkpoint of the loss.
The `state_dict` keys do not change, a forward under `remat.forced(True)`
equals the plain one (the counterpart of JAX
`tests/test_training.py::test_remat_layers_env_flag_matches_plain`), and
the port's rematted CLIPSeg step agrees with the JAX package's
(`SegmentationTask(remat=True)`) at the strategy-parity tolerances of
`tests/test_torch_strategies.py`."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")

from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.models.cris.model import CRISConfig  # noqa: E402
from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig  # noqa: E402
from tunevlseg_torch.models.trans_segmentor.model import (  # noqa: E402
    TransSegmentorConfig)
from tunevlseg_torch.nn import remat  # noqa: E402
from tunevlseg_torch.training.denseclip_task import DenseCLIPTask  # noqa: E402
from tunevlseg_torch.convert.from_jax import trainable_from_jax  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402
from tests.test_torch_accumulate import jax_clipseg_pair  # noqa: E402
from tests.test_torch_accumulate import _synthetic_batch as synthetic_batch  # noqa: E402

STEPS = 3
# the strategy-parity tolerances (tests/test_torch_strategies.py): f32 on
# the CPU in both packages, the same formulas, sums in another order
SCALAR_TOL = 1e-5
WEIGHT_TRAVEL_SHARE = 0.02
TORCH_CHECKPOINT = remat._torch_checkpoint


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(rng, rows, seq=12):
    """BOS, words, EOS (the largest id), 0 padding; rows of two lengths."""
    ids = rng.integers(3, 1000, (rows, seq)).astype(np.int32)
    ids[:, 0] = 49406
    for i in range(rows):
        n = seq - 4 * (i % 2)
        ids[i, n - 1] = 49407
        ids[i, n:] = 0
    return ids


def _seg_batch(seed, b=4, img=32, unique=2):
    rng = np.random.default_rng(seed)
    ids = _ids(rng, unique)
    return {"image": torch.from_numpy(rng.integers(0, 256, (b, 3, img, img),
                                                   dtype=np.uint8)),
            "mask": torch.from_numpy((rng.random((b, 1, img, img)) > 0.5)
                                     .astype(np.float32)),
            "input_ids": torch.from_numpy(ids),
            "attention_mask": torch.from_numpy((ids != 0).astype(np.int32)),
            "valid": torch.tensor([1.0] * (b - 1) + [0.0]),
            "text_index": torch.from_numpy((np.arange(b) % unique).astype(np.int32))}


def _dc_batch(cfg, seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    labels = np.broadcast_to((yy // 16 + xx // 16) % cfg.num_classes,
                             (b, size, size)).astype(np.int64).copy()
    labels[:, :4] = 255
    return {"image": torch.from_numpy(rng.integers(0, 256, (b, 3, size, size),
                                                   dtype=np.uint8)),
            "label": torch.from_numpy(labels)}


def _clipseg(remat_on):
    model, spec = tpresets.build_clipseg(
        "coop", prompt_depth=2, num_context=4,
        config=tconfig.CLIPSegConfig.tiny(), device="cpu", seed=1)
    return (SegmentationTask(model, spec, learning_rate=1e-2, grad_clip_norm=1.0,
                             remat=remat_on),
            [_seg_batch(s) for s in range(STEPS)])


def _cris(remat_on):
    model, spec = tpresets.build_cris(
        "coop", prompt_depth=2, num_context=4, config=CRISConfig.tiny(dropout=0.2),
        device="cpu", seed=1)
    return (SegmentationTask(model, spec, learning_rate=1e-2, remat=remat_on,
                             mutable_collections=("batch_stats",)),
            [_seg_batch(s, img=64) for s in range(STEPS)])


def _cris_flat_e2e(remat_on):
    """The whole CRIS trains on the flat layout: each frozen-BatchNorm
    bottleneck's chain of flat convolutions (K4's plain version here)
    recomputes in the backward; the FPN's and projector's BatchNorms update
    their statistics outside every rematted layer."""
    model, spec = tpresets.build_cris(
        "e2e", config=CRISConfig.tiny(dropout=0.2), layout="flat",
        device="cpu", seed=1)
    return (SegmentationTask(model, spec, learning_rate=1e-3, remat=remat_on,
                             mutable_collections=("batch_stats",)),
            [_seg_batch(s, img=64) for s in range(STEPS)])


def _trans_seg(remat_on):
    model, spec = tpresets.build_trans_segmentor(
        TransSegmentorConfig.tiny(decoder_dropout=0.1), device="cpu", seed=1)
    return (SegmentationTask(model, spec, learning_rate=1e-3, remat=remat_on),
            [_seg_batch(s) for s in range(STEPS)])


def _denseclip(remat_on):
    cfg = DenseCLIPConfig.tiny(decoder_dropout=0.1)
    ids = np.random.default_rng(0).integers(1, cfg.vocab_size - 1, (
        cfg.num_classes, cfg.text_context_length)).astype(np.int32)
    ids[:, -1] = cfg.vocab_size - 1
    model = tpresets.build_denseclip(cfg, ids, bn_train=True, device="cpu", seed=1)
    task = DenseCLIPTask(model, learning_rate=1e-3, total_iters=10, warmup_iters=2,
                         image_stats=((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
                         remat=remat_on)
    return task, [_dc_batch(cfg, s) for s in range(STEPS)]


FAMILIES = {"clipseg_coop": _clipseg, "cris_coop_dropout": _cris,
            "cris_e2e_flat": _cris_flat_e2e, "trans_seg_dropout": _trans_seg,
            "denseclip_bn_train": _denseclip}


def _run(family, remat_on, monkeypatch):
    """Three train steps; returns (losses, state_dict, model_state, the
    checkpoints taken: one flag per call, whether it carried a generator)."""
    calls = []

    def counting(fn, *args, **kwargs):
        calls.append(getattr(fn, "__name__", "") == "run")
        return TORCH_CHECKPOINT(fn, *args, **kwargs)

    monkeypatch.setattr(remat, "_torch_checkpoint", counting)
    task, batches = FAMILIES[family](remat_on)
    state = task.init()
    losses = []
    for batch in batches:
        state, metrics = task.train_step(state, batch)
        losses.append(metrics["loss"])
    return (losses, {k: v.clone() for k, v in task.model.state_dict().items()},
            state.model_state, calls)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_matches_plain_bit_for_bit(family, monkeypatch):
    plain = _run(family, False, monkeypatch)
    rematted = _run(family, True, monkeypatch)
    assert plain[3] == []
    calls = rematted[3]
    # the remat path ran: per layer (a step's layer calls, three steps), or
    # DenseCLIP's one checkpoint a step; with dropout the masks were drawn
    # inside a checkpoint from a generator it restores for the recompute
    assert len(calls) == STEPS if family == "denseclip_bn_train" else len(calls) > STEPS
    assert any(calls) == (family != "clipseg_coop")
    for a, b in zip(plain[0], rematted[0]):
        assert torch.equal(a, b)
    assert list(plain[1]) == list(rematted[1])        # the same state_dict keys
    for name, value in plain[1].items():
        assert torch.equal(value, rematted[1][name]), name
    assert list(plain[2]) == list(rematted[2])
    for name, value in plain[2].items():
        assert torch.equal(value, rematted[2][name]), name
    if family == "denseclip_bn_train":
        # the statistics did move, once a step (the recompute wrote nowhere)
        assert len(plain[2]) > 30
        assert any(not torch.equal(v, plain[1][k]) for k, v in plain[2].items())


def test_forward_under_forced_remat_equals_plain():
    model, spec = tpresets.build_clipseg(
        "coop", prompt_depth=2, num_context=4,
        config=tconfig.CLIPSegConfig.tiny(), device="cpu", seed=1)
    task = SegmentationTask(model, spec)
    task.init()
    batch = _seg_batch(5)
    keys = list(model.state_dict())
    with torch.no_grad():
        plain = task._forward(batch)
        with remat.forced(True):
            assert remat.enabled()
            rematted = task._forward(batch)
    assert not remat.enabled()
    assert torch.equal(plain, rematted)
    # with a gradient: the same logits and the same context gradient
    grads = []
    for on in (False, True):
        model.zero_grad(set_to_none=True)
        with remat.forced(on):
            out = task._forward(batch)
        out.float().square().mean().backward()
        grads.append((out.detach(), model.learner.context_vectors.grad.clone()))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    assert list(model.state_dict()) == keys


def test_remat_generator_state_is_restored_for_the_recompute():
    """A layer that draws from the generator gets the forward's draws again
    in the recompute, and leaves the generator where the recompute found it."""
    gen = torch.Generator().manual_seed(3)
    draws = []

    def layer(x, generator):
        noise = torch.rand(x.shape, generator=generator)
        draws.append(noise)
        return (x * noise).sin()

    x = torch.randn(5, requires_grad=True)
    with remat.forced(True):
        y = remat.layer_call(layer, x, generator=gen)
    after_forward = gen.get_state()
    y.sum().backward()
    assert len(draws) == 2 and torch.equal(draws[0], draws[1])
    assert torch.equal(gen.get_state(), after_forward)
    want = torch.cos(x.detach() * draws[0]) * draws[0]
    assert torch.equal(x.grad, want)


def test_remat_step_matches_jax_remat_step():
    batch = synthetic_batch(0)
    jtask, jstate, frozen, ttask = jax_clipseg_pair(
        dict(learning_rate=1e-2, remat=True), batch)
    tstate = ttask.init()
    start = {k: v.clone() for k, v in ttask.model.state_dict().items()}
    jstep = jax.jit(jtask.train_step)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(STEPS):
        jstate, jmetrics = jstep(jstate, frozen, batch)
        tstate, tmetrics = ttask.train_step(tstate, tbatch)
        for key in ("loss", "dice", "iou"):
            np.testing.assert_allclose(tmetrics[key].item(), float(jmetrics[key]),
                                       atol=SCALAR_TOL, rtol=SCALAR_TOL, err_msg=key)
    want = trainable_from_jax(jstate.trainable, ttask.model)
    got = dict(ttask.model.named_parameters())
    travel = STEPS * 1e-2 * 1.05
    moved = 0
    for name, w in want.items():
        diff = (got[name].detach() - w).abs().max().item()
        # Adam moves an entry by about lr a step whatever its gradient's
        # size: every entry within the strategy tests' share of that travel
        assert diff <= WEIGHT_TRAVEL_SHARE * travel, name
        moved += int(not torch.equal(got[name].detach(), start[name]))
    assert moved >= 3      # the context vectors, the additive head's layers

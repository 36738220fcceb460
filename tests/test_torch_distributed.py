"""Data parallel in the port (`tunevlseg_torch/parallel/`) on two gloo ranks
on the CPU, against the JAX package's data parallel on two devices of the
8-device CPU mesh (`make_mesh(2)`), at dropout 0 (under dropout each rank
draws its own masks, which no mesh matches).

The ranks run in spawned processes that import no JAX
(`tests/torch_distributed_ranks.py`); the parent writes their inputs,
computes the JAX side while they run, and compares. One spawn runs every
check of the module:

  * (i) two DDP steps of tiny CLIPSeg CoOp (the "residual" additive head)
    against the JAX `compile_steps(mesh)`: loss, dice and IoU over the
    global batch, the gradient each update applies, the weights;
  * (ii) DDP with `accumulate_grad_batches=2` against JAX's MultiSteps on
    the mesh (`tests/test_training.py::
    test_accumulate_grad_batches_matches_full_batch`'s setup), both ranks
    bit-identical; a checkpoint cut mid-window resumes bit for bit;
  * (iii) FSDP against DDP (`test_fsdp_matches_data_parallel`): the same
    weights, each trainable leaf and its AdamW moments half a leaf per rank;
    a checkpoint written by FSDP restores bit for bit into DDP and into one
    device (`test_checkpoint_roundtrip_fsdp_to_dp`); remat on against off
    under both, bit for bit;
  * (iv) CRIS e2e and DenseCLIP `bn_train` against the JAX mesh, DenseCLIP's
    ranks holding different numbers of ignored pixels; one BatchNorm's
    statistics over the global batch, which is what the JAX BatchNorm
    computes on a batch sharded over the mesh (checked here first);
  * (v) a SIGTERM on one rank stops both at the same step, and rank 0
    alone writes the logs;
  * the dice over the whole batch (`loss_kwargs={"batch": True}`) under DDP
    and FSDP, and in the eval step on a batch with padded rows, against the
    JAX task on the mesh.
Beside it: the train CLI with `trainer.n_devices=2` on the CPU (rank 0
alone writes checkpoints and logs, both prediction shards land), its
export under FSDP against the one-process export, zero-shot
RIS with the proposals over two devices against the JAX mesh
(`tests/test_zero_shot_ris.py::test_zero_shot_ris_fused_mesh_parity`), and
the process-group entry points' errors.

Tolerances: f32 on the CPU in both packages, the same formulas, sums in
another order and over other splits: losses and metrics of order 1 to
1e-5; a gradient leaf to 1e-4 of its largest entry; weights by the
strategy-parity rule of `tests/test_torch_accumulate.py` (an entry whose
gradient is well above the rounding noise within 2% of the most Adam can
move it, any entry within twice that); BatchNorm outputs and statistics of
order 1 to 1e-5; port against port (DDP / FSDP / one device) to 1e-6 of
a weight's scale where the sums differ, bit for bit where they do not."""
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tests import torch_distributed_ranks as ranks_mod  # noqa: E402
from tests.test_torch_accumulate import (GRAD_REL_TOL, IMAGENET,  # noqa: E402
                                         SCALAR_TOL, _hold_weights,
                                         _synthetic_batch, jax_clipseg_pair)
from tests.test_torch_cli import _common, synth  # noqa: E402,F401
from tests.test_torch_denseclip import _built as _dc_built  # noqa: E402
from tests.test_torch_zero_shot_ris import clip, solo  # noqa: E402,F401
from tests.test_torch_denseclip import _jcfg as _dc_jcfg  # noqa: E402
from tests.test_torch_denseclip import _train_batch as _dc_train_batch  # noqa: E402
from tunevlseg_tpu.models.cris import model as jcris  # noqa: E402
from tunevlseg_tpu.models.cris.resnet import BatchNorm2d as JBatchNorm  # noqa: E402
from tunevlseg_tpu.models.denseclip import model as jdc_model  # noqa: E402
from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.parallel import mesh as mesh_lib  # noqa: E402
from tunevlseg_tpu.training import denseclip_task as jdc_task  # noqa: E402
from tunevlseg_tpu.training.optim import partition_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_tpu.training.task import TrainState as JTrainState  # noqa: E402
from tunevlseg_torch.convert.from_jax import (state_dict_from_jax,  # noqa: E402
                                              trainable_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.cris import model as tcris  # noqa: E402
from tunevlseg_torch.parallel import distributed  # noqa: E402
from tunevlseg_torch.training.checkpoint import CheckpointManager  # noqa: E402
from tunevlseg_torch.training.task import step_generator  # noqa: E402

LR = ranks_mod.LR
KEY = jax.random.PRNGKey(0)
BN_TOL = 1e-5
EPS32 = torch.finfo(torch.float32).eps
# port against port where the sums run over other splits of the batch
PORT_TOL = 1e-6
CRIS_HP = dict(learning_rate=1e-3, weight_decay=0.01, grad_clip_norm=0.5)
DC_HP = dict(learning_rate=3e-3, weight_decay=1e-2, total_iters=4,
             warmup_iters=2, image_stats=IMAGENET)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return mesh_lib.make_mesh(2)


def _cris_batch(seed, b=4, img=64, unique=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, (unique, 12)).astype(np.int32)
    ids[:, 0], ids[:, 8], ids[:, 9:] = 49406, 49407, 0
    return {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
            "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "valid": np.ones((b,), np.float32),
            "text_index": (np.arange(b) % unique).astype(np.int32)}


def _dc_batches(cfg):
    """Two global batches of 4 whose halves (the two ranks' rows) hold
    different numbers of ignored pixels."""
    out = []
    for seed in (8, 9):
        b = _dc_train_batch(cfg, b=4, seed=seed)
        b["label"][2:, :20] = 255          # rank 1: far more ignored rows
        b["label"][0, 30:34, :10] = 255
        out.append(b)
    return out


def _jax_stepper(jtask, frozen, mesh, batches, state):
    """The JAX task's data-parallel train step on `mesh`, over `batches`:
    [(metrics, trainable, model_state)] after each step."""
    train = jtask.compile_steps(mesh)[0]
    state = mesh_lib.replicate(mesh, state)
    frozen = mesh_lib.replicate(mesh, frozen)
    out = []
    for b in batches:
        state, m = train(state, frozen, mesh_lib.shard_batch(mesh, b))
        # copies: the next step donates the state's buffers
        out.append(({k: float(v) for k, v in m.items()},
                    jax.tree_util.tree_map(np.asarray, state.trainable),
                    jax.tree_util.tree_map(np.asarray, state.model_state)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank check in one spawn of two ranks, and the JAX side computed
    while they run."""
    work = tmp_path_factory.mktemp("ranks")
    batches = [_synthetic_batch(s) for s in (0, 1)]
    full = _synthetic_batch(2, batch=16)
    micro = [{k: v[:8] for k, v in full.items()}, {k: v[8:] for k, v in full.items()}]
    jtask, jstate, frozen, ttask = jax_clipseg_pair(dict(learning_rate=LR),
                                                    batches[0])
    jacc, jacc_state, _, _ = jax_clipseg_pair(
        dict(learning_rate=LR, accumulate_grad_batches=2), micro[0])
    dice_batches = [_dice_batch(s) for s in (12, 13)]
    padded = _dice_batch(14)
    padded["valid"][[3, 7]] = 0.0      # one padded row in each rank's half
    jdice, jdice_state, _, _ = jax_clipseg_pair(
        dict(learning_rate=LR, loss_kwargs={"batch": True}), dice_batches[0])
    clipseg_sd = ttask.model.state_dict()

    # CRIS e2e: a JAX tree of the model's shapes drawn from a seeded numpy
    # generator (Flax's `init` runs op by op for tens of seconds), in the
    # port through `state_dict_from_jax`
    cris_batches = [_cris_batch(s) for s in (3, 4)]
    jm, jspec = jpresets.build_cris("e2e", config=jcris.CRISConfig.tiny())
    b0 = cris_batches[0]
    shapes = jax.eval_shape(
        lambda *a: jm.init(KEY, *a, text_index=b0["text_index"]),
        b0["input_ids"], b0["image"].astype(np.float32), b0["attention_mask"])
    cris_params, cris_stats = _drawn(shapes["params"], 3), _stats(shapes["batch_stats"], 4)
    cris_model, _ = tpresets.build_cris("e2e", config=tcris.CRISConfig.tiny(),
                                        seed=1, device="cpu")
    cris_model.load_state_dict(state_dict_from_jax(cris_params, cris_model,
                                                   cris_stats))

    dc_cfg, dc_ids, dc_model, dc_vars = _dc_built(
        "rn", cfg_kw=dict(head_dropout=0.0), bn_train=True)
    dc_batches = _dc_batches(dc_cfg)

    rng = np.random.default_rng(5)
    inputs = {
        "clipseg": clipseg_sd, "batches": batches, "micro": micro,
        "dice_batches": dice_batches, "padded": padded,
        "cris": cris_model.state_dict(), "cris_hp": CRIS_HP,
        "cris_batches": cris_batches,
        "denseclip": {"config": dc_cfg, "class_ids": dc_ids,
                      "sd": dc_model.state_dict(), "hp": DC_HP,
                      "batches": dc_batches},
        "bn_x": (rng.normal(size=(4, 3, 5, 5)) * 2 + 1).astype(np.float32),
        "bn_cot": rng.normal(size=(4, 3, 5, 5)).astype(np.float32),
        "samples": _samples(16)}
    torch.save(inputs, work / "inputs.pt")
    started = ranks_mod.spawn(work, tuple(ranks_mod.CHECKS))

    mesh = _mesh()
    want = {"ddp": _jax_stepper(jtask, frozen, mesh, batches, jstate),
            "accumulate": _jax_stepper(jacc, frozen, mesh, micro, jacc_state),
            **_jax_batch_dice(jdice, jdice_state, frozen, mesh, dice_batches,
                              padded, ttask.model)}
    jcris_task = JTask(jm, jspec, mutable_collections=("batch_stats",), **CRIS_HP)
    trainable, frozen_params = partition_params(cris_params, jspec)
    cris_state = JTrainState(jnp.zeros((), jnp.int32), trainable,
                             jcris_task.tx.init(trainable),
                             jax.random.fold_in(KEY, 1),
                             {"batch_stats": cris_stats})
    want["cris_e2e"] = _jax_stepper(jcris_task, {"params": frozen_params}, mesh,
                                    cris_batches, cris_state)
    jdc = jdc_task.DenseCLIPTask(
        jdc_model.DenseCLIP(_dc_jcfg(dc_cfg), class_token_ids=dc_ids,
                            bn_train=True), **DC_HP)
    params = dc_vars["params"]
    dc_trainable = {k: v for k, v in params.items() if k != "text_encoder"}
    dc_state = JTrainState(jnp.zeros((), jnp.int32), dc_trainable,
                           jdc.tx.init(dc_trainable), jax.random.fold_in(KEY, 1),
                           {"batch_stats": dc_vars["batch_stats"]})
    want["denseclip"] = _jax_stepper(
        jdc, {"params": {"text_encoder": params["text_encoder"]}}, mesh,
        dc_batches, dc_state)
    got = ranks_mod.collect(started, work)
    return dict(got=got, want=want, inputs=inputs, work=work,
                models={"clipseg": ttask.model, "cris_e2e": cris_model,
                        "denseclip": dc_model})


def _dice_batch(seed):
    """A global batch of 8 whose two halves (the two ranks' rows) hold
    targets of different sizes: the whole blob, and its left half. A rank's
    dice over its own rows is then far from the global batch's."""
    batch = _synthetic_batch(seed)
    img = batch["mask"].shape[-1]
    batch["mask"][4:, ..., img // 2:] = 0.0
    return batch


def _jax_batch_dice(jtask, jstate, frozen, mesh, batches, padded, model):
    """The JAX task's side of the batch dice on `mesh`: the eval step's
    (loss_sum, n) on `padded` and the gradient of the first step's loss
    (port names), both at the initial state, then the train steps over
    `batches`."""
    from tunevlseg_tpu.ops import metrics as jmetrics
    state = mesh_lib.replicate(mesh, jstate)
    fro = mesh_lib.replicate(mesh, frozen)
    evals = jtask.compile_steps(mesh)[1]
    _, extra = evals(state, fro, jmetrics.SegMetricState.zeros(),
                     mesh_lib.shard_batch(mesh, padded))
    rng = jax.random.fold_in(jstate.rng, 0)     # the first step's key

    def loss(trainable, batch):
        return jtask._loss(trainable, {}, fro, batch, rng)[0]

    grads = jax.jit(jax.grad(loss))(state.trainable,
                                    mesh_lib.shard_batch(mesh, batches[0]))
    return {"batch_dice_eval": (float(extra["loss_sum"]), float(extra["n"])),
            "batch_dice_grad": trainable_from_jax(
                jax.tree_util.tree_map(np.asarray, grads), model),
            "batch_dice": _jax_stepper(jtask, frozen, mesh, batches, jstate)}


def _drawn(shapes, seed):
    """A JAX parameter tree of `shapes` at an initialisation's scale from a
    seeded numpy generator: kernels and convolution weights over the square
    root of their fan-in, norm scales near 1, the rest small."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name in ("kernel", "weight") and len(shape) >= 2:
            fan_in = np.prod(shape[:-1]) if name == "kernel" else np.prod(shape[1:])
            v = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name in ("scale", "weight"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            v = rng.normal(0.0, 0.02, shape)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _stats(shapes, seed):
    """Running statistics near what `_drawn`'s unit-gain convolutions put
    out (variances about 1), so that the frozen backbone's BatchNorms
    neither grow nor shrink the signal layer after layer."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        lo, hi = (0.8, 1.2) if path[-1].key == "running_var" else (-0.2, 0.2)
        return jnp.asarray(rng.uniform(lo, hi, size=x.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _samples(n, img=32, seq=12, pad=49407):
    rng = np.random.default_rng(11)
    ids = rng.integers(3, 1000, size=(seq,)).astype(np.int32)
    ids[0], ids[8], ids[9:] = 49406, 49407, pad
    return [{"image": rng.normal(size=(3, img, img)).astype(np.float32),
             "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != pad).astype(np.int32),
             "mask_name": f"{i}.png", "mask_shape": np.asarray([img, img]),
             "prompt": "p"} for i in range(n)]


def _both_ranks_equal(a, b, key="trainable"):
    """Two ranks' records of the same steps agree bit for bit (DDP keeps the
    replicas in step)."""
    for x, y in zip(a, b):
        assert all(torch.equal(x[key][n], y[key][n]) for n in x[key])


def _hold_steps(seen, want, model, start, travel, tols=None):
    """Each step's scalars at SCALAR_TOL (or `tols[key]`), the weights by
    the parity rule over the gradients each update applied."""
    grads = []
    for rec, (jm, jtrain, _) in zip(seen, want):
        for key, value in rec["metrics"].items():
            if key in jm:
                tol = (tols or {}).get(key, SCALAR_TOL)
                np.testing.assert_allclose(value, jm[key], atol=tol,
                                           rtol=SCALAR_TOL, err_msg=key)
        grads.append(rec["grads"])
    final_want = trainable_from_jax(want[-1][1], model)
    n_robust = _hold_weights(seen[-1]["trainable"], final_want, start, grads,
                             travel)
    assert n_robust > 0


def _start(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


# --- (d) the BatchNorm statistics ---------------------------------------------------

def test_jax_batch_norm_on_the_mesh_uses_global_statistics_and_so_does_the_port(runs):
    """The JAX BatchNorm in train mode under jit, its batch sharded over
    two devices, normalises with the mean and variance of the whole batch
    (not each shard's, which differ here by far more than the tolerance);
    the port's two ranks, each holding half the rows, give the same output,
    statistics and gradients as one device on the whole batch."""
    x, cot = runs["inputs"]["bn_x"], runs["inputs"]["bn_cot"]
    bn = JBatchNorm(3, use_running_average=False)
    variables = bn.init(KEY, jnp.asarray(x))
    variables = {"params": {"weight": jnp.asarray([1.5, 0.5, -1.0]),
                            "bias": variables["params"]["bias"]},
                 "batch_stats": variables["batch_stats"]}
    mesh = _mesh()
    sharded = mesh_lib.shard_batch(mesh, {"x": x})["x"]

    def run(v, xs):
        y, upd = bn.apply(v, xs, mutable=["batch_stats"])
        return (y * cot).sum(), (y, upd)

    (_, (y, upd)), (gv, gx) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(variables, sharded)
    mean = x.mean(axis=(0, 2, 3))
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["running_mean"]),
                               0.1 * mean, atol=BN_TOL)
    for half in (x[:2], x[2:]):
        assert np.abs(0.1 * half.mean(axis=(0, 2, 3)) - 0.1 * mean).max() > 100 * BN_TOL
    r0, r1 = (g["batch_norm"] for g in runs["got"])
    np.testing.assert_allclose(torch.cat([r0["y"], r1["y"]]).numpy(), np.asarray(y),
                               atol=BN_TOL)
    for got in (r0["stats"], r1["stats"]):
        np.testing.assert_allclose(got[0].numpy(), upd["batch_stats"]["running_mean"],
                                   atol=BN_TOL)
        np.testing.assert_allclose(got[1].numpy(), upd["batch_stats"]["running_var"],
                                   atol=BN_TOL)
    np.testing.assert_allclose(torch.cat([r0["dx"], r1["dx"]]).numpy(), np.asarray(gx),
                               atol=BN_TOL)
    # each rank's affine gradient is its rows' share; DDP would average them
    np.testing.assert_allclose((r0["dw"] + r1["dw"]).numpy(),
                               np.asarray(gv["params"]["weight"]), atol=10 * BN_TOL)


# --- (i) DDP ---------------------------------------------------------------------

def test_ddp_coop_steps_match_jax_data_parallel(runs):
    got, want = runs["got"], runs["want"]["ddp"]
    _both_ranks_equal(got[0]["ddp"]["plain"], got[1]["ddp"]["plain"])
    seen = got[0]["ddp"]["plain"]
    start = {n: v for n, v in runs["inputs"]["clipseg"].items()
             if n in seen[0]["trainable"]}
    _hold_steps(seen, want, runs["models"]["clipseg"], start,
                lambda name: 2 * LR * 1.05)


def test_remat_is_bit_identical_under_ddp_and_fsdp(runs):
    """(f) per-layer remat recomputes inside each rank: no second
    reduction under DDP, the parameters gathered again under FSDP, and the
    steps land on the same weights bit for bit."""
    for check in ("ddp", "fsdp"):
        for rank in runs["got"]:
            for plain, remat in zip(rank[check]["plain"], rank[check]["remat"]):
                assert plain["metrics"] == remat["metrics"]
                for n, w in plain["trainable"].items():
                    assert torch.equal(w, remat["trainable"][n]), (check, n)


def test_find_unused_parameters_only_where_the_model_names_some(runs):
    """CoOp's stock CLIPSeg never reads `residual_ratio`: DDP finds it
    unused on both ranks, which stay in step, and it keeps its value; the
    "residual" model reads every trainable leaf and runs without the
    search."""
    from tunevlseg_torch.models.clip.config import CLIPSegConfig
    from tunevlseg_torch.parallel import data_parallel
    r0, r1 = (g["ddp_unused"] for g in runs["got"])
    assert r0["find_unused"] and r1["find_unused"]
    assert r0["losses"] == r1["losses"]
    assert all(torch.equal(r0["trainable"][n], r1["trainable"][n])
               for n in r0["trainable"])
    model, _ = tpresets.build_clipseg("coop", config=CLIPSegConfig.tiny(),
                                      device="cpu", seed=2)
    assert torch.equal(r0["trainable"]["residual_ratio"], model.residual_ratio)
    assert data_parallel.unused_parameters(model) == ["residual_ratio"]
    assert data_parallel.unused_parameters(runs["models"]["clipseg"]) == []


# --- the dice over the whole batch ---------------------------------------------------

@pytest.mark.parametrize("wrap", ["ddp", "fsdp"])
def test_batch_dice_over_two_ranks_matches_the_jax_mesh(runs, wrap):
    """`loss_kwargs={"batch": True}` under DDP and under FSDP: each rank's
    dice adds the three sums over the data group before the ratio, and the
    sums' backward adds the gradients over it, so each rank's loss is the
    global dice and DDP's (FSDP's) mean of the ranks' gradients that of the
    global loss, as the JAX `dice_ce_loss(batch=True)` under jit on
    `make_mesh(2)` computes them. Each step's loss, dice and IoU at
    SCALAR_TOL; the gradient the first update applied within GRAD_REL_TOL
    of each leaf's largest entry of the JAX gradient (a rank's dice over
    its own rows, or the sums' gradient left unsummed, is off by far more);
    the weights after the two steps by the parity rule (the neighbouring
    DDP check's); the ranks bit for bit in step."""
    got = [g["batch_dice"][wrap] for g in runs["got"]]
    _both_ranks_equal(got[0], got[1])
    seen = got[0]
    start = {n: v for n, v in runs["inputs"]["clipseg"].items()
             if n in seen[0]["trainable"]}
    _hold_steps(seen, runs["want"]["batch_dice"], runs["models"]["clipseg"],
                start, lambda name: 2 * LR * 1.05)
    jgrad = runs["want"]["batch_dice_grad"]
    assert jgrad.keys() == seen[0]["grads"].keys()
    for name, w in jgrad.items():
        torch.testing.assert_close(seen[0]["grads"][name], w, rtol=0,
                                   atol=GRAD_REL_TOL * w.abs().max().item(),
                                   msg=name)


def test_batch_dice_eval_loss_sum_over_two_ranks_matches_the_jax_mesh(runs):
    """The eval step under the batch dice on a batch whose two halves each
    hold one padded row (the port's loader pads every rank's shard to one
    length, so the ranks' last batches hold as many valid rows): each
    rank's loss is the global dice (the padded rows zeroed on both sides,
    their sigmoid 0.5 in the prediction sum, as in JAX) plus its own rows'
    cross-entropy, so the ranks' loss_sum added up is the JAX eval's on the
    global batch, to SCALAR_TOL."""
    r0, r1 = (g["batch_dice"]["eval"] for g in runs["got"])
    want_sum, want_n = runs["want"]["batch_dice_eval"]
    assert float(r0["n"]) == float(r1["n"]) == want_n / 2 == 3
    np.testing.assert_allclose(float(r0["loss_sum"] + r1["loss_sum"]), want_sum,
                               rtol=SCALAR_TOL, atol=SCALAR_TOL)


def test_batch_dice_with_one_data_rank_runs_no_collective(monkeypatch):
    """Without a process group (one data rank) the dice over the batch runs
    no collective and is, bit for bit, the dice of the one device's sums:
    1 - (2 I + smooth) / (G + P + smooth), with every option's sums."""
    import torch.distributed as dist

    from tunevlseg_torch.ops.losses import dice_loss

    def refuse(*a, **k):
        raise AssertionError("a collective ran with one data rank")
    monkeypatch.setattr(dist, "all_reduce", refuse)
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(4, 2, 9, 9, generator=g)
    targets = (torch.rand(4, 2, 9, 9, generator=g) > 0.5).float()
    p = torch.sigmoid(logits)
    dims = (0, 2, 3)
    for squared, jaccard in ((False, False), (True, False), (False, True)):
        inter = (targets * p).sum(dim=dims)
        if squared:
            den = (targets * targets).sum(dim=dims) + (p * p).sum(dim=dims)
        else:
            den = targets.sum(dim=dims) + p.sum(dim=dims)
        if jaccard:
            den = 2.0 * (den - inter)
        want = (1.0 - (2.0 * inter + 1e-5) / (den + 1e-5)).mean()
        got = dice_loss(logits, targets, squared_pred=squared, jaccard=jaccard,
                        batch=True)
        assert torch.equal(got, want), (squared, jaccard)


# --- (ii) accumulation -------------------------------------------------------------

def test_ddp_accumulation_matches_jax_multisteps_on_the_mesh(runs):
    """Two micro-steps under `no_sync`, the window's mean all-reduced at the
    update: the gradient applied is the JAX mesh's mean over the global
    micro-batches, and both ranks land on the same weights (without the
    all-reduce each rank would apply its own rows' gradient)."""
    got, (jfirst, jlast) = runs["got"], runs["want"]["accumulate"]
    r0, r1 = (g["accumulate"] for g in got)
    model = runs["models"]["clipseg"]
    start = {n: v for n, v in runs["inputs"]["clipseg"].items() if n in r0["after"]}
    assert len(r0["applied"]) == len(r1["applied"]) == 1
    for n in r0["after"]:
        assert torch.equal(r0["after"][n], r1["after"][n]), n
        assert torch.equal(r0["after_first"][n], start[n]), n
        assert torch.equal(r0["applied"][0][n], r1["applied"][0][n]), n
    want_mid = trainable_from_jax(jfirst[1], model)
    assert all(torch.equal(want_mid[n], start[n]) for n in want_mid)
    n_robust = _hold_weights(r0["after"], trainable_from_jax(jlast[1], model),
                             start, r0["applied"], lambda name: LR * 1.05)
    assert n_robust > 0


def test_mid_window_checkpoint_resumes_bit_for_bit_under_ddp(runs):
    """A checkpoint written after the window's first micro-step holds each
    rank's running mean; restored into new models on the same ranks, the
    second micro-step and the update land on the uninterrupted weights bit
    for bit."""
    for g in runs["got"]:
        acc = g["accumulate"]
        assert acc["resumed_mini_step"] == 1
        assert all(torch.equal(acc["resumed"][n], acc["after"][n])
                   for n in acc["after"])
    saved = torch.load(runs["work"] / "accum_ckpt" / "last" / "state.pt",
                       weights_only=True)
    window = saved["accumulation"]
    assert window["mini_step"] == 1 and len(window["per_rank"]) == 2
    # the ranks' rows differ, and so do their windows
    name = next(iter(window["per_rank"][0]))
    assert not torch.equal(window["per_rank"][0][name], window["per_rank"][1][name])
    # one device cannot take two ranks' windows
    task = ranks_mod.clipseg_task(runs["inputs"]["clipseg"], learning_rate=LR,
                                  accumulate_grad_batches=2)
    with pytest.raises(ValueError, match="resumes only into 2 ranks"):
        CheckpointManager(runs["work"] / "accum_ckpt", task.model).restore(
            "last", task.init())


# --- (iii) FSDP ------------------------------------------------------------------

def test_fsdp_matches_ddp_and_holds_half_of_each_leaf_per_rank(runs):
    got = runs["got"]
    for rank in got:
        for fs, dd in zip(rank["fsdp"]["plain"], rank["ddp"]["plain"]):
            for key, value in dd["metrics"].items():
                assert fs["metrics"][key] == pytest.approx(value, abs=SCALAR_TOL)
            for n, w in dd["trainable"].items():
                torch.testing.assert_close(fs["trainable"][n], w, rtol=0,
                                           atol=PORT_TOL * max(1.0, w.abs().max().item()))
        assert rank["fsdp"]["sharded_is_dtensor"] is False   # the scalar stays whole
    shards = got[0]["fsdp"]["shards"]
    halved = 0
    for name, s in shards.items():
        rows = s["global"][0]
        assert s["local"][0] == -(-rows // 2), name         # rank 0's chunk
        if s["trainable"]:
            assert s["moments"] == [s["local"], s["local"]], name
        if rows % 2 == 0:
            assert s["local"][0] * 2 == rows
            halved += int(s["trainable"])
    assert halved >= 1
    # frozen towers are sharded too
    assert shards["text_model.token_embedding.weight"]["local"][0] * 2 == \
        shards["text_model.token_embedding.weight"]["global"][0]
    assert "residual_ratio" not in shards


def test_checkpoint_from_fsdp_restores_bit_for_bit_into_ddp_and_one_device(runs):
    fsdp = runs["got"][0]["fsdp"]
    final = fsdp["plain"][-1]["trainable"]
    for rank in runs["got"]:
        assert all(torch.equal(rank["fsdp"]["into_ddp"][n], final[n]) for n in final)
    saved = torch.load(runs["work"] / "fsdp_ckpt" / "last" / "state.pt",
                       weights_only=True)
    assert all(torch.equal(saved["trainable"][n], final[n]) for n in final)
    task = ranks_mod.clipseg_task(runs["inputs"]["clipseg"], learning_rate=LR)
    state = CheckpointManager(runs["work"] / "fsdp_ckpt", task.model).restore(
        "last", task.init())
    assert state.step == 2
    mine = dict(task.model.named_parameters())
    assert all(torch.equal(mine[n], final[n]) for n in final)
    moments = list(state.optimizer.optimizer.state.values())
    assert len(moments) == len(fsdp["into_ddp_moments"]) == len(final)
    for one, ddp in zip(moments, fsdp["into_ddp_moments"]):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(one[key], ddp[key]), key
    # the frozen file holds whole tensors of the sharded towers
    frozen = torch.load(runs["work"] / "fsdp_ckpt" / "frozen" / "frozen.pt",
                        weights_only=True)
    assert torch.equal(frozen["text_model.token_embedding.weight"],
                       runs["inputs"]["clipseg"]["text_model.token_embedding.weight"])


# --- (iv) the BatchNorm models -------------------------------------------------------

def _hold_bn_model(runs, check, first_bound, travel, tols=None):
    """A train-mode BatchNorm model's DDP steps against the JAX mesh's, at
    `tests/test_torch_cris.py`'s e2e rules: the scalars at `tols` (else
    SCALAR_TOL); after the first step an entry whose gradient is well above
    the rounding noise (>= 1e-2 of its leaf's largest and >= 1e-3 of any
    leaf's) within `first_bound(name)` (2% of that step's learning rate)
    and an ulp of the entry; after the
    last, every entry within twice the most Adam can move it
    (`travel(name)`) and at least 99% of the robust entries within a tenth
    of it; the statistics in the state within 1e-5 after the first step and
    2e-3 after a later one (statistics of activations of weights that Adam
    has moved apart by up to a few learning rates)."""
    from tunevlseg_torch.convert.from_jax import model_state_from_jax
    got, want = runs["got"], runs["want"][check]
    _both_ranks_equal(got[0][check], got[1][check])
    _both_ranks_equal(got[0][check], got[1][check], key="stats")
    model = runs["models"][check]
    start = _start(model)
    seen = got[0][check]
    for rec, (jm, _, _) in zip(seen, want):
        for key, value in rec["metrics"].items():
            tol = (tols or {}).get(key, SCALAR_TOL)
            np.testing.assert_allclose(value, jm[key], atol=tol, rtol=SCALAR_TOL,
                                       err_msg=key)
    grads = [rec["grads"] for rec in seen]
    overall = max(g.abs().max().item() for g in grads[0].values())
    first_want = trainable_from_jax(want[0][1], model)
    n_first = 0
    for name, w in first_want.items():
        g = grads[0][name].abs()
        robust = (g >= 1e-2 * g.max()) & (g >= 1e-3 * overall)
        if robust.any():
            diff = (seen[0]["trainable"][name] - w).abs()
            # and the weight's own rounding: a warm-up step can be smaller
            # than an ulp of the entry it moves
            bound = first_bound(name) + EPS32 * w.abs()
            assert (diff <= bound)[robust].all(), name
        n_first += int(robust.sum())
    assert n_first > 100
    final_want = trainable_from_jax(want[-1][1], model)
    robust_diffs = []
    for name, w in final_want.items():
        diff = (seen[-1]["trainable"][name] - w).abs()
        assert diff.max().item() <= 2 * travel(name), name
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust_diffs.append((diff / travel(name))[gmin >= 1e-2 * gtop].flatten())
        assert not torch.equal(seen[-1]["trainable"][name], start[name]) or gtop == 0
    robust_diffs = torch.cat(robust_diffs)
    assert (robust_diffs <= 0.1).float().mean().item() >= 0.99
    for i, (rec, (_, _, jstats)) in enumerate(zip(seen, want)):
        wanted = model_state_from_jax(jstats, model)
        assert set(wanted) == set(rec["stats"])
        tol = BN_TOL if i == 0 else 2e-3
        for n, v in wanted.items():
            torch.testing.assert_close(rec["stats"][n], v, rtol=tol, atol=tol,
                                       msg=lambda m, n=n: f"{n}: {m}")


def test_cris_e2e_ddp_matches_jax_mesh(runs):
    """CRIS e2e (the FPN's and the projector's BatchNorms on batch
    statistics): the loss of a live train-mode network to 5e-5, dice and IoU
    to 2e-3 (a pixel crossing the threshold moves them by 1e-4)."""
    lr = CRIS_HP["learning_rate"]
    _hold_bn_model(runs, "cris_e2e", lambda name: 0.02 * lr, lambda name: 2 * lr,
                   tols={"loss": 5e-5, "dice": 2e-3, "iou": 2e-3})


def test_denseclip_bn_train_ddp_matches_jax_mesh_with_unequal_ignored_pixels(runs):
    """The cross-entropy divides by every pixel of the local batch (ignored
    ones included), so DDP's mean over equal local batches is the global
    loss whatever the ranks ignore; the pixel accuracy divides by the
    non-ignored pixels and comes from the ranks' summed counts."""
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask, group_labels
    batches = runs["inputs"]["denseclip"]["batches"]
    ignored = [(b["label"][:2] == 255).sum() for b in batches]
    assert all(i < (b["label"][2:] == 255).sum() for i, b in zip(ignored, batches))
    model = runs["models"]["denseclip"]
    schedule = DenseCLIPTask(model, **DC_HP).schedule
    labels = group_labels(model)

    def mult(name):
        return 0.1 if labels[name].startswith("backbone") else 1.0

    # the JAX schedule runs in f32: its warm-up factor at update 0 is 1.3%
    # off the exact one (tests/test_torch_accumulate.py), so the first step's
    # entries differ by that much of the step besides the 2%
    jax_lr0 = float(jdc_task.poly_warmup_schedule(
        DC_HP["learning_rate"], DC_HP["total_iters"],
        warmup_iters=DC_HP["warmup_iters"])(0))
    _hold_bn_model(
        runs, "denseclip",
        lambda name: (0.02 * schedule(0) + abs(schedule(0) - jax_lr0)) * mult(name),
        lambda name: (schedule(0) + schedule(1)) * mult(name))


# --- (v) preemption, the CLI ----------------------------------------------------------

def test_sigterm_on_one_rank_stops_both_at_the_same_step(runs):
    r0, r1 = (g["sigterm"] for g in runs["got"])
    assert r0["step"] == r1["step"] == 3
    assert r0["logged"] and not r1["logged"]
    import json
    meta = json.loads((runs["work"] / "sigterm" / "checkpoints" / "last.json")
                      .read_text())
    assert meta["preempted"] and meta["batch_offset"] == 3
    lines = (runs["work"] / "sigterm" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3      # rank 0's three steps, logged once each


def test_train_cli_with_two_ranks_on_the_cpu(synth, tmp_path):
    """`trainer.n_devices=2 +trainer.device=cpu`: two gloo ranks each take
    half of every batch; rank 0 alone writes the config, the logs and the
    checkpoints, both write their shards of the prediction masks, and the
    test metrics are those of every rank's samples."""
    import cv2

    from tunevlseg_torch import train as train_mod
    data = synth
    out = tmp_path / "logs"
    torch.set_num_threads(2)        # one thread for each rank
    result = train_mod.main(_common(data, out) + [
        "trainer.n_devices=2", "trainer.max_epochs=2", "predict=true",
        "exp_name=ranks"])
    assert np.isfinite(result["test_loss"]) and 0 <= result["test_dice"] <= 1
    run = out / "train" / "ranks"
    for tag in ("best", "last", "frozen"):
        assert (run / "checkpoints" / tag).is_dir(), tag
    # 8 samples, 4 a rank: one step of 2 rows per rank and epoch
    rows = (run / "metrics.csv").read_text().splitlines()
    epochs = [ln for ln in rows[1:] if ln.split(",")[0] != ""]
    assert len(rows) >= 3 and len(epochs) == len({ln for ln in epochs})
    masks = sorted(Path(result["output_masks_dir"]).glob("*.png"))
    assert len(masks) == 8
    assert cv2.imread(str(masks[0]), cv2.IMREAD_GRAYSCALE).shape == (40, 40)
    assert (run / "config.yaml").exists() and not (run / "FAILED").exists()
    assert not distributed.is_initialized()


def test_fsdp_train_cli_exports_the_one_process_program(synth, tmp_path):
    """`trainer.n_devices=2 trainer.fsdp=true +export_dir`: the model is
    sharded over the two ranks, so rank 0 builds it again whole, gathers
    the run's tensors into it and exports that. Its program, at rank 0's
    batch of 2 rows, calls the same ops as the one-process eval CLI's
    export from the run's checkpoint at that batch, and gives its output
    bit for bit on the checkpoint's weights."""
    from tests.test_torch_cli import exported_probs
    from tunevlseg_torch import eval as eval_mod
    from tunevlseg_torch import serving
    from tunevlseg_torch import train as train_mod
    out = tmp_path / "logs"
    torch.set_num_threads(2)        # one thread for each rank
    trained = train_mod.main(_common(synth, out) + [
        "trainer.n_devices=2", "trainer.fsdp=true", "trainer.max_epochs=1",
        "exp_name=fsdp_export", f"+export_dir={tmp_path / 'art_fsdp'}"])
    ckpt = out / "train" / "fsdp_export" / "checkpoints"
    one = eval_mod.main(_common(synth, out) + [
        "data.batch_size=2", f"ckpt_path={ckpt}", "predict=false",
        "exp_name=fsdp_export_eval", f"+export_dir={tmp_path / 'art_one'}"])
    metas = [serving.read_meta(r["export_dir"]) for r in (trained, one)]
    assert metas[0]["tunevlseg_ops"] == metas[1]["tunevlseg_ops"]
    assert metas[0]["in_specs"] == metas[1]["in_specs"]
    want = exported_probs(one["export_dir"], ckpt)
    assert want.shape == (2, 1, 32, 32) and bool(want.isfinite().all())
    torch.testing.assert_close(exported_probs(trained["export_dir"], ckpt), want,
                               rtol=0, atol=0)
    assert not distributed.is_initialized()


# --- the entry points ------------------------------------------------------------

def test_initialize_distributed_names_what_it_misses(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="coordinator_address.*num_processes"):
        distributed.initialize_distributed({}, "cpu")
    with pytest.raises(ValueError, match="trainer.process_id missing"):
        distributed.initialize_distributed(
            {"coordinator_address": "host:1234", "num_processes": 2}, "cpu")
    assert distributed.init_method_of(
        {"coordinator_address": "host0:8476", "num_processes": 4,
         "process_id": 3}) == ("tcp://host0:8476", 4, 3)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert distributed.init_method_of(None) == ("env://", 2, 1)
    assert not distributed.is_initialized()
    # without a group: one process, rank 0, collectives the identity
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.any_flag(True) and not distributed.any_flag(False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.rank_device("cuda")


def test_dropout_masks_fold_the_rank_in():
    """Each rank draws its own masks for its rows; rank 0 draws those of one
    device, and every draw is a function of (seed, step, rank) alone."""
    model = torch.nn.Linear(2, 2)

    def draw(step, rank):
        return torch.rand(64, generator=step_generator(model, 3, step, rank))

    assert torch.equal(draw(5, 0), draw(5, None))       # no group: rank 0
    assert torch.equal(draw(5, 1), draw(5, 1))
    assert not torch.equal(draw(5, 0), draw(5, 1))
    assert not torch.equal(draw(5, 1), draw(6, 1))
    old = torch.Generator().manual_seed((3 * 1_000_003 + 5) % 2 ** 63)
    assert torch.equal(draw(5, 0), torch.rand(64, generator=old))


# --- (vi) zero-shot RIS over two devices -------------------------------------------

def test_zero_shot_two_devices_matches_jax_mesh(solo, clip):
    """`n_devices=2` on ["cpu", "cpu"]: the proposals in two chunks through
    two replicas of the towers against the JAX fused request with its
    proposal batch sharded over a 2-device mesh (`tests/test_zero_shot_ris.
    py::test_zero_shot_ris_fused_mesh_parity`) at alpha 0.95 (both
    proposal-parallel branches): the same picked mask, the features within
    1e-4 of the largest |reference| (`tests/test_torch_zero_shot_ris.py`'s
    tolerance), and within 1e-6 of the unsplit port request's."""
    from tests.test_torch_zero_shot_ris import _close, _jcfg, _text_ids
    from tunevlseg_tpu.models.zero_shot_ris import model as jris
    from tunevlseg_torch.models.zero_shot_ris import model as tris
    ccfg, _, cparams, tclip = clip
    ids, mask = _text_ids()
    image = solo.x[0]
    jr = jris.ZeroShotRIS(_jcfg(ccfg), _jcfg(solo.cfg), cparams, solo.params,
                          alpha=0.95, clip_image_size=32, mesh=_mesh())
    want, wextras = jr._jit_fused(solo.params, cparams, jnp.asarray(image),
                                  jnp.asarray(ids), jnp.asarray(mask),
                                  image.shape[-2:])
    kw = dict(alpha=0.95, clip_image_size=32)
    split = tris.ZeroShotRIS(ccfg, solo.cfg, tclip, solo.tm, devices=("cpu", "cpu"),
                             **kw)
    whole = tris.ZeroShotRIS(ccfg, solo.cfg, tclip, solo.tm, **kw)
    assert len(split.replicas) == 2 and split.replicas[1] is tclip
    args = (torch.from_numpy(image), torch.from_numpy(ids), torch.from_numpy(mask),
            image.shape[-2:])
    with torch.no_grad():
        picked, got = split._fused_forward(*args)
        _, one = whole._fused_forward(*args)
    assert int(got["valid"].sum()) >= 2
    np.testing.assert_array_equal(picked.numpy(), np.asarray(want))
    for k in ("mask_features", "crop_features", "phrase_features", "class_features"):
        _close(got[k], np.asarray(wextras[k]))
        torch.testing.assert_close(got[k], one[k], rtol=0,
                                   atol=1e-6 * one[k].abs().max().item())
    np.testing.assert_array_equal(split.predict_fused(image, ids, mask), np.asarray(want))
    np.testing.assert_array_equal(split(image, ids, mask), np.asarray(want))
    from tunevlseg_torch import eval_zeroshot
    assert eval_zeroshot.proposal_devices(2, torch.device("cpu")) == (
        torch.device("cpu"),) * 2

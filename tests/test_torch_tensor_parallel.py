"""Tensor and sequence parallelism in the port (`tunevlseg_torch/parallel/
mesh.py`, `sharding_rules.py`, `tensor_parallel.py`,
`activation_sharding.py`) on gloo ranks on the CPU, against the JAX
package's `model` mesh axis on the 8-device CPU mesh.

The ranks run in spawned processes that import no JAX
(`tests/torch_tensor_parallel_ranks.py`): one spawn of two ranks (a grid of
1 x 2) and one of four (2 x 2), while the parent computes the JAX side.

  * (i) the set of tensors the port slices equals the JAX `tp_param_specs`
    leaves that are not `P()`, mapped by name, for tiny CLIPSeg MaPLe, CRIS
    CoOp and the TransformerSegmentor (CLIP and SigLIP towers) at tp = 2,
    with the same shard report; at tp = 4 the one difference, by design: a
    2-head attention block is replicated whole (the JAX rule cuts its 16
    columns mid-head), warned as a fallback; a leaf that does not divide
    falls back in both; tp = 1 logs nothing;
  * (ii) three tp = 2 steps of tiny MaPLe against JAX `make_mesh(8,
    model_parallel=2)` (`tests/test_training.py::
    test_tensor_parallel_matches_data_parallel`'s model, batch and
    tolerances) on the losses and metrics, both ranks bit-identical, the
    frozen checkpoint whole, a predict step against one process;
  * (iii) sequence parallelism against plain tp = 2 at 48^2 (14 vision and
    16 text tokens: both streams shard) and 32^2 (9 vision tokens: that
    stream stays replicated);
  * (iv) dp 2 x tp 2 under DDP and under FSDP against the JAX mesh;
  * tp = 2 on CRIS CoOp and both TransformerSegmentors against one process;
  * (v) the train and eval CLIs with `trainer.n_devices=2
    trainer.model_parallel=2 +trainer.device=cpu`.

Tolerances: the JAX test's (rtol 2e-5, atol 2e-6) on losses and metrics
against JAX; port against port where the row-parallel sums split a product
in two: losses to 1e-5 and weights to 1e-5 of a leaf's scale after the
steps; sequence against plain tensor parallelism: the losses and metrics
bit for bit (the same products on the same rows, a sum of two in either
collective), the weights to PORT_TOL (the contexts' gradient is summed over
the batch rows from the all-reduce's contiguous copy where plain tensor
parallelism sums a strided slice: another order)."""
import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tests import torch_tensor_parallel_ranks as ranks_mod  # noqa: E402
from tests.test_torch_accumulate import _filled, _synthetic_batch  # noqa: E402
from tests.test_torch_cli import _common, synth  # noqa: E402,F401
from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPSegConfig as JConfig  # noqa: E402
from tunevlseg_tpu.models.clip.config import CLIPTextConfig as JTextConfig  # noqa: E402
from tunevlseg_tpu.models.cris.model import CRISConfig as JCRISConfig  # noqa: E402
from tunevlseg_tpu.models.trans_segmentor import model as jts  # noqa: E402
from tunevlseg_tpu.parallel import mesh as mesh_lib  # noqa: E402
from tunevlseg_tpu.parallel import sharding_rules as jrules  # noqa: E402
from tunevlseg_tpu.training import optim as joptim  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_tpu.training.task import TrainState as JTrainState  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params, port_name,  # noqa: E402
                                              state_dict_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.models.cris.model import CRISConfig  # noqa: E402
from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig  # noqa: E402
from tunevlseg_torch.parallel import sharding_rules  # noqa: E402
from tunevlseg_torch.parallel.mesh import Mesh  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402

KEY = jax.random.PRNGKey(0)
RTOL, ATOL = 2e-5, 2e-6
PORT_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def _logged(name: str, fn):
    """(fn's result, the messages logger `name` got while it ran)."""
    logger = logging.getLogger(name)
    collector = _Collect()
    logger.addHandler(collector)
    try:
        return fn(), collector.records
    finally:
        logger.removeHandler(collector)


def _report(messages) -> tuple:
    (line,) = [m for m in messages if "shard report" in m]
    return tuple(int(x) for x in re.findall(r"(\d+) (?:params|replicated)", line))


def _cris_batch(seed, b=4, img=64, unique=2):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, (unique, 12)).astype(np.int32)
    ids[:, 0], ids[:, 8], ids[:, 9:] = 49406, 49407, 0
    return {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
            "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "text_index": (np.arange(b) % unique).astype(np.int32)}


# the families of (i): the JAX model and spec, its init inputs, the port's
# model built the same way
def _jax_maple(text=None):
    cfg = JConfig.tiny(**({"text": text} if text else {}))
    return jpresets.build_clipseg("maple", prompt_depth=2, num_context=4,
                                  config=cfg)


def _port_maple(text=None, sd=None):
    cfg = tconfig.CLIPSegConfig.tiny(**({"text": text} if text else {}))
    model, spec = tpresets.build_clipseg("maple", prompt_depth=2, num_context=4,
                                         config=cfg, device="cpu")
    if sd is not None:
        model.load_state_dict(sd)
    return model, spec


def _jax_ts(siglip):
    cfg = jts.TransSegmentorConfig.tiny(**({"encoder_family": "siglip"}
                                           if siglip else {}))
    always = () if cfg.use_existing_proj else ("text_projection",)
    return jts.TransformerSegmentor(cfg), joptim.FreezeSpec(
        freeze_all=False, freeze_encoder=True, family="trans_segmentor",
        always_trainable=always)


def _port_ts(siglip):
    cfg = TransSegmentorConfig.tiny(**({"encoder_family": "siglip"}
                                       if siglip else {}))
    return tpresets.build_trans_segmentor(cfg, freeze_encoders=True, device="cpu")


FAMILIES = {
    "maple": (_jax_maple, _port_maple, lambda: _synthetic_batch(0)),
    "cris": (lambda: jpresets.build_cris("coop", config=JCRISConfig.tiny()),
             lambda: tpresets.build_cris("coop", config=CRISConfig.tiny(),
                                         device="cpu"),
             lambda: _cris_batch(0)),
    "trans_seg": (lambda: _jax_ts(False), lambda: _port_ts(False),
                  lambda: _synthetic_batch(0)),
    "trans_seg_siglip": (lambda: _jax_ts(True), lambda: _port_ts(True),
                         lambda: _synthetic_batch(0)),
}


def _jax_frozen(jm, jspec, batch):
    """The JAX Trainer's frozen tree ({"params": frozen params, and the
    BatchNorm statistics where the model has them}) of the model's shapes."""
    extra = {"text_index": batch["text_index"]} if "text_index" in batch else {}
    shapes = jax.eval_shape(lambda *a: jm.init(KEY, *a, **extra),
                            batch["input_ids"], batch["image"].astype(np.float32),
                            batch["attention_mask"])
    _, frozen = joptim.partition_params(shapes["params"], jspec)
    return {"params": frozen, **{k: v for k, v in shapes.items() if k != "params"}}


def _jax_sharded(frozen, tp) -> tuple[set, tuple, list]:
    """(port names of the JAX leaves that are not P(), the shard report's
    counts, the warnings) under JAX `tp_param_specs` on make_mesh(8, tp)."""
    specs, messages = _logged(
        "tunevlseg_tpu.parallel.sharding_rules",
        lambda: jrules.tp_param_specs(frozen, mesh_lib.make_mesh(8, tp)))
    # the trainable places of the frozen tree are None
    names = {port_name(path[1:])[0] for path, spec in flatten_params(specs).items()
             if spec is not None and spec != jax.sharding.PartitionSpec()}
    return names, _report(messages) if tp > 1 else (), messages


def _port_sharded(model, spec, tp) -> tuple[set, tuple, list]:
    SegmentationTask(model, spec).init()     # the freeze spec
    specs, messages = _logged(
        "tunevlseg_torch.parallel.sharding_rules",
        lambda: sharding_rules.tp_param_specs(model, Mesh(1, tp)))
    return ({n for n, d in specs.items() if d is not None},
            _report(messages) if tp > 1 else (), messages)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_set_and_report_match_jax_rules_at_tp2(family):
    jbuild, tbuild, batch = FAMILIES[family]
    jm, jspec = jbuild()
    jnames, jreport, jwarn = _jax_sharded(_jax_frozen(jm, jspec, batch()), 2)
    model, spec = tbuild()
    tnames, treport, twarn = _port_sharded(model, spec, 2)
    assert jnames and tnames == jnames
    assert treport == jreport
    assert not [m for m in twarn if "FALLBACK:" in m]
    for n in tnames:                  # only frozen tensors are sliced
        assert not dict(model.named_parameters())[n].requires_grad


def test_head_granular_difference_and_fallbacks_at_tp4_silence_at_tp1():
    """tp = 4 on MaPLe whose text MLP is 34 wide: the text fc1 / fc2 do not
    divide, a fallback in both packages; the 2-head attention blocks (text
    16, vision 24 and decoder 8 columns, all divisible by 4) the JAX rule
    shards leaf by leaf and the port replicates whole, with a warning per
    leaf. tp = 1: no warning and no report in either."""
    text = dict(vocab_size=49408, hidden_size=16, num_layers=4, num_heads=2,
                intermediate_size=34, max_position_embeddings=77)
    jm, jspec = _jax_maple(JTextConfig(**text))
    frozen = _jax_frozen(jm, jspec, _synthetic_batch(0))
    jnames, jreport, jwarn = _jax_sharded(frozen, 4)
    model, spec = _port_maple(tconfig.CLIPTextConfig(**text))
    tnames, treport, twarn = _port_sharded(model, spec, 4)
    attention = {n for n in jnames if ".self_attn." in n}
    assert attention and tnames == jnames - attention
    jfall = [m for m in jwarn if "FALLBACK:" in m]
    tfall = [m for m in twarn if "FALLBACK:" in m]
    assert jfall and all("text_model" in m and "fc" in m for m in jfall)
    assert len(tfall) == len(jfall) + len(attention)
    heads = [m for m in tfall if "heads do not divide by model_parallel=4" in m]
    assert len(heads) == len(attention)
    assert treport == (len(tnames), jreport[1], jreport[2] + len(attention))
    assert _jax_sharded(frozen, 1)[2] == []
    assert _port_sharded(*_port_maple(), 1)[2] == []


def _jax_tp_steps(jm, jspec, params, batch, model_parallel):
    """Three JAX steps on make_mesh(8, model_parallel) with the tp rules on
    the frozen tree: each step's metrics."""
    jtask = JTask(jm, jspec, learning_rate=ranks_mod.LR, donate_state=False)
    trainable, frozen_params = joptim.partition_params(params, jspec)
    state = JTrainState(jnp.zeros((), jnp.int32), trainable,
                        jtask.tx.init(trainable), jax.random.fold_in(KEY, 1), {})
    mesh = mesh_lib.make_mesh(8, model_parallel=model_parallel)
    frozen = {"params": frozen_params}
    fsh = jrules.tp_shardings(frozen, mesh)
    frozen = jrules.shard_tree(frozen, fsh)
    state = mesh_lib.replicate(mesh, state)
    train, _, _ = jtask.compile_steps(mesh, frozen_shardings=fsh)
    sharded = mesh_lib.shard_batch(mesh, batch)
    out = []
    for _ in range(ranks_mod.STEPS):
        state, metrics = train(state, frozen, sharded)
        out.append({k: float(v) for k, v in metrics.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns, the JAX mesh's steps, and the one-process references."""
    batch = _synthetic_batch(7)
    jm, jspec = _jax_maple()
    shapes = jax.eval_shape(jm.init, KEY, batch["input_ids"], batch["image"],
                            batch["attention_mask"])
    params = _filled(shapes["params"], 3)
    maple_model, _ = _port_maple()
    maple_sd = state_dict_from_jax(params, maple_model)
    families = {}
    for key, build in (("cris", lambda: tpresets.build_cris(
            "coop", config=CRISConfig.tiny(), device="cpu", seed=4)),
            ("ts", lambda: tpresets.build_trans_segmentor(
                TransSegmentorConfig.tiny(), freeze_encoders=True, device="cpu",
                seed=5)),
            ("ts_siglip", lambda: tpresets.build_trans_segmentor(
                TransSegmentorConfig.tiny(encoder_family="siglip"),
                freeze_encoders=True, device="cpu", seed=6))):
        families[key] = build()[0].state_dict()
    inputs = {"maple": maple_sd, "batches": [batch],
              "sp48": [_synthetic_batch(8, img=48)], "sp32": [_synthetic_batch(9)],
              "cris": families["cris"], "cris_batches": [_cris_batch(1), _cris_batch(2)],
              "ts": families["ts"],
              "ts_batches": [_synthetic_batch(10), _synthetic_batch(11)],
              "ts_siglip": families["ts_siglip"],
              "siglip_batches": [_synthetic_batch(12), _synthetic_batch(13)]}
    work2, work4 = (tmp_path_factory.mktemp(f"tp{w}") for w in (2, 4))
    for work in (work2, work4):
        torch.save(inputs, work / "inputs.pt")
    two = ranks_mod.spawn(work2, ("tp2", "sp", "families", "trainer_mesh"), 2)
    four = ranks_mod.spawn(work4, ("dp2tp2",), 4)

    want = _jax_tp_steps(jm, jspec, params, batch, 2)
    one = Mesh(1, 1)
    ref = {"cris": ranks_mod.steps(ranks_mod.cris(inputs["cris"]),
                                   inputs["cris_batches"], one, n_steps=2),
           "ts": ranks_mod.steps(ranks_mod.trans_seg(inputs["ts"], False),
                                 inputs["ts_batches"], one, n_steps=2),
           "ts_siglip": ranks_mod.steps(ranks_mod.trans_seg(inputs["ts_siglip"], True),
                                        inputs["siglip_batches"], one, n_steps=2)}
    task = ranks_mod.maple(maple_sd)
    ref["maple"] = ranks_mod.steps(task, inputs["batches"], one)
    ref["probs"] = task.predict_step(ranks_mod.local(batch, one))
    return {"got2": ranks_mod.collect(two, work2),
            "got4": ranks_mod.collect(four, work4), "want": want, "ref": ref,
            "inputs": inputs, "work2": work2}


def _hold_metrics(seen, want):
    for rec, jm in zip(seen, want, strict=True):
        for key, value in jm.items():
            np.testing.assert_allclose(rec["metrics"][key], value, rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def _same_trainable(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[n], b[n]) for n in a)


def _close_trainable(got, want, steps=ranks_mod.STEPS):
    """Each weight within PORT_TOL of its scale. A key projection's bias has
    a zero gradient in exact arithmetic (the softmax does not see a shift of
    a row's scores), so Adam moves it by rounding noise, up to a learning
    rate a step: held to what the steps can move it."""
    for n, w in want.items():
        diff = (got[n] - w).abs().max().item()
        if n.endswith("k_proj.bias"):
            assert diff <= 2 * steps * ranks_mod.LR, n
            continue
        assert diff <= PORT_TOL * max(1.0, w.abs().max().item()), n


def test_tp2_steps_match_the_jax_mesh(runs):
    r0, r1 = (g["tp2"] for g in runs["got2"])
    _hold_metrics(r0["steps"], runs["want"])
    assert [s["metrics"] for s in r0["steps"]] == [s["metrics"] for s in r1["steps"]]
    assert _same_trainable(r0["trainable"], r1["trainable"])
    _close_trainable(r0["trainable"], runs["ref"]["maple"]["trainable"])
    # one head of two a rank; the sliced frozen tensors halve on each rank
    assert r0["local_heads"] == 1 and r0["plan"]
    whole, mine = r0["frozen_bytes"]
    sliced = sum(runs["inputs"]["maple"][n].numel() * 4 for n in r0["plan"])
    assert mine == whole - sliced // 2
    assert all(s["bytes"]["all_reduce"] > 0 and s["bytes"]["all_gather"] == 0
               for s in r0["steps"])


def test_tp2_predict_and_the_frozen_checkpoint_holds_whole_tensors(runs):
    r0, r1 = (g["tp2"] for g in runs["got2"])
    assert torch.equal(r0["probs"], r1["probs"])
    torch.testing.assert_close(r0["probs"], runs["ref"]["probs"], rtol=0,
                               atol=PORT_TOL)
    saved = torch.load(runs["work2"] / "tp_ckpt" / "frozen" / "frozen.pt",
                       weights_only=True)
    sd = runs["inputs"]["maple"]
    assert set(r0["plan"]) <= set(saved)
    for n in saved:
        assert torch.equal(saved[n], sd[n]), n
    assert r0["restored"] and r1["restored"]


def test_sequence_parallel_matches_plain_tensor_parallel(runs):
    for rank in runs["got2"]:
        sp = rank["sp"]
        assert sp[(48, True)]["towers"] == 2
        for img in (48, 32):
            plain, seq = sp[(img, False)], sp[(img, True)]
            assert [s["metrics"] for s in plain["steps"]] == \
                [s["metrics"] for s in seq["steps"]], img
            _close_trainable(seq["trainable"], plain["trainable"])
        # both streams shard at 48^2: all-gathers and reduce-scatters take
        # the towers' all-reduces' place (the decoder's stay)
        sharded = sp[(48, True)]["steps"][0]["bytes"]
        plain = sp[(48, False)]["steps"][0]["bytes"]
        assert sharded["all_gather"] > 0 and sharded["reduce_scatter"] > 0
        assert 0 < sharded["all_reduce"] < plain["all_reduce"]
        # at 32^2 only the text stream (16 tokens) shards
        assert 0 < sp[(32, True)]["steps"][0]["bytes"]["all_gather"] < \
            sharded["all_gather"]


def test_trainer_sets_its_mesh_and_refuses_another_ranks(runs):
    for rank in runs["got2"]:
        got = rank["trainer_mesh"]
        assert got["unbound"] and got["bound"]
        assert got["set"] and got["cleared"]
        # no groups, another model rank, the groups swapped
        assert len(got["refused"]) == 3, got["refused"]
        assert "rank" in got["refused"][1]
        assert "model group" in got["refused"][2]


@pytest.mark.parametrize("family", ["cris", "ts", "ts_siglip"])
def test_tp2_families_match_one_process(runs, family):
    """CRIS CoOp (column-parallel attention pool, heads gathered before
    c_proj; column / row decoder attention; text tower), the
    TransformerSegmentor's CLIP towers under sequence parallelism and its
    SigLIP towers: the ranks agree bit for bit and match one process."""
    r0, r1 = (g["families"][family] for g in runs["got2"])
    ref = runs["ref"][family]
    assert r0["plan"] and _same_trainable(r0["trainable"], r1["trainable"])
    for got, want in zip(r0["steps"], ref["steps"], strict=True):
        for key, value in want["metrics"].items():
            assert got["metrics"][key] == pytest.approx(value, abs=PORT_TOL), key
    _close_trainable(r0["trainable"], ref["trainable"], steps=2)


def test_dp2_tp2_with_and_without_fsdp_match_the_jax_mesh(runs):
    ranks = [g["dp2tp2"] for g in runs["got4"]]
    for key in ("ddp", "fsdp"):
        _hold_metrics(ranks[0][key]["steps"], runs["want"])
        # tp peers (0, 1) and data peers (0, 2) land on the same weights
        for other in ranks[1:]:
            assert _same_trainable(ranks[0][key]["trainable"],
                                   other[key]["trainable"]), key
    fsdp_whole, fsdp_mine = ranks[0]["fsdp"]["frozen_bytes"]
    ddp_whole, ddp_mine = ranks[0]["ddp"]["frozen_bytes"]
    # FSDP shards the replicated rest over the data group: what is left as
    # plain tensors on a rank is only the tensor-parallel slices
    assert fsdp_mine < ddp_mine < ddp_whole == fsdp_whole
    _close_trainable(ranks[0]["ddp"]["trainable"], ranks[0]["fsdp"]["trainable"])


def test_cli_trains_and_evaluates_on_a_tp2_grid(synth, tmp_path):
    """The train CLI on two CPU ranks as one model group, then the eval CLI
    from its checkpoint on the grid with sequence parallelism and on one
    process: the checkpoint holds whole tensors, the masks are written once
    per sample, and the two evaluations agree."""
    from tunevlseg_torch import eval as eval_mod
    from tunevlseg_torch import train as train_mod
    out = tmp_path / "logs"
    grid = ["trainer.n_devices=2", "trainer.model_parallel=2"]
    result = train_mod.main(_common(synth, out) + grid + [
        "trainer.max_epochs=1", "predict=true", "exp_name=tp2"])
    assert np.isfinite(result["test_loss"]) and 0 <= result["test_dice"] <= 1
    ckpt = out / "train" / "tp2" / "checkpoints"
    frozen = torch.load(ckpt / "frozen" / "frozen.pt", weights_only=True)
    width = tconfig.CLIPSegConfig.tiny().vision.hidden_size
    for leaf in ("q_proj.weight", "q_proj.bias", "out_proj.weight"):
        assert frozen[f"vision_model.layers.0.self_attn.{leaf}"].shape[0] == width
    assert frozen["vision_model.layers.0.mlp.fc2.weight"].shape[1] == \
        tconfig.CLIPSegConfig.tiny().vision.intermediate_size
    assert len(list(Path(result["output_masks_dir"]).glob("*.png"))) == 8
    evals = {}
    for name, extra in (("grid", grid + ["trainer.seq_shard=true"]), ("one", [])):
        evals[name] = eval_mod.main(_common(synth, out) + extra + [
            f"ckpt_path={ckpt}", f"exp_name=eval_{name}", "predict=false"])
    for key in ("test_loss", "test_dice", "test_iou"):
        assert evals["grid"][key] == pytest.approx(evals["one"][key], abs=PORT_TOL)

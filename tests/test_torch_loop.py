"""The port's training loop and checkpoints (`training/loop.py`,
`training/checkpoint.py`) on tiny CLIPSeg CoOp and CRIS models on the CPU,
mirroring tests/test_training.py: overfitting one batch, eval accumulation,
`valid` masking, the CRIS e2e BatchNorm statistics through a save / restore,
resume equal to an uninterrupted run (after a finished fit, after SIGTERM,
mid-epoch, after a hard kill with interval snapshots), the historical best,
crash safety of the staging write and of the promotion, and
`steps_per_execution`. One test holds a whole 2-epoch fit against the JAX
`Trainer` from the same weights on the same samples in the same order.

A resumed run is compared with the uninterrupted one bit for bit: both run
the same CPU kernels on the same values in the same order."""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tunevlseg_torch.data.pipeline import DataLoader, collate, device_batch
from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.clipseg.model import CLIPSegForSegmentation
from tunevlseg_torch.models.cris.model import CRISConfig
from tunevlseg_torch.models.presets import build_clipseg, build_cris
from tunevlseg_torch.models.prompt.learners import CoOpLearner
from tunevlseg_torch.nn.layers import init_params
from tunevlseg_torch.ops.metrics import SegMetricState, compute
from tunevlseg_torch.training import loop as loop_mod
from tunevlseg_torch.training.checkpoint import CheckpointManager
from tunevlseg_torch.training.loop import EarlyStopping, Trainer
from tunevlseg_torch.training.optim import (FreezeSpec, ReduceLROnPlateau,
                                            get_learning_rate)
from tunevlseg_torch.training.task import SegmentationTask

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread for each test: the tiny models run thousands of
    small ops, and with the test workers sharing the host's cores each op's
    OpenMP team waits for its descheduled threads (the overfit test: 36 s
    against 5 s beside six busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n, seed=0, img=32, seq=12, pad=49407):
    """CLIP-style samples with one prompt: uint8 image, a blob mask
    correlated with nothing, ids BOS + 7 words + EOS + padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(seq,)).astype(np.int32)
    ids[0], ids[8], ids[9:] = 49406, 49407, pad
    return [{"image": rng.integers(0, 256, (3, img, img), dtype=np.uint8),
             "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != pad).astype(np.int32),
             "mask_name": f"{seed}_{i}.png",
             "mask_shape": np.asarray([img + 8, img + 4]), "prompt": "p"}
            for i in range(n)]


class _ListDataset:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[int(i)]


def _loaders(n_train=16, n_val=8, batch=8, text_dedup=1):
    return (DataLoader(_ListDataset(_samples(n_train, 0)), batch, shuffle=True,
                       seed=7, num_workers=2, text_dedup=text_dedup),
            DataLoader(_ListDataset(_samples(n_val, 1)), batch, num_workers=2,
                       text_dedup=text_dedup))


def _coop_task(lr=1e-2):
    """A fresh tiny CoOp task; every call gives the same weights."""
    model, spec = build_clipseg("coop", prompt_depth=2, num_context=4,
                                config=CLIPSegConfig.tiny(), device="cpu")
    task = SegmentationTask(model, spec, learning_rate=lr)
    return task, task.init()


def _trainer(task, out, **kw):
    return Trainer(task, out, scheduler=ReduceLROnPlateau(factor=0.5, patience=1),
                   early_stopping=EarlyStopping(patience=50), log_image_num=0,
                   **kw)


def _snapshot(tr, state):
    """What a resumed fit must reproduce: trainable tensors, optimizer
    moments, step, learning rate, scheduler and early-stopping state, best."""
    model = tr.task.model
    opt = state.optimizer.optimizer
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return {"trainable": {n: p.detach().clone() for n, p in params},
            "moments": {n: {k: v.clone() for k, v in opt.state[p].items()}
                        for n, p in params if p in opt.state},
            "step": state.step, "lr": get_learning_rate(state.optimizer),
            **tr._fit_extra(), "best_value": tr.ckpt.best_value}


def _assert_same(a, b, path="snapshot"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_overfit_one_batch():
    """params update, the loss drops, frozen weights stay: the "residual"
    blend gives the trainable additive head a direct path to the logits."""
    cfg = CLIPSegConfig.tiny()
    model = CLIPSegForSegmentation(
        cfg, learner=CoOpLearner(prompt_depth=2, num_context=4,
                                 context_dim=cfg.text.hidden_size),
        additive_mode="residual")
    init_params(model, torch.Generator().manual_seed(0))
    task = SegmentationTask(model, FreezeSpec(freeze_all=True,
                                              use_new_last_layer=True),
                            learning_rate=1e-2)
    batch = {k: torch.from_numpy(v) for k, v in device_batch(
        collate(_samples(8), 8, text_dedup=1)).items()}
    batch["mask"] = torch.ones_like(batch["mask"])
    state = task.init()
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    n_frozen = sum(p.numel() for p in model.parameters() if not p.requires_grad)
    assert n_train < 2000 and n_frozen > 50_000, (n_train, n_frozen)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    losses = []
    for _ in range(40):
        state, m = task.train_step(state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0] - 0.05, (losses[0], losses[-1])
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n


@pytest.mark.parametrize("n_val", [24, 12], ids=["full", "padded"])
def test_eval_accumulates_and_masks_padding(tmp_path, n_val):
    """`_run_eval` over a loader equals one eval over the real samples at
    once: sums over batches, padded samples (valid = 0) left out of the
    metrics."""
    task, state = _coop_task()
    _, val = _loaders(n_val=n_val)
    tr = _trainer(task, tmp_path)
    got = tr._run_eval(state, val, "val")
    assert set(got) == {"val_dice", "val_iou", "val_loss"}
    assert len(val) == (3 if n_val == 24 else 2)
    last = list(val)[-1]
    assert last["valid"].sum() == (8 if n_val == 24 else 4)
    whole = {k: torch.from_numpy(v) for k, v in device_batch(
        collate(_samples(n_val, 1), n_val, text_dedup=1)).items()}
    del whole["valid"]
    mstate, extra = task.eval_step(SegMetricState.zeros(), whole, state)
    assert mstate.n_samples.item() == n_val
    want = {f"val_{k}": v.item() for k, v in compute(mstate).items()}
    if n_val == 24:
        # a padded sample adds the constant loss term the JAX task gives it
        # (zeroed logits and mask), so only full batches add up to this
        want["val_loss"] = (extra["loss_sum"] / extra["n"]).item()
    assert np.isfinite(got["val_loss"])
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    preds = task.predict_step(whole, state)
    assert preds.shape == (n_val, 1, 32, 32)
    assert bool(((preds >= 0) & (preds <= 1)).all())


def test_cris_e2e_batch_stats_update_and_round_trip(tmp_path):
    """e2e CRIS: the head's BatchNorm running statistics move in the train
    state, the frozen backbone's do not, and `model_state` comes back from a
    checkpoint as it went in."""
    def make():
        model, spec = build_cris("e2e", config=CRISConfig.tiny(), device="cpu")
        assert model.bn_train
        task = SegmentationTask(model, spec, learning_rate=1e-3,
                                mutable_collections=("batch_stats",))
        return task, task.init()

    task, state = make()
    before = {k: v.clone() for k, v in state.model_state.items()}
    train = DataLoader(_ListDataset(_samples(4, img=64, pad=0)), 2,
                       num_workers=1)
    tr = _trainer(task, tmp_path, max_epochs=1)
    state = tr.fit(state, train)
    assert state.step == 2
    neck = "neck.f1_v_proj.bn.running_mean"
    assert (state.model_state[neck] - before[neck]).abs().max() > 0
    torch.testing.assert_close(state.model_state["visual.bn1.running_mean"],
                               before["visual.bn1.running_mean"], rtol=0, atol=0)
    # no validation: the epoch's end saves 'last'; restore into a fresh task
    task2, state2 = make()
    restored = CheckpointManager(tmp_path / "checkpoints",
                                 task2.model).restore("last", state2)
    assert restored.step == 2
    _assert_same(restored.model_state, state.model_state)
    for (n, p), (_, q) in zip(task.model.named_parameters(),
                              task2.model.named_parameters()):
        assert torch.equal(p, q), n


def test_fit_resume_matches_uninterrupted(tmp_path):
    """4 epochs straight against 2 epochs and a fresh trainer resuming from
    `last` for 2 more: weights, moments, step, learning rate, scheduler and
    early-stopping counters and best value all equal."""
    train, val = _loaders()
    task, state = _coop_task()
    tr_a = _trainer(task, tmp_path / "a", max_epochs=4)
    snap_a = _snapshot(tr_a, tr_a.fit(state, train, val))

    task, state = _coop_task()
    tr_b = _trainer(task, tmp_path / "b", max_epochs=2)
    tr_b.fit(state, train, val)
    assert tr_b.ckpt.best_value is not None
    task, state = _coop_task()
    tr_c = _trainer(task, tmp_path / "b", max_epochs=4)
    snap_c = _snapshot(tr_c, tr_c.fit(state, train, val, resume_from="last"))
    assert snap_c["step"] == 8
    _assert_same(snap_a, snap_c)


def test_restore_keeps_historical_best(tmp_path):
    task, state = _coop_task()
    mgr = CheckpointManager(tmp_path / "ck", task.model, monitor="val_dice")
    mgr.best_value = 0.9
    mgr.save("last", state, {"epoch": 3})
    meta = mgr.load_meta("last")
    assert meta["best_value"] == 0.9 and meta["epoch"] == 3
    assert mgr.restore("last", state).step == 0
    # a worse value does not demote it, a better one replaces it
    assert not mgr.maybe_save_best(state, {"val_dice": 0.5}, 4)
    assert mgr.best_value == 0.9 and not (tmp_path / "ck" / "best").exists()
    assert mgr.maybe_save_best(state, {"val_dice": 0.95}, 5)
    assert mgr.load_meta("best")["best_value"] == 0.95


def test_staging_write_preserves_old_checkpoint(tmp_path, monkeypatch):
    """A write in flight never touches the promoted checkpoint: it lands in
    `.staging-<tag>` and the swap and meta wait for the next drain; a write
    that fails leaves the old checkpoint as it was and surfaces at the
    drain."""
    task, state = _coop_task()
    ck = tmp_path / "ck"
    mgr = CheckpointManager(ck, task.model, monitor="val_dice")
    mgr.save("last", state, {"epoch": 1})
    mgr.wait()
    assert (ck / "last").exists() and mgr.load_meta("last")["epoch"] == 1

    state2 = type(state)(state.step + 1, state.optimizer, state.model_state)
    mgr.save("last", state2, {"epoch": 2})
    assert json.loads((ck / "last.json").read_text())["epoch"] == 1
    assert torch.load(ck / "last" / "state.pt", weights_only=True)["step"] == 0
    assert [p[0] for p in mgr._pending] == ["last"]
    mgr.wait()
    assert not mgr._pending and not (ck / ".staging-last").exists()
    assert mgr.load_meta("last")["epoch"] == 2
    assert mgr.restore("last", state).step == state.step + 1

    def broken_save(obj, path):
        Path(path).write_bytes(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    mgr.save("last", state, {"epoch": 3})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    monkeypatch.undo()
    assert mgr.load_meta("last")["epoch"] == 2
    assert mgr.restore("last", state).step == state.step + 1


def test_sigterm_saves_resumable_last(tmp_path):
    """SIGTERM mid-fit finishes the step in flight, writes a resumable
    'last' (preempted, epoch rolled back to the last completed one) and
    returns; a fresh trainer resumes from it; the SIGTERM disposition from
    before the fit is back."""
    train, val = _loaders()
    task, state = _coop_task()
    tr = _trainer(task, tmp_path / "p", max_epochs=500)

    def preempt():
        while not (tr.ckpt.dir / "last").exists():
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    prev_handler = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=preempt, daemon=True)
    t.start()
    final = tr.fit(state, train, val)
    t.join(timeout=30)
    assert final.step < 500 * 2
    meta = tr.ckpt.load_meta("last")
    assert meta.get("preempted") is True and meta["epoch"] >= 0
    task, state2 = _coop_task()
    tr2 = _trainer(task, tmp_path / "p", max_epochs=meta["epoch"] + 2)
    final2 = tr2.fit(state2, train, val, resume_from="last")
    assert final2.step >= final.step
    assert signal.getsignal(signal.SIGTERM) == prev_handler


def test_step_level_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """Preempted after the first batch of epoch 1 and resumed, the run
    replays only that epoch's tail and ends bit-identical to an
    uninterrupted one."""
    train, val = _loaders()          # 2 batches an epoch
    task, state = _coop_task()
    tr_a = _trainer(task, tmp_path / "a", max_epochs=3)
    snap_a = _snapshot(tr_a, tr_a.fit(state, train, val))

    class _FakeWatch:     # one call per consumed group: epoch 1's first is 3
        calls = 0

        def install(self):
            return self

        def uninstall(self):
            pass

        def preempted(self):
            _FakeWatch.calls += 1
            return _FakeWatch.calls >= 3

    monkeypatch.setattr(loop_mod, "_PreemptionWatch", _FakeWatch)
    task, state = _coop_task()
    tr_b = _trainer(task, tmp_path / "b", max_epochs=3)
    assert tr_b.fit(state, train, val).step == 3
    meta = tr_b.ckpt.load_meta("last")
    assert meta.get("preempted") is True
    assert meta["epoch"] == 0 and meta["batch_offset"] == 1
    monkeypatch.undo()

    task, state = _coop_task()
    tr_c = _trainer(task, tmp_path / "b", max_epochs=3)
    _assert_same(snap_a, _snapshot(tr_c, tr_c.fit(state, train, val,
                                                  resume_from="last")))


HARD_KILL = textwrap.dedent("""
    import os, signal, sys
    sys.path.insert(0, {tests!r})
    import test_torch_loop as t
    task, state = t._coop_task()
    step = task.train_step
    calls = [0]

    def train_step(*args):
        calls[0] += 1
        if calls[0] == 6:               # epoch 1's third batch
            os.kill(os.getpid(), signal.SIGKILL)
        return step(*args)

    task.train_step = train_step
    train, val = t._loaders(n_train=24)
    t._trainer(task, {out!r}, max_epochs=3, ckpt_every_n_steps=1).fit(
        state, train, val)
""")


def test_interval_snapshot_hard_kill_resume(tmp_path):
    """A process killed with SIGKILL (no SIGTERM, no clean-up) keeps the
    last promoted interval snapshot, taken after epoch 1's first batch (the
    next one, after the second batch, was at most in its staging directory:
    promotion waits for a drain), and a resume from it ends bit-identical to
    an uninterrupted run and clears the staging directory."""
    train, val = _loaders(n_train=24)     # 3 batches an epoch
    task, state = _coop_task()
    tr_a = _trainer(task, tmp_path / "a", max_epochs=3)
    snap_a = _snapshot(tr_a, tr_a.fit(state, train, val))

    out = tmp_path / "b"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", HARD_KILL.format(tests=str(REPO / "tests"),
                                                out=str(out))],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    ck = out / "checkpoints"
    task, state = _coop_task()
    tr_c = _trainer(task, out, max_epochs=3)
    meta = tr_c.ckpt.load_meta("last")
    assert meta.get("mid_epoch") is True
    assert meta["epoch"] == 0 and meta["batch_offset"] == 1
    _assert_same(snap_a, _snapshot(tr_c, tr_c.fit(state, train, val,
                                                  resume_from="last")))
    assert not (ck / ".staging-last").exists()


def test_checkpoint_promotion_crash_recovery(tmp_path):
    """The crash gap of the promotion (tag moved aside, staging not yet
    renamed) is healed by the next drain's recovery sweep."""
    task, state = _coop_task()
    ck = tmp_path / "ck"
    mgr = CheckpointManager(ck, task.model, monitor="val_dice")
    mgr.save("last", state, {"epoch": 0})
    mgr.wait()
    (ck / "last").rename(ck / ".old-last")
    mgr2 = CheckpointManager(ck, task.model, monitor="val_dice")
    mgr2.wait()
    assert (ck / "last").exists() and not (ck / ".old-last").exists()
    assert mgr2.restore("last", state).step == 0
    state2 = type(state)(state.step + 1, state.optimizer, state.model_state)
    mgr2.save("last", state2, {"epoch": 1})
    mgr2.wait()
    assert not (ck / ".old-last").exists()
    assert mgr2.restore("last", state).step == 1


def test_steps_per_execution_matches_sequential(tmp_path):
    """k = 2 runs the same steps as k = 1 (an epoch of 3 batches: one group
    and one straggler) and logs the mean of a group's metrics at its end."""
    train, _ = _loaders(n_train=24)
    finals, logs = [], []
    for k, every in ((1, 1), (2, 2)):
        task, state = _coop_task()
        tr = _trainer(task, tmp_path / f"k{k}", max_epochs=1,
                      steps_per_execution=k, log_every_n_steps=every)
        state = tr.fit(state, train)
        assert state.step == 3
        finals.append(_snapshot(tr, state))
        logs.append({r["step"]: r for r in map(json.loads, (
            tmp_path / f"k{k}" / "metrics.jsonl").read_text().splitlines())})
    _assert_same(*finals)
    assert sorted(logs[1]) == [2]
    for key in ("train_loss", "train_dice", "train_iou"):
        np.testing.assert_allclose(logs[1][2][key],
                                   (logs[0][1][key] + logs[0][2][key]) / 2,
                                   rtol=1e-6)


def test_test_and_predict_use_best_and_write_masks(tmp_path):
    """test(use_best=True) puts the best checkpoint's weights into the model;
    predict writes each valid sample's mask at its original resolution."""
    cv2 = pytest.importorskip("cv2")
    train, val = _loaders(n_val=12)
    task, state = _coop_task()
    tr = _trainer(task, tmp_path, max_epochs=2)
    state = tr.fit(state, train, val)
    best = torch.load(tmp_path / "checkpoints" / "best" / "state.pt",
                      weights_only=True)
    result = tr.test(state, val)
    assert set(result) == {"test_dice", "test_iou", "test_loss"}
    for n, p in task.model.named_parameters():
        if p.requires_grad:
            assert torch.equal(p, best["trainable"][n]), n
    preds = tr.predict(state, val, save_dir=tmp_path / "masks")
    assert len(preds) == 12
    written = sorted((tmp_path / "masks").glob("*.png"))
    assert len(written) == 12
    assert cv2.imread(str(written[0]), cv2.IMREAD_GRAYSCALE).shape == (40, 36)


def test_init_overlays_a_partial_state_dict():
    task, _ = _coop_task()
    model = task.model
    before = {k: v.clone() for k, v in model.state_dict().items()}
    new = torch.full_like(before["learner.context_vectors"], 0.25)
    partial = {"learner.context_vectors": new,
               "visual_projection.weight": torch.zeros(3)}
    # a tensor the model does not build is dropped only under a prefix the
    # converter names (CLIPSeg's early exit elides visual_projection)
    with pytest.raises(KeyError, match="visual_projection.weight"):
        task.init(params=partial)
    task.init(params=partial, elidable=("visual_projection.",))
    after = model.state_dict()
    assert torch.equal(after["learner.context_vectors"], new)
    for k, v in before.items():
        if k != "learner.context_vectors":
            assert torch.equal(after[k], v), k


# the mesh is the port's rank grid (`parallel/mesh.make_mesh`), and another
# object raises; seq_shard without a model axis is a no-op; fsdp needs a
# process group (tests/test_torch_distributed.py runs it on two ranks,
# tests/test_torch_tensor_parallel.py the grid)
@pytest.mark.parametrize("kw,error,item", [
    ({"mesh": object()}, ValueError, "not the port's mesh"),
    ({"seq_shard": True}, None, None),
    ({"fsdp": True}, ValueError, "needs a process group")],
    ids=["kw0-Do not port", "kw1-Do not port", "kw2-Slice G"])   # the ids they had
def test_unported_trainer_options_raise(tmp_path, kw, error, item):
    task, _ = _coop_task()
    if error is None:
        trainer = Trainer(task, tmp_path, **kw)
        assert trainer.seq_shard and trainer.mesh is None
        return
    with pytest.raises(error, match=item):
        Trainer(task, tmp_path, **kw)


# --- against the JAX Trainer ---------------------------------------------------

# the tolerances of tests/test_torch_train.py's 3-step comparison: f32 on the
# CPU in both packages, same formulas, another summation order. Scalars of
# order 1 (losses, dice) agree to 1e-5; an entry of the weights whose
# gradient stays well above the rounding noise in every step (>= 1e-2 of the
# leaf's largest) moves the same way in both and agrees to 2% of the most
# Adam can move it (steps * lr); every entry agrees to twice that.
SCALAR_TOL = 1e-5
WEIGHT_REL_TOL = 0.02
ROBUST_GRAD = 1e-2
GRAD_NOISE = 1e-9
PARITY_LR = 1e-3


def test_fit_matches_jax_trainer(tmp_path):
    """2 epochs of 2 batches (val: 12 samples, the second batch padded) with
    the plateau scheduler, from the same weights, in the same sample order:
    per-epoch val_loss / val_dice, each step's train loss, the learning rate
    after the plateau step and the final trainable weights."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("flax")
    pytest.importorskip("optax")
    from tunevlseg_tpu.data.pipeline import DataLoader as JLoader
    from tunevlseg_tpu.data.pipeline import device_batch as jdevice_batch
    from tunevlseg_tpu.models import presets as jpresets
    from tunevlseg_tpu.models.clip.config import CLIPSegConfig as JConfig
    from tunevlseg_tpu.parallel import mesh as mesh_lib
    from tunevlseg_tpu.training import loop as jloop
    from tunevlseg_tpu.training.optim import ReduceLROnPlateau as JPlateau
    from tunevlseg_tpu.training.optim import get_learning_rate as jget_lr
    from tunevlseg_tpu.training.optim import merge_params
    from tunevlseg_tpu.training.task import SegmentationTask as JTask
    from tunevlseg_torch.convert.from_jax import (state_dict_from_jax,
                                                  trainable_from_jax)

    epochs, train_ds = 2, _ListDataset(_samples(16, 0))
    val_ds = _ListDataset(_samples(12, 1))
    # a plateau on every epoch after the first (nothing is better by 100%):
    # the learning rate halves after epoch 1's validation
    plateau = dict(factor=0.5, patience=0, threshold=1.0)

    def loaders(cls):
        return (cls(train_ds, 8, shuffle=True, seed=7, num_workers=2,
                    text_dedup=1),
                cls(val_ds, 8, num_workers=2, text_dedup=1))

    jmodel, jspec = jpresets.build_clipseg("coop", prompt_depth=2,
                                           num_context=4, config=JConfig.tiny())
    jtask = JTask(jmodel, jspec, learning_rate=PARITY_LR)
    jtrain, jval = loaders(JLoader)
    jstate, frozen = jtask.init(jax.random.PRNGKey(0),
                                jdevice_batch(next(iter(jval))))
    # host copies: the JAX steps donate the state's buffers
    params0 = jax.tree_util.tree_map(
        np.asarray, merge_params(jstate.trainable, frozen["params"]))
    jtr = jloop.Trainer(task=jtask, mesh=mesh_lib.make_mesh(),
                        output_dir=tmp_path / "jax", max_epochs=epochs,
                        log_every_n_steps=1, scheduler=JPlateau(**plateau),
                        early_stopping=jloop.EarlyStopping(), log_image_num=0)
    jfinal = jtr.fit(jstate, frozen, jtrain, jval)

    tmodel, tspec = build_clipseg("coop", prompt_depth=2, num_context=4,
                                  config=CLIPSegConfig.tiny(), seed=1,
                                  device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params0, tmodel))
    ttask = SegmentationTask(tmodel, tspec, learning_rate=PARITY_LR)
    ttrain, tval = loaders(DataLoader)
    grads = []
    ctx = tmodel.learner.context_vectors
    ctx.register_hook(lambda g: grads.append(g.detach().clone()))
    ttr = Trainer(ttask, tmp_path / "torch", max_epochs=epochs,
                  log_every_n_steps=1, scheduler=ReduceLROnPlateau(**plateau),
                  early_stopping=EarlyStopping(), log_image_num=0)
    tfinal = ttr.fit(ttask.init(), ttrain, tval)

    def records(out):
        return [json.loads(line) for line in
                (out / "metrics.jsonl").read_text().splitlines()]

    jrec, trec = records(tmp_path / "jax"), records(tmp_path / "torch")
    assert [r["step"] for r in trec] == [r["step"] for r in jrec]
    assert sum("val_loss" in r for r in trec) == epochs
    assert sum("train_loss" in r for r in trec) == 4
    for j, t in zip(jrec, trec):
        assert set(j) == set(t)
        for key in ("val_loss", "val_dice", "val_iou", "train_loss",
                    "train_dice"):
            if key in j:
                np.testing.assert_allclose(t[key], j[key], rtol=SCALAR_TOL,
                                           atol=SCALAR_TOL, err_msg=key)
    assert get_learning_rate(tfinal.optimizer) == pytest.approx(
        float(jget_lr(jfinal.opt_state)), rel=1e-7) == PARITY_LR / 2
    assert ttr.scheduler.num_bad_epochs == jtr.scheduler.num_bad_epochs
    assert tfinal.step == int(jfinal.step) == 4

    want = trainable_from_jax(jfinal.trainable, tmodel)["learner.context_vectors"]
    start = trainable_from_jax(params0, tmodel)["learner.context_vectors"]
    travel = len(grads) * PARITY_LR * 1.05
    diff = (ctx.detach() - want).abs()
    assert len(grads) == 4 and diff.max().item() <= 2 * travel
    gmin = torch.stack([g.abs() for g in grads]).amin(dim=0)
    gtop = max(g.abs().max().item() for g in grads)
    robust = (gmin >= ROBUST_GRAD * gtop) & (gmin > 100 * GRAD_NOISE)
    assert robust.sum() > 10
    assert diff[robust].max().item() <= WEIGHT_REL_TOL * travel
    assert ((want - start).abs()[robust] > PARITY_LR).float().mean() > 0.5

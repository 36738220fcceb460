"""Gradient accumulation (`accumulate_grad_batches`, optax.MultiSteps'
semantics in `training/optim.ClippedOptimizer`) in the port.

  * k micro-batches land on the weights of one step over the concatenated
    batch (the counterpart of JAX
    `tests/test_training.py::test_accumulate_grad_batches_matches_full_batch`,
    at its atol 1e-6 / rtol 1e-5), and the learning rate stays reachable;
  * the port with k = 2 and the global-norm clip against the JAX
    `SegmentationTask(accumulate_grad_batches=2)` over 4 micro-steps, and
    DenseCLIP with k = 2 against the JAX `DenseCLIPTask`, whose poly
    schedule counts optimizer updates: the running mean after the first
    micro-step against the JAX accumulator, mid-window weights unmoved on
    both sides, losses at 1e-5, weights after each update at the
    strategy-parity rule of `tests/test_torch_train.py`;
  * the optimizer's edges: a partial window moves neither the weights nor
    AdamW's moments and step count; a parameter without a gradient in a
    micro-step counts as zero; a learning rate set mid-window is the next
    update's;
  * `Trainer.fit`: a window left partial at an epoch's end carries into the
    next, a checkpoint written mid-window holds it, and a resume from there
    is bit-identical to the uninterrupted run."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.models.clip.config import CLIPSegConfig as JConfig  # noqa: E402
from tunevlseg_tpu.models.clipseg.model import (  # noqa: E402
    CLIPSegForSegmentation as JCLIPSeg)
from tunevlseg_tpu.models.denseclip import model as jdc_model  # noqa: E402
from tunevlseg_tpu.models.prompt.learners import CoOpLearner as JCoOp  # noqa: E402
from tunevlseg_tpu.training import denseclip_task as jdc_task  # noqa: E402
from tunevlseg_tpu.training.optim import FreezeSpec as JFreezeSpec  # noqa: E402
from tunevlseg_tpu.training.optim import partition_params  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_tpu.training.task import TrainState as JTrainState  # noqa: E402
from tunevlseg_torch.convert.from_jax import (state_dict_from_jax,  # noqa: E402
                                              trainable_from_jax)
from tunevlseg_torch.data.pipeline import DataLoader  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.models.clipseg.model import CLIPSegForSegmentation  # noqa: E402
from tunevlseg_torch.models.prompt.learners import CoOpLearner  # noqa: E402
from tunevlseg_torch.nn.layers import init_params  # noqa: E402
from tunevlseg_torch.training import optim as toptim  # noqa: E402
from tunevlseg_torch.training.denseclip_task import DenseCLIPTask  # noqa: E402
from tunevlseg_torch.training.denseclip_task import group_labels as _dc_labels  # noqa: E402
from tunevlseg_torch.training.loop import Trainer  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402
from tests.test_torch_denseclip import _built as _dc_built  # noqa: E402
from tests.test_torch_denseclip import _jcfg as _dc_jcfg  # noqa: E402
from tests.test_torch_denseclip import _train_batch as _dc_train_batch  # noqa: E402

KEY = jax.random.PRNGKey(0)
# f32 on the CPU in both packages, the same formulas, sums in another order:
# losses of order 1 agree to 1e-5, a gradient leaf to 1e-4 of its largest
# entry (tests/test_torch_train.py)
SCALAR_TOL = 1e-5
GRAD_REL_TOL = 1e-4
# Adam moves an entry by about lr * sign(g) an update: an entry whose
# gradient is well above the rounding noise (>= 1e-2 of its leaf's largest)
# agrees to 2% of the most it can travel, any entry to twice that travel
WEIGHT_REL_TOL = 0.02
ROBUST_GRAD = 1e-2
IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic_batch(seed, batch=8, img=32, seq=12, vocab=99):
    """JAX `tests/test_training.py::synthetic_batch`: normalised images, a
    blob target, dense prompts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab - 1, size=(batch, seq)).astype(np.int32)
    ids[:, 0], ids[:, -1] = 1, vocab - 1
    yy, xx = np.mgrid[:img, :img]
    blob = ((yy - img / 2) ** 2 + (xx - img / 2) ** 2 < (img / 3) ** 2)
    return {"image": rng.normal(size=(batch, 3, img, img)).astype(np.float32),
            "mask": np.repeat(blob[None, None], batch, 0).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones((batch, seq), np.int32),
            "valid": np.ones((batch,), np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _residual_clipseg(seed=0):
    """Tiny CLIPSeg CoOp with the "residual" additive head: the context
    vectors, the head and its ratio train."""
    cfg = tconfig.CLIPSegConfig.tiny()
    model = CLIPSegForSegmentation(cfg, learner=CoOpLearner(
        prompt_depth=2, num_context=4, context_dim=cfg.text.hidden_size),
        additive_mode="residual")
    init_params(model, torch.Generator().manual_seed(seed))
    return model, toptim.FreezeSpec(freeze_all=True, use_new_last_layer=True)


def _filled(shapes, seed):
    """A JAX parameter tree of `shapes` (`jax.eval_shape` of the model's
    `init`) drawn from a seeded numpy generator at an initialisation's scale:
    Flax's `init` of the tiny model takes ~25 s op by op on the CPU."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "kernel":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "residual_ratio":
            v = np.full(shape, 0.5)
        else:
            v = rng.normal(0.0, 0.02, shape)
        return jnp.asarray(v, jnp.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def jax_clipseg_pair(hp: dict, batch: dict, seed: int = 0):
    """Tiny CLIPSeg CoOp with the "residual" additive head, as JAX
    `tests/test_training.py` builds it for its accumulation and remat tests,
    in both packages on the same weights: (the JAX task, its state as
    `init` builds it, frozen, the port's task)."""
    jcfg = JConfig.tiny()
    jm = JCLIPSeg(jcfg, learner=JCoOp(prompt_depth=2, num_context=4,
                                      context_dim=jcfg.text.hidden_size),
                  additive_mode="residual")
    spec = JFreezeSpec(freeze_all=True, use_new_last_layer=True)
    jtask = JTask(jm, spec, **hp)
    shapes = jax.eval_shape(jm.init, KEY, batch["input_ids"], batch["image"],
                            batch["attention_mask"])
    params = _filled(shapes["params"], seed)
    trainable, frozen_params = partition_params(params, spec)
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable,
                         jtask.tx.init(trainable), jax.random.fold_in(KEY, 1), {})
    tm, tspec = _residual_clipseg(seed=1)
    tm.load_state_dict(state_dict_from_jax(params, tm))
    return jtask, jstate, {"params": frozen_params}, SegmentationTask(tm, tspec, **hp)


def _trainable(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def _update_grads(opt, model):
    """Record the (averaged, clipped) gradient each real update applies."""
    seen = []
    names = {id(p): n for n, p in model.named_parameters()}
    opt.optimizer.register_step_pre_hook(lambda o, a, k: seen.append(
        {names[id(p)]: p.grad.clone() for g in o.param_groups for p in g["params"]
         if p.grad is not None}))
    return seen


def _hold_weights(got: dict, want: dict, start: dict, grads: list, travel):
    """The strategy-parity rule; `travel(name)` is the most an entry of
    `name` can move (the updates' learning rates summed)."""
    n_robust = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert diff.max().item() <= 2 * travel(name), name
        gmin = torch.stack([g[name].abs() for g in grads]).amin(dim=0)
        gtop = max(g[name].abs().max().item() for g in grads)
        robust = (gmin >= ROBUST_GRAD * gtop) & (gmin > 1e-7)
        if robust.any():
            assert diff[robust].max().item() <= WEIGHT_REL_TOL * travel(name), name
        n_robust += int(robust.sum())
        assert not torch.equal(got[name], start[name]) or gtop == 0, name
    return n_robust


# --- the port alone -------------------------------------------------------------

def test_accumulation_matches_the_full_batch():
    full = _torch(_synthetic_batch(0, batch=16))
    micro = [{k: v[:8] for k, v in full.items()}, {k: v[8:] for k, v in full.items()}]
    results = []
    for k, batches in ((2, micro), (1, [full])):
        model, spec = _residual_clipseg()
        task = SegmentationTask(model, spec, learning_rate=1e-2,
                                accumulate_grad_batches=k)
        state = task.init()
        for batch in batches:
            state, _ = task.train_step(state, batch)
        assert state.step == len(batches)
        results.append((_trainable(model), state))
    (acc, acc_state), (one, _) = results
    assert acc.keys() == one.keys() and len(acc) >= 3
    for name in acc:
        torch.testing.assert_close(acc[name], one[name], atol=1e-6, rtol=1e-5)
    # the learning rate stays reachable through the accumulation (the
    # plateau scheduler reads and sets it)
    assert toptim.get_learning_rate(acc_state.optimizer) == pytest.approx(1e-2)
    toptim.set_learning_rate(acc_state.optimizer, 5e-3)
    assert toptim.get_learning_rate(acc_state.optimizer) == pytest.approx(5e-3)


class _TwoLayers(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Parameter(torch.randn(6, generator=gen))
        self.b = torch.nn.Parameter(torch.randn(6, generator=gen))

    def forward(self, x, use_b=True):
        y = (self.a * x).tanh()
        return (y * self.b).sum() if use_b else y.sum()


def test_partial_window_moves_nothing_and_missing_gradients_count_as_zero():
    xs = [torch.linspace(-1, 1, 6) * (i + 1) for i in range(3)]
    uses_b = (False, True, True)   # `b` has no gradient in micro-step 0
    net = _TwoLayers()
    start = _trainable(net)
    opt = toptim.make_optimizer(net, 1e-2, weight_decay=0.1, grad_clip_norm=0.5,
                                accumulate_steps=3)
    grads = []
    for i, (x, use_b) in enumerate(zip(xs, uses_b)):
        if i == 2:
            # set mid-window: the update at the window's end uses it
            toptim.set_learning_rate(opt, 3e-3)
        opt.zero_grad()
        net(x, use_b).backward()
        grads.append({n: (p.grad.clone() if p.grad is not None else None)
                      for n, p in net.named_parameters()})
        updated = opt.step()
        assert updated == (i == 2)
        if i < 2:
            # nothing moved: weights, moments, AdamW's step count
            assert all(torch.equal(p, start[n]) for n, p in net.named_parameters())
            assert opt.optimizer.state == {} and opt.mini_step == i + 1
            assert set(opt.accumulated) == ({0} if i == 0 else {0, 1})
    assert opt.mini_step == 0 and opt.accumulated == {}
    # the same update by hand: optax's running mean (a missing gradient is
    # a zero), then one clipped AdamW step at the learning rate set last
    ref_net = _TwoLayers()
    ref = toptim.make_optimizer(ref_net, 3e-3, weight_decay=0.1, grad_clip_norm=0.5)
    for name, p in ref_net.named_parameters():
        acc = torch.zeros_like(p)
        for n, g in enumerate(grads):
            acc = acc + ((g[name] if g[name] is not None else torch.zeros_like(p))
                         - acc) / (n + 1)
        p.grad = acc
    ref.step()
    for name, p in net.named_parameters():
        assert torch.equal(p, dict(ref_net.named_parameters())[name]), name
    assert all(int(s["step"]) == 1 for s in opt.optimizer.state.values())


def test_a_never_reached_parameter_keeps_no_gradient_and_no_state():
    net = _TwoLayers()
    opt = toptim.make_optimizer(net, 1e-2, accumulate_steps=2)
    for _ in range(2):
        opt.zero_grad()
        net(torch.ones(6), use_b=False).backward()
        opt.step()
    assert net.b.grad is None and net.b not in opt.optimizer.state
    assert torch.equal(net.b, _TwoLayers().b)


# --- against the JAX package ------------------------------------------------------

def test_accumulation_with_clip_matches_jax_multisteps():
    batches = [_synthetic_batch(s) for s in range(4)]
    hp = dict(learning_rate=1e-2, weight_decay=0.01, grad_clip_norm=0.05,
              accumulate_grad_batches=2)
    jtask, jstate, frozen, ttask = jax_clipseg_pair(hp, batches[0])
    tm = ttask.model
    tstate = ttask.init()
    update_grads = _update_grads(tstate.optimizer, tm)
    start = _trainable(tm)
    jstep = jax.jit(jtask.train_step)
    for i, batch in enumerate(batches):
        before = _trainable(tm)
        jbefore = jstate.trainable
        jstate, jm_ = jstep(jstate, frozen, batch)
        tstate, tm_ = ttask.train_step(tstate, _torch(batch))
        for key in ("loss", "dice", "iou"):
            np.testing.assert_allclose(tm_[key].item(), float(jm_[key]),
                                       atol=SCALAR_TOL, rtol=SCALAR_TOL, err_msg=key)
        if i % 2 == 0:
            # mid-window: nothing moved on either side; the running mean is
            # the JAX accumulator
            assert all(torch.equal(v, before[n]) for n, v in _trainable(tm).items())
            assert all(bool(jnp.array_equal(a, b)) for a, b in zip(
                jax.tree_util.tree_leaves(jbefore),
                jax.tree_util.tree_leaves(jstate.trainable)))
            want = trainable_from_jax(jstate.opt_state.acc_grads, tm)
            names = _names_of(tm, tstate.optimizer.params())
            got = {names[j]: g for j, g in tstate.optimizer.accumulated.items()}
            # residual_ratio's gradient, a sum over every pixel, cancels to
            # 3e-2 of the largest: its rounding noise is the largest leaf's
            overall = max(w.abs().max().item() for w in want.values())
            for name, g in got.items():
                top = want[name].abs().max().item()
                assert ((g - want[name]).abs().max().item()
                        <= GRAD_REL_TOL * (top + overall)), name
            # residual_ratio: read by the head, so every micro-step reaches it
            assert set(got) == set(want)
        else:
            assert int(jstate.opt_state.gradient_step) == (i + 1) // 2
    assert tstate.step == 4 and len(update_grads) == 2
    for g in update_grads:       # the clip acted on the averaged gradients
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in g.values()]))
        assert norm.item() <= 0.05 * (1 + 1e-5)
    n_robust = _hold_weights(_trainable(tm), trainable_from_jax(jstate.trainable, tm),
                             start, update_grads, lambda name: 2 * 1e-2 * 1.05)
    assert n_robust > 100


def test_denseclip_accumulation_matches_jax_schedule_by_update():
    """k = 2 over 4 micro-steps from the same weights (the port's, as a JAX
    tree) on 4 batches: warm-up 2 of 4 iterations, so that a schedule by
    micro-step would set another learning rate at the first update."""
    task_kw = dict(learning_rate=3e-3, weight_decay=1e-2, total_iters=4,
                   warmup_iters=2, image_stats=IMAGENET, accumulate_grad_batches=2)
    cfg, ids, tm, variables = _dc_built("rn", cfg_kw=dict(head_dropout=0.0),
                                        bn_train=True)
    batches = [_dc_train_batch(cfg, seed=8 + i) for i in range(4)]
    jt = jdc_task.DenseCLIPTask(
        jdc_model.DenseCLIP(_dc_jcfg(cfg), class_token_ids=ids, bn_train=True),
        **task_kw)
    params = variables["params"]
    trainable = {k: v for k, v in params.items() if k != "text_encoder"}
    frozen = {"params": {"text_encoder": params["text_encoder"]}}
    jstate = JTrainState(jnp.zeros((), jnp.int32), trainable, jt.tx.init(trainable),
                         jax.random.fold_in(KEY, 1),
                         {"batch_stats": variables["batch_stats"]})
    tt = DenseCLIPTask(tm, **task_kw)
    tstate = tt.init()
    start = _trainable(tm)
    update_grads = _update_grads(tstate.optimizer, tm)
    lrs = []
    tstate.optimizer.optimizer.register_step_pre_hook(lambda o, a, k: lrs.append(
        [(g["lr"], g["lr_mult"]) for g in o.param_groups]))
    jstep = jax.jit(lambda state, batch: jt.train_step(state, frozen, batch))
    for i, batch in enumerate(batches):
        before = _trainable(tm)
        jstate, jm_ = jstep(jstate, batch)
        tstate, tm_ = tt.train_step(tstate, _torch(batch))
        for key in ("loss", "loss_decode", "loss_aux_identity"):
            np.testing.assert_allclose(tm_[key].item(), float(jm_[key]),
                                       atol=SCALAR_TOL, rtol=SCALAR_TOL, err_msg=key)
        if i % 2 == 0:
            assert all(torch.equal(v, before[n]) for n, v in _trainable(tm).items())
            want = trainable_from_jax(jstate.opt_state.acc_grads, tm)
            names = _names_of(tm, tstate.optimizer.params())
            got = {names[j]: g for j, g in tstate.optimizer.accumulated.items()}
            assert set(got) == set(want)
            overall = max(w.abs().max().item() for w in want.values())
            for name, g in got.items():
                top = want[name].abs().max().item()
                assert ((g - want[name]).abs().max().item()
                        <= GRAD_REL_TOL * top + 1e-6 * overall), name
    # the learning rate of update u is schedule(u) x lr_mult (mmseg's
    # iteration counts updates), not that of the micro-step
    assert len(lrs) == 2
    for u, groups in enumerate(lrs):
        for lr, mult in groups:
            assert lr == tt.schedule(u) * mult
            # the JAX schedule in f32: 1.3% off the exact warm-up factor at
            # update 0 (tests/test_torch_denseclip.py, the schedule's test)
            assert lr == pytest.approx(float(jt.schedule(u)) * mult, rel=2e-2)
    assert tt.schedule(0) != pytest.approx(tt.schedule(1), rel=0.5)
    labels = {n: ("backbone" in g) for n, g in _dc_labels(tm).items()}
    total = sum(tt.schedule(u) for u in range(2)) * 1.05
    n_robust = _hold_weights(
        _trainable(tm), trainable_from_jax(jstate.trainable, tm), start,
        update_grads,
        lambda name: total * (tt.backbone_lr_mult if labels[name] else 1.0))
    assert n_robust > 1000
    want_stats = trainable_from_jax(jstate.model_state["batch_stats"], tm)
    assert set(tstate.model_state) == set(want_stats)
    for name, want in want_stats.items():
        top = want.abs().max().item()
        assert (tstate.model_state[name] - want).abs().max().item() <= 1e-4 * top, name


def _names_of(model, params):
    ids = {id(p): n for n, p in model.named_parameters()}
    return [ids[id(p)] for p in params]


# --- the loop and its checkpoints --------------------------------------------------

def _fit_task():
    model, spec = _residual_clipseg()
    return SegmentationTask(model, spec, learning_rate=1e-2, grad_clip_norm=1.0,
                            accumulate_grad_batches=2)


def test_fit_carries_a_partial_window_across_epochs_and_resumes_it(tmp_path):
    """3 batches an epoch at k = 2: the second window spans the epochs. A
    fit of 2 epochs equals the same micro-steps taken by hand; a fit of 1
    epoch ends mid-window, its checkpoint holds the running mean, and a
    resume to 2 epochs is bit-identical to the uninterrupted fit."""
    samples = _loop_samples(24)

    def loader():
        return DataLoader(_ListDataset(samples), 8, shuffle=True, seed=7,
                          num_workers=1, text_dedup=1)

    def fit(out, epochs, resume=None):
        task = _fit_task()
        state = task.init()
        tr = Trainer(task, out, max_epochs=epochs, log_image_num=0,
                     loggers=("jsonl",))
        state = tr.fit(state, loader(), resume_from=resume)
        return task, state

    task_a, state_a = fit(tmp_path / "a", 2)
    assert state_a.step == 6 and state_a.optimizer.mini_step == 0
    assert all(int(s["step"]) == 3 for s in state_a.optimizer.optimizer.state.values())

    by_hand = _fit_task()
    state = by_hand.init()
    train = loader()
    for epoch in range(2):
        train.set_epoch(epoch, 0)
        for batch in train:
            state, _ = by_hand.train_step(state, _dev(batch))
    for name, value in _trainable(by_hand.model).items():
        assert torch.equal(value, _trainable(task_a.model)[name]), name

    task_b, state_b = fit(tmp_path / "b", 1)
    assert state_b.step == 3 and state_b.optimizer.mini_step == 1
    saved = torch.load(tmp_path / "b" / "checkpoints" / "last" / "state.pt",
                       weights_only=True)["accumulation"]
    assert saved["mini_step"] == 1 and saved["accumulated"]
    task_c, state_c = fit(tmp_path / "b", 2, resume="last")
    assert state_c.step == 6 and state_c.optimizer.mini_step == 0
    for name, value in _trainable(task_a.model).items():
        assert torch.equal(value, _trainable(task_c.model)[name]), name
    moments_a = state_a.optimizer.optimizer.state_dict()["state"]
    moments_c = state_c.optimizer.optimizer.state_dict()["state"]
    assert moments_a.keys() == moments_c.keys()
    for i in moments_a:
        for key, value in moments_a[i].items():
            assert torch.equal(value, moments_c[i][key]), (i, key)


def test_resume_after_the_first_micro_step_is_bit_exact(tmp_path):
    """Save after micro-step 1 of 2 (`CheckpointManager`), restore into a
    fresh task and continue: the weights equal the uninterrupted run's."""
    from tunevlseg_torch.training.checkpoint import CheckpointManager

    batches = [_torch(_synthetic_batch(s)) for s in range(4)]
    straight = _fit_task()
    state = straight.init()
    for batch in batches:
        state, _ = straight.train_step(state, batch)

    first = _fit_task()
    state = first.init()
    state, _ = first.train_step(state, batches[0])
    mgr = CheckpointManager(tmp_path / "ck", first.model)
    mgr.save("last", state, {"epoch": 0})
    mgr.wait()
    resumed = _fit_task()
    state = CheckpointManager(tmp_path / "ck", resumed.model).restore(
        "last", resumed.init())
    assert state.step == 1 and state.optimizer.mini_step == 1
    for batch in batches[1:]:
        state, _ = resumed.train_step(state, batch)
    for name, value in _trainable(straight.model).items():
        assert torch.equal(value, _trainable(resumed.model)[name]), name


def _loop_samples(n, img=32, seq=12, pad=49407):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(seq,)).astype(np.int32)
    ids[0], ids[8], ids[9:] = 49406, 49407, pad
    return [{"image": rng.integers(0, 256, (3, img, img), dtype=np.uint8),
             "mask": (rng.random((1, img, img)) > 0.5).astype(np.float32),
             "input_ids": ids, "attention_mask": (ids != pad).astype(np.int32),
             "mask_name": f"{i}.png", "mask_shape": np.asarray([img, img]),
             "prompt": "p"} for i in range(n)]


class _ListDataset:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[int(i)]


def _dev(batch):
    from tunevlseg_torch.data.pipeline import device_batch
    return device_batch(batch, torch.device("cpu"))

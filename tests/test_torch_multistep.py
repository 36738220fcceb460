"""`compile_train_multistep`: k train steps as one program, against the JAX
package's `compile_train_multistep(mesh, k)` (one `lax.scan` executable).

On the CPU the port's program runs the k eager steps (`training/graphs.py`;
the captured CUDA graph is held against them on the card in
`tests/test_torch_multistep_gpu.py`). Here both packages start from the same
numpy weights and take two groups of steps over batches stacked on a
leading (k, B, ...) axis: tiny CLIPSeg CoOp over prompt-dedup batches, and
accumulation 2 at k = 3, whose second window crosses the group boundary,
against optax.MultiSteps inside the scan (CRIS e2e and DenseCLIP, each in
a file of its own: `tests/test_torch_multistep_{cris,denseclip}.py`). The
groups' mean metrics agree at SCALAR_TOL and the weights at the
strategy-parity rule of `tests/test_torch_train.py` (WEIGHT_REL_TOL of
Adam's travel where the gradient is well above rounding). Also the loop's use of the program, the
unread leaf, the optimizer's checkpoint format and the repairs made for the
capture (constants cached on their device)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.parallel import mesh as mesh_lib  # noqa: E402
from tunevlseg_torch.convert.from_jax import trainable_from_jax  # noqa: E402
from tunevlseg_torch.data import pipeline as tpipeline  # noqa: E402
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip import config as tconfig  # noqa: E402
from tunevlseg_torch.training import graphs  # noqa: E402
from tunevlseg_torch.training import optim as toptim  # noqa: E402
from tunevlseg_torch.training.loop import Trainer  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask  # noqa: E402
from tests.test_torch_accumulate import (SCALAR_TOL, _hold_weights,  # noqa: E402
                                         _names_of, _synthetic_batch, _trainable,
                                         _update_grads, jax_clipseg_pair)

# the running mean of a window against the JAX accumulator: a leaf within
# 1e-4 of its largest entry or of the largest entry of any leaf (the
# rounding noise of a leaf whose gradient cancels, tests/test_torch_accumulate.py)
GRAD_REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(batches: list) -> dict:
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _mesh():
    return mesh_lib.make_mesh(n_devices=1)


def _jax_groups(jtask, k: int, jstate, frozen, groups: list):
    """The JAX program's groups, each state kept (the program does not
    donate it)."""
    jtask.donate_state = False
    jmulti = jtask.compile_train_multistep(_mesh(), k)
    out = []
    for group in groups:
        jstate, metrics = jmulti(jstate, frozen, group)
        out.append((jstate, {k: float(v) for k, v in metrics.items()}))
    return out


def _port_groups(multi, state, groups: list):
    out = []
    for group in groups:
        state, metrics = multi(state, _torch(group))
        out.append((state, {k: v.item() for k, v in metrics.items()}))
    return out


def _metrics_agree(tgroups, jgroups, keys, tol=SCALAR_TOL):
    for (_, tm), (_, jm) in zip(tgroups, jgroups, strict=True):
        assert set(keys) <= set(tm) and set(tm) == set(jm)
        for key in keys:
            np.testing.assert_allclose(tm[key], jm[key], atol=tol, rtol=tol,
                                       err_msg=key)


def _dedup_batch(seed: int) -> dict:
    """8 samples of one prompt, collated with text_dedup=1 (uint8 images;
    the dedup keys `input_ids` (1, L) and `text_index`)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(12,)).astype(np.int32)
    ids[0], ids[8], ids[9:] = 49406, 49407, 49407
    samples = [{"image": rng.integers(0, 256, (3, 32, 32), dtype=np.uint8),
                "mask": (rng.random((1, 32, 32)) > 0.5).astype(np.float32),
                "input_ids": ids, "attention_mask": (ids != 49407).astype(np.int32),
                "prompt": "p"} for _ in range(8)]
    batch = tpipeline.device_batch(tpipeline.collate(samples, 8, text_dedup=1))
    assert batch["input_ids"].shape == (1, 12) and "text_index" in batch
    return batch


def test_clipseg_coop_dedup_multistep_matches_jax():
    """Two groups of k = 2 over stacked prompt-dedup batches (the JAX loop's
    fused-chunk path, `tests/test_text_dedup.py::test_dedup_multistep`)."""
    k, lr = 2, 1e-2
    hp = dict(learning_rate=lr, weight_decay=0.01, grad_clip_norm=0.5)
    jtask, jstate, frozen, ttask = jax_clipseg_pair(hp, _synthetic_batch(0))
    groups = [_stack([_dedup_batch(2 * g + i) for i in range(k)]) for g in range(2)]
    mesh = _mesh()
    jgroups = _jax_groups(jtask, k, jstate, frozen,
                          [{n: jax.device_put(v, s) for (n, v), s in zip(
                              g.items(), mesh_lib.batch_shardings(
                                  mesh, g, stacked=True).values())} for g in groups])
    tm = ttask.model
    tstate = ttask.init()
    start = _trainable(tm)
    grads = _update_grads(tstate.optimizer, tm)
    tgroups = _port_groups(ttask.compile_train_multistep(k), tstate, groups)
    _metrics_agree(tgroups, jgroups, ("loss", "dice", "iou"))
    assert tgroups[-1][0].step == 2 * k == int(jgroups[-1][0].step)
    n_robust = _hold_weights(_trainable(tm),
                             trainable_from_jax(jgroups[-1][0].trainable, tm),
                             start, grads, lambda name: 2 * k * lr * 1.05)
    assert len(grads) == 2 * k and n_robust > 100


def test_accumulation_across_the_group_boundary_matches_jax_multisteps():
    """`accumulate_grad_batches=2` at k = 3: the first group ends one
    micro-step into a window that the second group closes. After the first
    group the running mean is the JAX accumulator and the weights have taken
    one update; after the second, three."""
    k, lr = 3, 1e-2
    hp = dict(learning_rate=lr, weight_decay=0.01, grad_clip_norm=0.05,
              accumulate_grad_batches=2)
    batches = [_synthetic_batch(s) for s in range(2 * k)]
    jtask, jstate, frozen, ttask = jax_clipseg_pair(hp, batches[0])
    groups = [_stack(batches[:k]), _stack(batches[k:])]
    jgroups = _jax_groups(jtask, k, jstate, frozen, groups)
    tm = ttask.model
    start = _trainable(tm)
    tstate = ttask.init()
    grads = _update_grads(tstate.optimizer, tm)
    multi = ttask.compile_train_multistep(k)
    tgroups = []
    for group in groups:
        tstate, metrics = multi(tstate, _torch(group))
        tgroups.append((tstate, {key: v.item() for key, v in metrics.items()}))
        if len(tgroups) == 1:
            # mid-window at the boundary: one update so far, the running mean
            # of micro-step 2 held by both
            assert tstate.optimizer.mini_step == 1 and len(grads) == 1
            jfirst = jgroups[0][0]
            assert int(jfirst.opt_state.mini_step) == 1
            assert int(jfirst.opt_state.gradient_step) == 1
            want = trainable_from_jax(jfirst.opt_state.acc_grads, tm)
            names = _names_of(tm, tstate.optimizer.params())
            got = {names[j]: g for j, g in tstate.optimizer.accumulated.items()}
            assert set(got) == set(want)
            overall = max(w.abs().max().item() for w in want.values())
            for name, g in got.items():
                top = want[name].abs().max().item()
                assert ((g - want[name]).abs().max().item()
                        <= GRAD_REL_TOL * (top + overall)), name
    _metrics_agree(tgroups, jgroups, ("loss", "dice", "iou"))
    assert tstate.step == 2 * k and tstate.optimizer.mini_step == 0
    assert int(jgroups[-1][0].opt_state.gradient_step) == 3 and len(grads) == 3
    n_robust = _hold_weights(_trainable(tm),
                             trainable_from_jax(jgroups[-1][0].trainable, tm),
                             start, grads, lambda name: 3 * lr * 1.05)
    assert n_robust > 100


# --- the port alone --------------------------------------------------------------

def _tiny_coop(**kw):
    model, spec = tpresets.build_clipseg("coop", prompt_depth=2, num_context=4,
                                         config=tconfig.CLIPSegConfig.tiny(),
                                         device="cpu", seed=3)
    return SegmentationTask(model, spec, **kw)


def test_unread_leaf_stays_without_optimizer_state():
    """CoOp's `residual_ratio` trains, decays (weight_decay > 0) and is read
    by nothing: after a two-step program it keeps its value and no AdamW
    state; the context vectors move (tests/test_torch_train.py's rule)."""
    task = _tiny_coop(learning_rate=1e-2, weight_decay=0.1)
    model = task.model
    ratio, ctx = model.residual_ratio.detach().clone(), \
        model.learner.context_vectors.detach().clone()
    stacked = _torch(_stack([_dedup_batch(0), _dedup_batch(1)]))
    state, metrics = task.compile_train_multistep(2)(task.init(), stacked)
    assert state.step == 2 and set(metrics) == {"loss", "dice", "iou"}
    assert model.residual_ratio.requires_grad and model.residual_ratio.grad is None
    assert torch.equal(model.residual_ratio, ratio)
    assert not torch.equal(model.learner.context_vectors, ctx)
    assert list(state.optimizer.optimizer.state) == [model.learner.context_vectors]


def test_multistep_refuses_a_wrong_number_of_steps():
    task = _tiny_coop()
    stacked = _torch(_stack([_dedup_batch(0)] * 3))
    with pytest.raises(ValueError, match="leading axis"):
        task.compile_train_multistep(2)(task.init(), stacked)
    for bad in (0, 1.5, True):
        with pytest.raises(ValueError, match="whole number"):
            task.compile_train_multistep(bad)


def test_trainer_runs_full_groups_through_one_program(tmp_path, monkeypatch):
    """`Trainer(steps_per_execution=3)` over 7 batches an epoch builds the
    task's program once and runs the two full groups through it, each on
    batches stacked (3, B, ...); the last batch runs as a single step. Two
    epochs: four groups, two single steps, 14 steps."""
    task = _tiny_coop(learning_rate=1e-3)
    built, groups, singles, inside = [], [], [], [False]
    compile_multistep = task.compile_train_multistep
    single = task.train_step

    def spy_compile(k):
        built.append(k)
        multi = compile_multistep(k)

        def run(state, batches):
            groups.append({n: tuple(v.shape) for n, v in batches.items()})
            inside[0] = True
            try:
                return multi(state, batches)
            finally:
                inside[0] = False
        return run

    monkeypatch.setattr(task, "compile_train_multistep", spy_compile)

    def spy_single(state, batch, **kw):
        if not inside[0]:
            singles.append(state.step)
        return single(state, batch, **kw)

    samples = [_dedup_batch(i) for i in range(7)]
    rows = [{k: (v[j] if k not in ("input_ids", "attention_mask") else v[0])
             for k, v in b.items() if k != "text_index"} | {"prompt": "p",
                                                           "mask_name": "m.png",
                                                           "mask_shape": (32, 32)}
            for b in samples for j in range(8)]

    class Rows:
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[int(i)]

    loader = tpipeline.DataLoader(Rows(), 8, shuffle=False, seed=0, num_workers=1,
                                  text_dedup=1)
    tr = Trainer(task, tmp_path, max_epochs=2, steps_per_execution=3,
                 log_image_num=0, loggers=())
    monkeypatch.setattr(task, "train_step", spy_single)
    final = tr.fit(task.init(), loader)
    assert built == [3] and len(groups) == 4 and final.step == 14
    assert singles == [6, 13]
    assert groups[0]["image"] == (3, 8, 3, 32, 32)
    assert groups[0]["input_ids"] == (3, 1, 12) and groups[0]["text_index"] == (3, 8)


def test_optimizer_state_dict_keeps_float_rates_and_loads_in_place():
    """A capturable optimizer's learning rate is a tensor the graph reads:
    its state dict (what a checkpoint holds) carries the rate as a float,
    and loading one writes the saved rate into the same tensor."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.ClippedOptimizer(torch.optim.AdamW([p], lr=torch.tensor(1e-3)))
    rate = opt.param_groups[0]["lr"]
    saved = opt.state_dict()
    assert isinstance(saved["param_groups"][0]["lr"], float)
    toptim.set_learning_rate(opt, 5e-4)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(5e-4)
    opt.load_state_dict(saved)
    assert opt.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(1e-3)
    assert toptim.get_learning_rate(opt) == pytest.approx(1e-3)
    # a CPU optimizer keeps a float rate and is not capturable
    cpu = toptim.make_optimizer(torch.nn.Linear(2, 2), 1e-3)
    assert isinstance(cpu.param_groups[0]["lr"], float)
    assert not cpu.param_groups[0]["capturable"]


def test_step_constants_are_built_once_per_device():
    """What a train step used to copy from the host each time, which a CUDA
    graph's capture refuses, is cached on its device: the normalisation
    constants of uint8 images and the TransformerSegmentor's 1-d position
    encoding (the same tensor twice, the same values as before)."""
    from tunevlseg_torch.models.cris.layers import sincos_pos_1d
    from tunevlseg_torch.models.trans_segmentor.model import TransformerSegmentor
    from tunevlseg_torch.ops import image as image_ops

    x = torch.randint(0, 256, (2, 3, 8, 8), dtype=torch.uint8)
    stats = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    first = image_ops._stats_on(x.device, stats)
    assert image_ops._stats_on(x.device, stats)[0] is first[0]
    mean = torch.tensor(stats[0]).reshape(1, -1, 1, 1)
    std = torch.tensor(stats[1]).reshape(1, -1, 1, 1)
    assert torch.equal(image_ops.normalize_uint8(x, stats),
                       (x.float() / 255.0 - mean) / std)
    tokens = torch.zeros(2, 9, 16)
    pos = TransformerSegmentor._pos(tokens)
    assert TransformerSegmentor._pos(tokens) is pos
    assert torch.equal(pos, torch.from_numpy(sincos_pos_1d(16, 9))[None])


def test_eager_program_on_the_cpu_is_the_steps_one_by_one():
    """The CPU program is `graphs.eager_multistep`: its state and metrics
    equal k `train_step`s from the same weights, bit for bit."""
    results = []
    stacked = _torch(_stack([_dedup_batch(5), _dedup_batch(6)]))
    for program in (True, False):
        task = _tiny_coop(learning_rate=1e-2)
        state = task.init()
        if program:
            assert not isinstance(task.compile_train_multistep(2), graphs.CapturedSteps)
            state, metrics = task.compile_train_multistep(2)(state, stacked)
        else:
            per_step = []
            for i in range(2):
                state, m = task.train_step(state, {k: v[i] for k, v in stacked.items()})
                per_step.append(m)
            metrics = graphs.mean_metrics(per_step)
        results.append((_trainable(task.model), metrics))
    (wa, ma), (wb, mb) = results
    assert all(torch.equal(wa[n], wb[n]) for n in wb)
    assert all(torch.equal(ma[k], mb[k]) for k in mb)


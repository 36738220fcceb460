"""`compile_train_multistep` on the card: one captured CUDA graph of k train
steps against the k eager steps from the same weights, over two groups of
k = 3. Weights, AdamW's state, the BatchNorm statistics of the state, the
accumulation window and the groups' metrics are bit-identical wherever two
eager runs of the same steps are (where they are not, an atomic sum in a
backward, the captured run is within twice the widest gap between three
eager runs of the nearest one). The cases: the
narrow CLIPSeg CoOp in bf16 (K1, K2, K3; the unread `residual_ratio` keeps
its value and gets no AdamW state), the same with `accumulate_grad_batches=2`
(a window across the group boundary: one graph per phase), a narrow CRIS e2e
on the flat layout with decoder dropout 0.1 (K4, its dx and prologue, K4's
weight copy after each update, the statistics), the tiny TransformerSegmentor
with decoder dropout 0.1 (each step's masks from its own generator; also
under per-layer remat, whose recompute restores the generator inside the
capture) and tiny
DenseCLIP `bn_train` with the poly schedule (a learning rate a step). Also
the optimizer every step on the card now runs, AdamW with `capturable=True`
over a learning-rate tensor, against optax's formula, and the spans of a
captured group (`utils/profiling.py`): its steps' device spans against the
group's own begin and end events, read after the program is deleted. These
tests need the card and skip elsewhere; they import no JAX (the JAX parity
of the program: tests/test_torch_multistep.py). On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_multistep_gpu.py
"""
import pytest
import torch

from tunevlseg_torch.training import graphs

pytestmark = pytest.mark.gpu

K, GROUPS = 3, 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph and the kernels have no CPU mode")
    return torch.device("cuda")


def _coop(cuda, **task_kw):
    """The narrow CLIPSeg CoOp of tests/test_torch_gpu.py in bf16 at 256^2:
    257 vision tokens (K1, K2 in the decoder), text heads of 16 (K3)."""
    from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                    CLIPVisionConfig)
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.task import SegmentationTask
    cfg = CLIPSegConfig.tiny(
        text=CLIPTextConfig(vocab_size=49408, hidden_size=16, num_layers=4, num_heads=1,
                            intermediate_size=32, max_position_embeddings=77),
        vision=CLIPVisionConfig(hidden_size=64, num_layers=4, num_heads=2,
                                intermediate_size=128, patch_size=16, image_size=32),
        reduce_dim=32, decoder_num_heads=2)
    model, spec = build_clipseg("coop", prompt_depth=3, num_context=4, config=cfg,
                                dtype=torch.bfloat16, device=cuda)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (1, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 9:] = 49406, 49407
    batch = {"image": torch.randint(0, 256, (4, 3, 256, 256), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand(4, 1, 256, 256, generator=g) > 0.5).float(),
             "input_ids": ids, "attention_mask": (ids != 49407).int(),
             "text_index": torch.zeros(4, dtype=torch.int32),
             "valid": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    task = SegmentationTask(model, spec, learning_rate=1e-3, weight_decay=0.1,
                            **task_kw)
    return task, _shifted({k: v.to(cuda) for k, v in batch.items()})


def _shifted(batch: dict) -> list:
    """K * GROUPS batches: `batch` with its images rolled by a step each."""
    return [{k: (v.roll(i, dims=-1) if k == "image" else v) for k, v in batch.items()}
            for i in range(K * GROUPS)]


def _cris_flat_e2e(cuda):
    from tunevlseg_torch.models.cris.model import CRISConfig
    from tunevlseg_torch.models.presets import build_cris
    from tunevlseg_torch.training.task import SegmentationTask
    cfg = CRISConfig.tiny(img_size=480, embed_dim=32, transformer_width=32,
                          fpn_in=(128, 256, 32), vis_dim=32, fpn_out=(16, 32, 32),
                          dropout=0.1)
    model, spec = build_cris("e2e", config=cfg, dtype=torch.bfloat16, device=cuda,
                             layout="flat", freeze_encoder=False)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (2, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 9], ids[:, 10:] = 49406, 49407, 0
    batch = {"image": torch.randint(0, 256, (2, 3, 480, 480), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand(2, 1, 480, 480, generator=g) > 0.5).float(),
             "input_ids": ids, "attention_mask": (ids != 0).int()}
    task = SegmentationTask(model, spec, learning_rate=1e-4,
                            mutable_collections=("batch_stats",))
    return task, _shifted({k: v.to(cuda) for k, v in batch.items()})


def _trans_seg(cuda, **task_kw):
    """The tiny TransformerSegmentor in bf16 at head dims the kernels take
    (text 16, vision 32, decoder 16: K3 in the text tower and the decoder's
    cross-attention)."""
    from tunevlseg_torch.models.clip.config import CLIPTextConfig, CLIPVisionConfig
    from tunevlseg_torch.models.presets import build_trans_segmentor
    from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
    from tunevlseg_torch.training.task import SegmentationTask
    cfg = TransSegmentorConfig.tiny(
        text=CLIPTextConfig(vocab_size=49408, hidden_size=32, num_layers=2, num_heads=2,
                            intermediate_size=64),
        vision=CLIPVisionConfig(hidden_size=64, num_layers=2, num_heads=2,
                                intermediate_size=128, patch_size=16, image_size=32),
        projection_dim=32, decoder_dropout=0.1)
    model, spec = build_trans_segmentor(cfg, dtype=torch.bfloat16, device=cuda, seed=0)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(3, 999, (4, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 9:] = 49406, 49407
    batch = {"image": torch.randint(0, 256, (4, 3, 32, 32), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand(4, 1, 32, 32, generator=g) > 0.5).float(),
             "input_ids": ids, "attention_mask": (ids != 49407).int()}
    return (SegmentationTask(model, spec, learning_rate=1e-3, **task_kw),
            _shifted({k: v.to(cuda) for k, v in batch.items()}))


def _denseclip(cuda):
    from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig
    from tunevlseg_torch.models.presets import build_denseclip
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
    cfg = DenseCLIPConfig.tiny(head_dropout=0.1)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(1, cfg.vocab_size - 1, (cfg.num_classes, cfg.text_context_length),
                        generator=g, dtype=torch.int32)
    ids[:, -1] = cfg.vocab_size - 1
    model = build_denseclip(cfg, ids, bn_train=True, device=cuda, seed=0)
    labels = torch.randint(0, cfg.num_classes, (2, 64, 64), generator=g)
    labels[:, :4] = 255
    batch = {"image": torch.randint(0, 256, (2, 3, 64, 64), generator=g,
                                    dtype=torch.uint8), "label": labels}
    task = DenseCLIPTask(model, learning_rate=3e-3, total_iters=12, warmup_iters=3,
                         image_stats=((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)))
    return task, _shifted({k: v.to(cuda) for k, v in batch.items()})


def _run(task, batches: list, start: dict, captured: bool) -> tuple:
    params = dict(task.model.named_parameters())
    with torch.no_grad():
        for name, value in start.items():
            params[name].copy_(value)
    task.model.zero_grad(set_to_none=True)
    state = task.init()
    multi = (task.compile_train_multistep(K) if captured
             else graphs.eager_multistep(task, K))
    assert isinstance(multi, graphs.CapturedSteps) == captured
    metrics = []
    for g in range(GROUPS):
        group = {k: torch.stack([b[k] for b in batches[g * K:(g + 1) * K]])
                 for k in batches[0]}
        state, m = multi(state, group)
        metrics.append(m)
    torch.cuda.synchronize()
    names = {id(p): n for n, p in params.items()}
    opt = state.optimizer
    left = {
        "weights": {n: p.detach().clone() for n, p in params.items() if p.requires_grad},
        "moments": {f"{names[id(p)]}.{k}": v.clone()
                    for p, entries in opt.optimizer.state.items() for k, v in entries.items()},
        "statistics": {n: v.clone() for n, v in state.model_state.items()},
        "window": {str(i): v.clone() for i, v in opt.accumulated.items()},
        "metrics": {f"{g}.{k}": v.clone() for g, m in enumerate(metrics)
                    for k, v in m.items()}}
    return left, state, multi


def _gap(got: dict, want: dict) -> float:
    return max(((got[n].float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1e-30)).item() for n, w in want.items())


@pytest.mark.parametrize("case", ["coop", "coop_accumulate", "cris_flat_e2e",
                                  "trans_seg_dropout", "trans_seg_dropout_remat",
                                  "denseclip_poly"])
def test_captured_group_matches_the_eager_steps(cuda, case):
    task, batches = {
        "coop": lambda: _coop(cuda),
        "coop_accumulate": lambda: _coop(cuda, accumulate_grad_batches=2),
        "cris_flat_e2e": lambda: _cris_flat_e2e(cuda),
        "trans_seg_dropout": lambda: _trans_seg(cuda),
        "trans_seg_dropout_remat": lambda: _trans_seg(cuda, remat=True),
        "denseclip_poly": lambda: _denseclip(cuda)}[case]()
    start = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    runs = [_run(task, batches, start, captured=False)[0] for _ in range(2)]

    def same(a: dict, b: dict) -> bool:
        return all(torch.equal(a[n], w) for n, w in b.items())

    if not all(same(runs[1][kind], w) for kind, w in runs[0].items()):
        # a third eager run: the witness is the widest gap between two
        # eager runs, the captured run is held to the nearest one
        runs.append(_run(task, batches, start, captured=False)[0])
    captured, state, multi = _run(task, batches, start, captured=True)
    eager = runs[0]
    assert len(multi.graphs) == (2 if case == "coop_accumulate" else 1)
    assert state.step == K * GROUPS
    assert set(captured) == set(eager)
    for kind, want in eager.items():
        assert set(captured[kind]) == set(want), kind
        if not want:
            continue
        if same(runs[1][kind], want):
            for name, w in want.items():
                assert torch.equal(captured[kind][name], w), (kind, name)
        else:
            witness = max(_gap(runs[j][kind], runs[i][kind])
                          for i in range(len(runs)) for j in range(i + 1, len(runs)))
            nearest = min(_gap(captured[kind], r[kind]) for r in runs)
            assert nearest <= 2 * witness, kind
    if case == "coop":
        model = task.model
        assert torch.equal(model.residual_ratio, start["residual_ratio"])
        assert model.residual_ratio not in state.optimizer.optimizer.state
    if case == "coop_accumulate":
        assert state.optimizer.mini_step == 0 and eager["window"] == {}
    if case in ("cris_flat_e2e", "denseclip_poly"):
        assert captured["statistics"]


def test_captured_group_spans_time_the_group_on_the_card(cuda):
    """The device spans of a captured CoOp group (`utils/profiling.py`): the
    three spans of a step, times k, come within 2% of the group's device
    time from its begin and end events (the graph's tail: the metrics'
    mean and copy), with the card busy when the group's begin event is
    recorded, as in a loop whose host runs ahead. `snapshot()` still reads
    them once the program and its task are deleted; each replay but the
    first has a gap at or above 0, and the counters count the calls. The
    events leave the losses bit-identical to the eager steps'."""
    import gc

    from tunevlseg_torch.utils import profiling

    task, batches = _coop(cuda)
    start = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    eager = _run(task, batches, start, captured=False)[0]
    profiling.reset()
    captured, state, multi = _run(task, batches, start, captured=True)
    for key, want in eager["metrics"].items():
        assert torch.equal(captured["metrics"][key], want), key
    group = {k: torch.stack([b[k] for b in batches[:K]]) for k in batches[0]}
    torch.cuda._sleep(100_000_000)
    multi(state, group)
    calls = profiling.counter(graphs.REPLAYS)
    del multi, state, task
    gc.collect()
    torch.cuda.empty_cache()
    snap = profiling.snapshot()
    assert calls == GROUPS + 1 and snap["counters"][graphs.CAPTURES] == 1
    spans = snap["last_replay"]["spans"]
    assert snap["last_replay"]["group"] == GROUPS and not snap["last_replay"]["profiled"]
    assert snap["unprofiled"] == {"group": GROUPS, "spans": spans}
    assert {n: len(v) for n, v in spans.items()} == {
        "step.forward": K, "step.backward": K, "step.update": K}
    assert all(ms > 0 for v in spans.values() for ms in v)
    steps_ms = sum(sum(v) for v in spans.values())
    group_ms = [r["ms"] for r in snap["records"]
                if r["name"] == profiling.GROUP and r["group"] == GROUPS]
    assert len(group_ms) == 1
    assert abs(steps_ms - group_ms[0]) <= 0.02 * group_ms[0], (steps_ms, group_ms)
    gaps = [r for r in snap["records"] if r["name"] == profiling.GAP]
    assert sorted(r["group"] for r in gaps) == list(range(1, GROUPS + 1))
    assert all(r["ms"] >= 0 for r in gaps)
    launches = [r for r in snap["records"] if r["name"] == "captured.launch"]
    assert len(launches) == GROUPS + 1


def _optax_adamw(params: dict, grads: list, decays: set, kw: dict, lrs: list) -> dict:
    """optax's chain(clip_by_global_norm, adamw) in numpy f64, the formula
    tests/test_torch_optim.py holds the port's optimizer to on the CPU
    (there against optax itself): the clip max_norm / max(norm, max_norm),
    Adam's bias-corrected moments, decoupled decay on the `decays` leaves."""
    import numpy as np
    p = {n: v.astype(np.float64) for n, v in params.items()}
    m = {n: np.zeros_like(v) for n, v in p.items()}
    v2 = {n: np.zeros_like(v) for n, v in p.items()}
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        g = {n: x.astype(np.float64) for n, x in g.items()}
        clip = kw.get("grad_clip_norm")
        if clip is not None:
            norm = np.sqrt(sum((x ** 2).sum() for x in g.values()))
            g = {n: x * clip / max(norm, clip) for n, x in g.items()}
        for n in g:
            m[n] = 0.9 * m[n] + 0.1 * g[n]
            v2[n] = 0.999 * v2[n] + 0.001 * g[n] ** 2
            u = (m[n] / (1 - 0.9 ** t)) / (np.sqrt(v2[n] / (1 - 0.999 ** t)) + 1e-8)
            if n in decays:
                u = u + kw.get("weight_decay", 0.0) * p[n]
            p[n] = p[n] - lr * u
    return p


@pytest.mark.parametrize("kw", [
    dict(weight_decay=0.0),
    dict(weight_decay=0.05),
    dict(weight_decay=0.05, grad_clip_norm=1.0),     # norm ~ 14: clip active
    dict(weight_decay=0.05, grad_clip_norm=1e3),     # clip inactive
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_capturable_adamw_matches_the_optax_formula(cuda, kw):
    """The eager step's optimizer on the card is AdamW with `capturable=True`
    and the learning rate a device tensor (what a captured group reads):
    three steps on fixed gradients, the rate changed before the third,
    against optax's formula at tests/test_torch_optim.py's tolerance (1e-6,
    f32 elementwise arithmetic on values of order 1). A parameter without a
    gradient keeps its value and gets no state."""
    import numpy as np
    from torch import nn

    from tunevlseg_torch.nn.layers import Dense
    from tunevlseg_torch.training import optim as toptim

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = Dense(5, 3)
            self.context_vectors = nn.Parameter(torch.empty(2, 3))
            self.residual_ratio = nn.Parameter(torch.empty(()))   # nothing reads it

    rng = np.random.default_rng(0)
    net = Net().to(cuda)
    params = {n: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for n, p in net.named_parameters()}
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    read = [n for n in params if n != "residual_ratio"]
    grads = [{n: (3.0 * rng.normal(size=params[n].shape)).astype(np.float32)
              for n in read} for _ in range(3)]
    opt = toptim.make_optimizer(net, 1e-2, **kw)
    assert all(g["capturable"] and isinstance(g["lr"], torch.Tensor)
               and g["lr"].is_cuda for g in opt.param_groups)
    named = dict(net.named_parameters())
    for step, g in enumerate(grads):
        if step == 2:
            toptim.set_learning_rate(opt, 3e-3)
        opt.zero_grad()
        for n, x in g.items():
            named[n].grad = torch.from_numpy(x).to(cuda)
        opt.step()
    want = _optax_adamw(params, grads, {"fc.weight"}, kw, [1e-2, 1e-2, 3e-3])
    for n in read:
        np.testing.assert_allclose(named[n].detach().cpu().numpy(), want[n],
                                   atol=1e-6, rtol=1e-6, err_msg=n)
    assert named["residual_ratio"].item() == params["residual_ratio"].item()
    assert named["residual_ratio"] not in opt.optimizer.state

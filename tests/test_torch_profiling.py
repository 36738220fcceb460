"""The port's registry of spans and counters (`utils/profiling.py`) on the
CPU: host spans (totals, parents, the ring's bound), `record_function`
ranges only while a profiler records, the train step's three spans in an
eager step and in the CPU program of `compile_train_multistep`, the fold of
the replayed groups' events (on stand-in events: a CUDA event needs the
card), the kernels' launch counters as counters of the registry, the
Trainer's `fit.batch`, and `profile=true`'s `spans.json` beside its trace.
The device spans inside a captured graph are held on the card in
tests/test_torch_multistep_gpu.py."""
import json

import numpy as np
import pytest
import torch

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.presets import build_clipseg
from tunevlseg_torch.ops import (conv_flat, flash_attention, flash_attention_variants,
                                 layer_norm)
from tunevlseg_torch.training.task import SegmentationTask
from tunevlseg_torch.utils import profiling

STEP_SPANS = ["step.forward", "step.backward", "step.update"]


@pytest.fixture(autouse=True)
def fresh_registry():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _coop_batch(b: int = 2, img: int = 32, seq: int = 12) -> dict:
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (1, seq), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 8], ids[:, 9:] = 49406, 49407, 49407
    return {"image": torch.randint(0, 256, (b, 3, img, img), generator=g,
                                   dtype=torch.uint8),
            "mask": (torch.rand(b, 1, img, img, generator=g) > 0.5).float(),
            "input_ids": ids, "attention_mask": (ids != 49407).int(),
            "text_index": torch.zeros(b, dtype=torch.int32)}


def _coop_task() -> SegmentationTask:
    model, spec = build_clipseg("coop", prompt_depth=2, num_context=4,
                                config=CLIPSegConfig.tiny(), device="cpu")
    return SegmentationTask(model, spec, learning_rate=1e-2)


def _names(snap: dict) -> list:
    return [r["name"] for r in sorted(snap["records"], key=lambda r: r["start_ns"])]


def test_span_totals_parents_and_the_rings_bound():
    profiling.reset(capacity=4)
    for _ in range(3):
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            with profiling.span("inner"):
                pass
    snap = profiling.snapshot()
    assert snap["spans"]["outer"]["count"] == 3
    assert snap["spans"]["inner"]["count"] == 6
    assert snap["spans"]["outer"]["total_ms"] >= snap["spans"]["inner"]["total_ms"] / 2
    # nine records made, the ring keeps the last four: the last group's
    # two inner spans, its outer span, and what came before them
    records = snap["records"]
    assert len(records) == 4
    by_id = {r["id"]: r for r in records}
    last_outer = max((r for r in records if r["name"] == "outer"), key=lambda r: r["id"])
    children = [r for r in records if r["parent"] == last_outer["id"]]
    assert [c["name"] for c in children] == ["inner", "inner"]
    assert all(last_outer["start_ns"] <= c["start_ns"] <= c["end_ns"] <= last_outer["end_ns"]
               for c in children)
    assert last_outer["parent"] is None and last_outer["id"] in by_id
    assert all(r["ms"] >= 0 and r["group"] == -1 for r in records)


def test_a_span_closes_when_its_body_raises():
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("inner"):
                raise ValueError("body")
    with profiling.span("after"):
        pass
    snap = profiling.snapshot()
    assert {n: s["count"] for n, s in snap["spans"].items()} == {
        "outer": 1, "inner": 1, "after": 1}
    after = next(r for r in snap["records"] if r["name"] == "after")
    assert after["parent"] is None


def test_record_function_only_while_a_profiler_records(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args, **kw):
        opened.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profiling.span("span.before"):
        torch.ones(4).add_(1)
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("span.inside"):
            torch.ones(4).add_(1)
    with profiling.span("span.after"):
        torch.ones(4).add_(1)
    assert opened == ["span.inside"]
    names = {e.name for e in prof.events()}
    assert "span.inside" in names
    assert not {"span.before", "span.after"} & names
    # the host totals count all three, profiled or not
    assert {n: s["count"] for n, s in profiling.snapshot()["spans"].items()} == {
        "span.before": 1, "span.inside": 1, "span.after": 1}


def test_eager_train_step_opens_forward_backward_update_once_each():
    task = _coop_task()
    state = task.init()
    profiling.reset()
    task.train_step(state, _coop_batch())
    snap = profiling.snapshot()
    assert _names(snap) == STEP_SPANS
    assert {n: s["count"] for n, s in snap["spans"].items()} == dict.fromkeys(STEP_SPANS, 1)
    records = sorted(snap["records"], key=lambda r: r["start_ns"])
    # one after another, none inside another
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(records, records[1:]))
    assert all(r["parent"] is None for r in records)
    assert snap["last_replay"] == {}


def test_cpu_program_of_compile_train_multistep_counts_its_steps_spans():
    task = _coop_task()
    state = task.init()
    k = 3
    multi = task.compile_train_multistep(k)
    batch = _coop_batch()
    stacked = {n: torch.stack([v] * k) for n, v in batch.items()}
    profiling.reset()
    state, _ = multi(state, stacked)
    snap = profiling.snapshot()
    assert state.step == k
    assert {n: s["count"] for n, s in snap["spans"].items()} == dict.fromkeys(STEP_SPANS, k)
    assert _names(snap) == STEP_SPANS * k
    # the eager steps replay no graph
    assert profiling.counter("captured.replays") == 0 and snap["last_replay"] == {}


@pytest.mark.parametrize("module,counters,readers", [
    (flash_attention, (flash_attention.K1, flash_attention.K2, flash_attention.K3),
     (flash_attention.launch_count, flash_attention.bwd_launch_count,
      flash_attention.bias_launch_count)),
    (conv_flat, (conv_flat.K4, conv_flat.K4_DX, conv_flat.K4_DY),
     (conv_flat.launch_count, conv_flat.dx_launch_count, conv_flat.dy_launch_count)),
    (layer_norm, (layer_norm.N1, layer_norm.N1_BWD, layer_norm.N1_PLAIN),
     (layer_norm.launch_count, layer_norm.bwd_launch_count, layer_norm.plain_count)),
    (flash_attention_variants, tuple(flash_attention_variants.COUNTERS.values()),
     tuple(lambda kernel=kernel: flash_attention_variants.launch_count(kernel)
           for kernel in flash_attention_variants.COUNTERS)),
], ids=["k1_k2_k3", "k4", "n1", "variants"])
def test_launch_count_functions_read_and_reset_the_registrys_counters(
        module, counters, readers):
    profiling.count("other.counter", 5)
    for i, name in enumerate(counters):
        profiling.count(name, i + 2)
    assert [read() for read in readers] == [i + 2 for i in range(len(counters))]
    assert {n: profiling.snapshot()["counters"][n] for n in counters} == {
        n: i + 2 for i, n in enumerate(counters)}
    module.reset_launch_count()
    assert [read() for read in readers] == [0] * len(counters)
    # a module's reset leaves every other counter as it was
    assert profiling.counter("other.counter") == 5
    profiling.count(counters[0])
    profiling.reset()
    assert readers[0]() == 0


class _Event:
    """A stand-in for a timing event: `at` is its device time in ms once
    the test marks it done."""

    def __init__(self):
        self.at = None
        self.recorded = 0

    def record(self):
        self.recorded += 1
        self.at = None

    def query(self):
        return self.at is not None

    def elapsed_time(self, other):
        assert self.query() and other.query(), "read before completion"
        return other.at - self.at


def test_group_events_fold_once_complete_and_never_wait(monkeypatch):
    reg = profiling.Registry()
    made = []

    def new_event():
        if reg.free:
            return reg.free.pop()
        made.append(_Event())
        return made[-1]

    monkeypatch.setattr(reg, "_event", new_event)
    spans = profiling.DeviceSpans()
    times = [(0.0, 10.0), (12.5, 20.0), (20.5, 31.0)]    # begin, end of each group
    for i in range(len(times)):
        reg.set_group(i)
        reg.group_begin(i)
        reg.replayed(spans, i)
        reg.group_end()
        # nothing has completed: nothing is folded and nothing waits
        assert not [r for r in reg.ring if r[1] in (profiling.GAP, profiling.GROUP)]
    assert len(reg.open) == 3
    begin0, end0 = made[0], made[1]
    begin0.at, end0.at = times[0]
    reg.poll()
    assert [(r[1], r[6], r[5]) for r in reg.ring] == [(profiling.GROUP, 10.0, 0)]
    # group 1's begin completed, its end not: its gap folds alone
    made[2].at = times[1][0]
    reg.poll()
    assert [(r[1], r[6], r[5]) for r in reg.ring][1:] == [(profiling.GAP, 2.5, 1)]
    made[3].at = times[1][1]
    made[4].at, made[5].at = times[2]
    reg.poll()
    got = [(r[1], r[6], r[5]) for r in reg.ring]
    assert got == [(profiling.GROUP, 10.0, 0), (profiling.GAP, 2.5, 1),
                   (profiling.GROUP, 7.5, 1), (profiling.GAP, 0.5, 2),
                   (profiling.GROUP, 10.5, 2)]
    assert not reg.open and reg.last_replay is spans and reg.last_group == 2
    # folded events are reused: a fourth group makes no new event
    n = len(made)
    reg.group_begin(3)
    reg.group_end()
    assert len(made) == n


def test_a_group_that_never_ended_is_dropped_and_no_gap_spans_it(monkeypatch):
    reg = profiling.Registry()
    monkeypatch.setattr(reg, "_event", _Event)
    reg.group_begin(0)
    reg.group_end()
    first = reg.open[0]
    reg.group_begin(1)          # its replay raised: no group_end
    reg.group_begin(2)
    reg.group_end()
    assert [e[0] for e in reg.open] == [0, 2]
    assert reg.open[1][1] is None          # no previous end: no gap
    first[2].at, first[3].at = 0.0, 4.0
    reg.open[1][2].at, reg.open[1][3].at = 9.0, 11.0
    reg.poll()
    assert [(r[1], r[6]) for r in reg.ring] == [(profiling.GROUP, 4.0),
                                                (profiling.GROUP, 2.0)]


def test_an_unprofiled_groups_spans_are_read_before_its_graph_runs_again(monkeypatch):
    reg = profiling.Registry()
    monkeypatch.setattr(reg, "_event", _Event)
    begin, end = _Event(), _Event()
    spans = profiling.DeviceSpans([("step.forward", begin, end)])
    begin.at, end.at = 0.0, 3.0
    reg.group_begin(0)
    reg.replayed(spans, 0)
    reg.group_end()
    reg.group_begin(1)               # group 0 not complete: nothing read, no wait
    assert reg.unprofiled == {}
    reg.open.clear()
    reg.last_end = _Event()
    reg.last_end.at = 3.5            # group 0 complete before group 1's launch
    reg.group_begin(1)
    assert reg.unprofiled == {"group": 0, "spans": {"step.forward": [3.0]}}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        reg.replayed(spans, 1)
    reg.group_end()
    begin.at, end.at = 10.0, 14.0    # the graph's events, recorded anew by group 1
    reg.last_begin.at, reg.last_end.at = 9.5, 15.0
    snap = reg.snapshot()
    assert snap["last_replay"] == {"group": 1, "spans": {"step.forward": [4.0]},
                                   "profiled": True, "start_ms": 0.5}
    # a profiled group is never kept as the unprofiled one
    reg._read_last()
    assert snap["unprofiled"] == reg.unprofiled == {"group": 0,
                                                    "spans": {"step.forward": [3.0]}}


def test_device_spans_resolve_in_order():
    spans = profiling.DeviceSpans()
    at = 0.0
    for step in range(2):
        for name, ms in zip(STEP_SPANS, (3.0, 5.0, 1.0)):
            begin, end = _Event(), _Event()
            begin.at, end.at = at, at + ms
            at += ms
            spans.pairs.append((name, begin, end))
    assert spans.resolve() == {"step.forward": [3.0, 3.0], "step.backward": [5.0, 5.0],
                               "step.update": [1.0, 1.0]}


def test_fit_opens_fit_batch_for_each_wait_on_the_loader(tmp_path):
    from tunevlseg_torch.data.pipeline import DataLoader
    from tunevlseg_torch.training.loop import Trainer

    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(12,)).astype(np.int32)
    ids[0], ids[8], ids[9:] = 49406, 49407, 49407
    samples = [{"image": rng.integers(0, 256, (3, 32, 32), dtype=np.uint8),
                "mask": (rng.random((1, 32, 32)) > 0.5).astype(np.float32),
                "input_ids": ids, "attention_mask": (ids != 49407).astype(np.int32),
                "mask_name": f"{i}.png", "mask_shape": np.asarray([40, 36]),
                "prompt": "p"} for i in range(6)]
    task = _coop_task()
    state = task.init()
    tr = Trainer(task, tmp_path, max_epochs=1, log_image_num=0, steps_per_execution=2)
    profiling.reset()
    state = tr.fit(state, DataLoader(samples, 2, num_workers=1, text_dedup=1))
    snap = profiling.snapshot()
    assert state.step == 3
    # three batches and the loader's end; a group of two and a straggler
    assert snap["spans"]["fit.batch"]["count"] == 4
    assert snap["spans"]["step.forward"]["count"] == 3


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Eight 40 x 40 images with square masks and a BPE merges file (the
    folder of tests/test_torch_cli.py)."""
    cv2 = pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("profile")
    root = tmp / "data" / "kvasir_polyp"
    for sub in ("images", "masks", "anns"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    anns = []
    for i in range(8):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
        mask = np.zeros((40, 40), np.uint8)
        mask[8:30, 8:30] = 255
        cv2.imwrite(str(root / "masks" / f"{i}.png"), mask)
        anns.append({"img_name": f"{i}.png", "mask_name": f"{i}.png",
                     "prompts": {"p0": "polyp"}})
    for split in ("train", "val", "test"):
        (root / "anns" / f"{split}.json").write_text(json.dumps(anns))
    merges = tmp / "merges.txt"
    merges.write_text("#version: 0.2\n" + "\n".join(
        ["p o", "l y", "po ly", "polyp </w>", "a </w>", "t h", "th e</w>"]) + "\n")
    return {"data_root": tmp / "data", "vocab": merges}


def test_profile_true_writes_the_spans_beside_the_trace(image_folder, tmp_path):
    pytest.importorskip("yaml")
    pytest.importorskip("regex")
    from tunevlseg_torch import train as train_mod
    out = tmp_path / "logs"
    train_mod.main(["ds_name=kvasir_polyp", f"paths.data_root={image_folder['data_root']}",
                    f"paths.log_dir={out}", f"vocab_path={image_folder['vocab']}",
                    "img_size=32", "+tiny_model=true", "data.batch_size=4",
                    "data.num_workers=2", "trainer=debug", "+trainer.device=cpu",
                    "debug=profiler", "trainer.max_epochs=1", "test=false",
                    "exp_name=profiled"])
    profile = out / "train" / "profiled" / "profile"
    trace = json.loads((profile / "trace.json").read_text())
    spans = json.loads((profile / "spans.json").read_text())
    traced = {e.get("name") for e in trace["traceEvents"]}
    for name in ["fit.batch", *STEP_SPANS]:
        assert name in traced, name
        assert spans["spans"][name]["count"] >= 1, name
    assert spans["spans"]["fit.batch"]["count"] == spans["spans"]["step.forward"]["count"] + 1
    assert {r["name"] for r in spans["records"]} >= {"fit.batch", *STEP_SPANS}

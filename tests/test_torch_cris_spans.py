"""The spans of CRIS's stages (`models/cris/model.py`: `cris.visual`,
`cris.text`, `cris.neck`, `cris.decoder`, `cris.head`) in the port's
registry (`utils/profiling.py`): each recorded once a forward, on the
host, in the order of the stages; in a train step inside its
`step.forward`; and, on the card, five pairs of events a step in a captured
group, resolved at every replay. The CPU cases run the tiny CRIS CoOp; the
`gpu` case needs the card and skips elsewhere:

    python -m pytest --noconftest -m gpu tests/test_torch_cris_spans.py
"""
import pytest
import torch

from tunevlseg_torch.models.cris.model import CRISConfig
from tunevlseg_torch.models.presets import build_cris
from tunevlseg_torch.training.task import SegmentationTask
from tunevlseg_torch.utils import profiling

STAGES = ["cris.visual", "cris.text", "cris.neck", "cris.decoder", "cris.head"]


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def _batch(b: int, img: int, device="cpu") -> dict:
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 999, (1, 77), generator=g, dtype=torch.int32)
    ids[:, 0], ids[:, 8], ids[:, 9:] = 49406, 49407, 49407
    batch = {"image": torch.randint(0, 256, (b, 3, img, img), generator=g,
                                    dtype=torch.uint8),
             "mask": (torch.rand(b, 1, img, img, generator=g) > 0.5).float(),
             "input_ids": ids, "attention_mask": (torch.arange(77) < 9).int()[None],
             "text_index": torch.zeros(b, dtype=torch.int32)}
    return {k: v.to(device) for k, v in batch.items()}


def _task(config: CRISConfig, device="cpu", dtype=torch.float32) -> SegmentationTask:
    model, spec = build_cris("coop", config=config, dtype=dtype, device=device)
    return SegmentationTask(model, spec)


def _records(name: str) -> list:
    return [r for r in profiling.snapshot()["records"] if r["name"] == name]


def test_each_stage_once_a_forward_in_order():
    task = _task(CRISConfig.tiny())
    batch = _batch(2, 64)
    args, kwargs = task.model_inputs(batch)
    with torch.no_grad():
        for _ in range(2):
            task.model(*args, **kwargs)
    spans = profiling.snapshot()["spans"]
    assert {n: spans[n]["count"] for n in STAGES} == {n: 2 for n in STAGES}
    firsts = [_records(n)[0] for n in STAGES]
    assert [r["id"] for r in firsts] == sorted(r["id"] for r in firsts)
    for earlier, later in zip(firsts, firsts[1:]):
        assert earlier["end_ns"] <= later["start_ns"]


def test_stages_inside_the_train_steps_forward():
    task = _task(CRISConfig.tiny(dropout=0.2))
    state = task.init()
    for _ in range(2):
        state, _ = task.train_step(state, _batch(2, 64))
    forwards = {r["id"] for r in _records("step.forward")}
    assert len(forwards) == 2
    for name in STAGES:
        records = _records(name)
        assert len(records) == 2
        assert all(r["parent"] in forwards for r in records), name


@pytest.mark.gpu
def test_captured_cris_step_resolves_every_stage():
    """Two replays of a captured group of two CRIS CoOp steps in bf16 at
    480^2 (900 decoder tokens: K1, K2; K3 in the text and the cross
    attention): each stage's span resolves to one positive device time a
    step, and the five lie inside the step's `step.forward`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph and the kernels have no CPU mode")
    cuda = torch.device("cuda")
    cfg = CRISConfig.tiny(img_size=480, embed_dim=32, transformer_width=32,
                          fpn_in=(128, 256, 32), vis_dim=32, fpn_out=(16, 32, 32),
                          dropout=0.2)
    task = _task(cfg, cuda, torch.bfloat16)
    state = task.init()
    multi = task.compile_train_multistep(2)
    batch = _batch(2, 480, cuda)
    stacked = {k: torch.stack([v, v]) for k, v in batch.items()}
    for _ in range(2):
        state, _ = multi(state, stacked)
    spans = profiling.snapshot()["last_replay"]["spans"]
    assert {n: len(spans[n]) for n in STAGES} == {n: 2 for n in STAGES}
    assert all(ms > 0 for n in STAGES for ms in spans[n])
    for i in range(2):
        assert sum(spans[n][i] for n in STAGES) <= spans["step.forward"][i]

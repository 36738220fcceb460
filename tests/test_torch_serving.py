"""The port's serving export (`tunevlseg_torch/serving.py`, `torch.export`)
against the JAX package's (`tunevlseg_tpu/serving.py`, `jax.export`) on the
CPU, at tiny sizes.

The same numpy weights go through the JAX `export_task_predict` + `load_fn`
and through the port's, for CLIPSeg CoOp and the TransformerSegmentor: the
probabilities agree within `LOGIT_TOL`, and the port's loaded program equals
its eager `task_predict_fn` bit for bit. The export reads no weight values;
the programs are smaller than the weights; a program loads and runs in a
process that never imports `tunevlseg_torch.models`; and an export, an eager
call and another export run in one process in any order (the resize
matrices' cache once kept a fake tensor from a trace). The artifact carries
no weights, so `Trainer.test` restoring the best weights into the model in
place (ROADMAP, Queue 3) cannot change what an export holds: the CLIs export
the names and shapes, and the caller passes the weights it serves.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")

from tunevlseg_tpu import serving as jserving  # noqa: E402
from tunevlseg_torch import serving  # noqa: E402
from tunevlseg_torch.ops import image as image_ops  # noqa: E402

from tests.test_torch_clipseg import LOGIT_TOL  # noqa: E402
from tests.test_torch_clipseg import _batch as clipseg_batch  # noqa: E402
from tests.test_torch_clipseg import _pair as clipseg_pair  # noqa: E402
from tests.test_torch_trans_segmentor import _batch as ts_batch  # noqa: E402
from tests.test_torch_trans_segmentor import _pair as ts_pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: the tiny models run many small ops, whose
    OpenMP teams otherwise wait on descheduled threads beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clipseg():
    jtask, state, frozen, _, ttask, batch = clipseg_pair("coop")
    return jtask, state, frozen, ttask, batch


def _trans_seg():
    batch = ts_batch()
    jtask, state, frozen, _, ttask = ts_pair({}, batch)
    return jtask, state, frozen, ttask, batch


PAIRS = {"clipseg_coop": _clipseg, "trans_seg": _trans_seg}


def _port_clipseg():
    """The port's tiny CLIPSeg CoOp task alone (seeded weights, no JAX
    `init`) and the CLIPSeg parity batch."""
    from tunevlseg_torch.models.clip.config import CLIPSegConfig
    from tunevlseg_torch.models.presets import build_clipseg
    from tunevlseg_torch.training.task import SegmentationTask
    model, spec = build_clipseg("coop", prompt_depth=3, num_context=4,
                                config=CLIPSegConfig.tiny(), device="cpu")
    return SegmentationTask(model, spec), clipseg_batch()


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    return PAIRS[request.param]()


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _weight_bytes(params) -> int:
    return sum(v.numel() * v.element_size() for v in params.values())


def test_exported_predict_matches_jax_export(pair, tmp_path):
    """Both packages export and load their predict step; the loaded
    programs agree within LOGIT_TOL, and the port's equals its eager
    `task_predict_fn` bit for bit."""
    jtask, state, frozen, ttask, batch = pair
    jserving.export_task_predict(jtask, state, frozen, batch, tmp_path / "jax")
    jpredict = jserving.load_fn(tmp_path / "jax")
    want = np.asarray(jpredict(state.trainable, frozen, state.model_state, batch))

    params = dict(ttask.model.state_dict())
    tbatch = _torch(batch)
    path = serving.export_task_predict(ttask, params, tbatch, tmp_path / "port",
                                       platforms=("cpu",))
    assert path == tmp_path / "port" / "predict.cpu.pt2" and path.exists()
    predict = serving.load_fn(tmp_path / "port", device="cpu")
    got = predict(params, tbatch)
    assert got.shape == tbatch["mask"].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    torch.testing.assert_close(got, serving.task_predict_fn(ttask)(params, tbatch),
                               rtol=0, atol=0)


def test_meta_describes_the_programs(pair, tmp_path):
    """meta.json: the torch version, the platforms, the in specs (every
    weight by name, then the batch entries the model reads), the out spec,
    the kind and model, and no `tunevlseg::` op in a CPU program; the
    program is smaller than the f32 weights it serves."""
    _, _, _, ttask, batch = pair
    params = dict(ttask.model.state_dict())
    tbatch = _torch(batch)
    serving.export_task_predict(ttask, params, tbatch, tmp_path, platforms=("cpu",))
    meta = serving.read_meta(tmp_path)
    assert meta["torch_version"] == torch.__version__
    assert meta["platforms"] == ["cpu"]
    assert meta["kind"] == "segmentation_task_predict"
    assert meta["model"] == type(ttask.model).__name__
    names = [s["name"] for s in meta["in_specs"]]
    assert names[:len(params)] == [f"0.{k}" for k in params]
    assert names[len(params):] == [f"1.{k}" for k in serving.BATCH_KEYS
                                   if k in tbatch]
    assert meta["out_specs"] == [{"name": "0", "shape": list(tbatch["mask"].shape),
                                  "dtype": "float32"}]
    assert meta["tunevlseg_ops"] == {"cpu": []}
    assert meta["graph_bytes"] == (tmp_path / "predict.cpu.pt2").stat().st_size
    # the program stores the graph, not the weights
    assert meta["graph_bytes"] < _weight_bytes(params)


def test_export_is_weight_free(pair, tmp_path):
    """Export from tensors on the meta device, which hold no values: the
    program then serves the real weights, equal to the eager call."""
    _, _, _, ttask, batch = pair
    params = dict(ttask.model.state_dict())
    tbatch = _torch(batch)
    abstract = ({k: torch.empty_like(v, device="meta") for k, v in params.items()},
                {k: torch.empty_like(v, device="meta") for k, v in tbatch.items()})
    serving.export_task_predict(ttask, abstract[0], abstract[1], tmp_path,
                                platforms=("cpu",), name="abstract")
    predict = serving.load_fn(tmp_path, name="abstract", device="cpu")
    torch.testing.assert_close(predict(params, tbatch),
                               serving.task_predict_fn(ttask)(params, tbatch),
                               rtol=0, atol=0)


def test_multi_program_artifact_round_trip(tmp_path):
    """`platforms=("cpu",)` as a tuple, a second program under another name
    beside the first, and the platform rules: a platform that was not
    exported raises at load, an unknown one at export."""
    ttask, batch = _port_clipseg()
    params = dict(ttask.model.state_dict())
    tbatch = _torch(batch)
    small = {k: v[:2] for k, v in tbatch.items() if k != "input_ids"}
    small["input_ids"] = tbatch["input_ids"]
    serving.export_task_predict(ttask, params, tbatch, tmp_path, platforms=("cpu",))
    serving.export_task_predict(ttask, params, small, tmp_path, platforms=("cpu",),
                                name="b2")
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert meta["name"] == "b2" and meta["platforms"] == ["cpu"]
    eager = serving.task_predict_fn(ttask)
    for name, b in (("predict", tbatch), ("b2", small)):
        got = serving.load_fn(tmp_path, name=name, device=torch.device("cpu"))(params, b)
        torch.testing.assert_close(got, eager(params, b), rtol=0, atol=0)
        assert got.shape[0] == b["image"].shape[0]
    with pytest.raises(ValueError, match="not for 'cuda'"):
        serving.load_fn(tmp_path, device="cuda")
    with pytest.raises(ValueError, match="platforms"):
        serving.export_task_predict(ttask, params, tbatch, tmp_path / "x",
                                    platforms=("tpu", "cpu"))


@pytest.mark.parametrize("order", ["export_eager_export", "eager_export_eager"])
@pytest.mark.parametrize("family", ["clipseg", "cris"])
def test_exports_and_eager_calls_in_any_order(order, family, tmp_path,
                                              monkeypatch):
    """On cold caches (CLIPSeg: a 48^2 image into the tiny model's 64^2 grid
    and back, resize matrices no call has built; CRIS: its position
    encodings too), an export first, then an eager call, then another
    export, and the other way round: every call runs, every cached tensor
    handed out is a real one, and the programs equal the eager call. (The
    caches once kept the fake tensors of the first trace: the eager call
    after it failed, and so did the next export.)"""
    from torch._subclasses.fake_tensor import FakeTensor

    from tunevlseg_torch.models.cris import layers as cris_layers
    if family == "clipseg":
        ttask, batch = _port_clipseg()
        rng = np.random.default_rng(3)
        batch = dict(batch, image=rng.integers(0, 256, (4, 3, 48, 48), dtype=np.uint8))
    else:
        from tunevlseg_torch.models.cris.model import CRISConfig
        from tunevlseg_torch.models.presets import build_cris
        from tunevlseg_torch.training.task import SegmentationTask
        model, spec = build_cris("coop", prompt_depth=2, num_context=4,
                                 config=CRISConfig.tiny(), device="cpu")
        ttask, batch = SegmentationTask(model, spec), clipseg_batch()
    params = dict(ttask.model.state_dict())
    tbatch = _torch(batch)
    eager = serving.task_predict_fn(ttask)
    handed_out = []
    for module, name in ((image_ops, "_matrix_on"), (image_ops, "_stats_on"),
                         (cris_layers, "_pos_tensor")):
        cached = getattr(module, name)
        cached.cache_clear()

        def recording(*key, cached=cached):
            handed_out.append(cached(*key))
            return handed_out[-1]

        monkeypatch.setattr(module, name, recording)
    results = []
    for i, step in enumerate(order.split("_")):
        if step == "eager":
            results.append(eager(params, tbatch))
        else:
            serving.export_task_predict(ttask, params, tbatch, tmp_path / str(i),
                                        platforms=("cpu",))
            results.append(serving.load_fn(tmp_path / str(i), device="cpu")(
                params, tbatch))
    assert handed_out and not any(isinstance(m, FakeTensor) for m in handed_out)
    assert results[0].shape == tbatch["mask"].shape[:1] + (1,) + tbatch["image"].shape[2:]
    for got in results[1:]:
        torch.testing.assert_close(got, results[0], rtol=0, atol=0)


def test_program_loads_without_the_models(tmp_path):
    """A process in which `tunevlseg_torch.models` (and jax) cannot be
    imported loads the exported program and serves the saved weights and
    request, equal to the eager call of the exporting process; afterwards
    no module of `tunevlseg_torch.models` is loaded."""
    ttask, batch = _port_clipseg()
    params = dict(ttask.model.state_dict())
    tbatch = _torch(batch)
    serving.export_task_predict(ttask, params, tbatch, tmp_path / "art",
                                platforms=("cpu",))
    torch.save({"params": params, "batch": tbatch,
                "want": serving.task_predict_fn(ttask)(params, tbatch)},
               tmp_path / "request.pt")
    script = textwrap.dedent(f"""
        import sys
        for name in ("tunevlseg_torch.models", "jax", "jaxlib", "flax",
                     "tunevlseg_tpu"):
            sys.modules[name] = None        # any import of them now fails
        import torch
        torch.set_num_threads(1)
        from tunevlseg_torch.serving import load_fn
        saved = torch.load({str(tmp_path / "request.pt")!r})
        predict = load_fn({str(tmp_path / "art")!r}, device="cpu")
        got = predict(saved["params"], saved["batch"])
        assert torch.equal(got, saved["want"]), (got - saved["want"]).abs().max()
        assert "tunevlseg_torch.ops.library" in sys.modules
        loaded = [m for m in sys.modules if m.startswith("tunevlseg_torch.models")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print("served without the models", tuple(got.shape))
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "served without the models (4, 1, 64, 64)" in proc.stdout


def test_ops_have_fake_implementations():
    """Each `tunevlseg::` op traces on fake tensors: its fake implementation
    gives the output shapes and dtypes the CUDA launcher returns (held
    against the launcher on the card in tests/test_torch_gpu.py)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tunevlseg_torch.ops import library
    assert set(library.OPS) == {"K1", "K3", "K4", "N1"}
    with FakeTensorMode():
        q = torch.empty(2, 10, 3, 96, dtype=torch.bfloat16)
        kv = torch.empty(2, 7, 3, 96, dtype=torch.bfloat16)
        o, lse = library.flash_attn_fwd(q, q, q, 10, True)
        assert (o.shape, o.dtype, lse.shape, lse.dtype) == (
            q.shape, q.dtype, (2, 3, 10), torch.float32)
        assert library.flash_attn_fwd(q, q, q, 10, False)[1].shape == (0,)
        bias = torch.empty(2, 1, 1, 7)
        o = library.biased_attn_fwd(q, kv, kv, bias, 5)
        assert (o.shape, o.dtype) == (q.shape, q.dtype)
        x = torch.empty(2, 384, 16, dtype=torch.bfloat16)
        w = torch.empty(24, 9, 16, dtype=torch.bfloat16)
        out = library.conv_flat(x, w, None, None, None, 384, 3, 10, 10, 1, 128,
                                True, False, 0)
        assert (out.shape, out.dtype) == ((2, 384, 24), torch.bfloat16)
        x = torch.empty(2, 485, 768, dtype=torch.bfloat16)
        y, mean, rstd = library.layer_norm(x, torch.empty(768), None, 1e-5,
                                           torch.float32)
        assert [(t.shape, t.dtype) for t in (y, mean, rstd)] == [
            (x.shape, torch.float32), ((2, 485), torch.float32),
            ((2, 485), torch.float32)]
    # a CPU tensor has no implementation: the wrappers take the plain
    # versions before any op
    with pytest.raises(NotImplementedError):
        library.flash_attn_fwd(torch.zeros(1, 4, 1, 16, dtype=torch.bfloat16),
                               torch.zeros(1, 4, 1, 16, dtype=torch.bfloat16),
                               torch.zeros(1, 4, 1, 16, dtype=torch.bfloat16), 4,
                               False)

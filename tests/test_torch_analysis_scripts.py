"""The port's analysis scripts against the JAX package's, run in this process
on the same inputs: `scripts/torch_analyze_prompts.py` (the port's
`state.pt` / `frozen.pt` against an orbax checkpoint of the same context and
embedding), `scripts/torch_analyze_phrasecut.py` (a synthetic PhraseCut
folder) and `scripts/torch_analyze_zeroshot.py` (`limit` and `topk` over a
synthetic zero-shot folder, `build_ris` replaced in each package's
`eval_zeroshot` namespace by a RIS on the same tiny weights, built as
`tests/test_torch_zero_shot_ris.py` builds them, with a synthetic BPE merges
file); then the entry points without a card.

Tolerances: `contexts.json` equal field by field but the run's path, its
`norm_mean` to 1e-6 relative, `pca.csv` to 1e-6 of the largest |value|;
PhraseCut's `stats.json` equal as text; the zero-shot metrics to 1e-6
absolute (the same per-image dice and IoU counts, means in f64)."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("regex")
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_zero_shot_ris import (KEY, TINY_CFG, _filled,  # noqa: E402
                                            _jcfg, _loaded, _merge)
from tunevlseg_torch import eval_zeroshot as teval  # noqa: E402
from tunevlseg_torch.models.solov2 import model as tsolo  # noqa: E402
from tunevlseg_torch.models.zero_shot_ris import model as tris  # noqa: E402
from tunevlseg_tpu import eval_zeroshot as jeval  # noqa: E402
from tunevlseg_tpu.models.solov2 import model as jsolo  # noqa: E402
from tunevlseg_tpu.models.zero_shot_ris import model as jris  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
IMG = 64
MERGES = ["p o", "l y", "po ly", "polyp </w>", "t h", "th e</w>", "a </w>"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name[:-3], REPO / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(monkeypatch, name: str, args: list):
    """A JAX script's `main()`, which reads sys.argv, in this process."""
    monkeypatch.setattr(sys, "argv", [name, *args])
    _script(name).main()


# --- prompts --------------------------------------------------------------------

def test_analyze_prompts_matches_jax(tmp_path):
    """The same CoOp context (depth 3 x 4 contexts x 16) and a 99-row token
    embedding: an orbax checkpoint as the JAX Trainer writes it for the JAX
    script, `state.pt` / `frozen.pt` as the port's Trainer writes them (the
    port's names) for the port's, decoded on the CPU."""
    ocp = pytest.importorskip("orbax.checkpoint")
    rng = np.random.default_rng(0)
    ctx = rng.normal(size=(3, 4, 16)).astype("f4")
    other = rng.normal(size=(2, 16)).astype("f4")
    emb = rng.normal(size=(99, 16)).astype("f4")

    jrun = tmp_path / "jax" / "run"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((jrun / "checkpoints" / "best").resolve(), {
        "trainable": {"learner": {"context_vectors": ctx,
                                  "shared_context": other}},
        "step": np.int32(3)})
    ckptr.save((jrun / "checkpoints" / "frozen").resolve(), {
        "params": {"text_model": {"token_embedding": {"embedding": emb}}}})
    ckptr.wait_until_finished()

    trun = tmp_path / "torch" / "run"
    (trun / "checkpoints" / "best").mkdir(parents=True)
    (trun / "checkpoints" / "frozen").mkdir(parents=True)
    torch.save({"trainable": {"learner.context_vectors": torch.from_numpy(ctx),
                              "learner.shared_context": torch.from_numpy(other)},
                "optimizer": {}, "step": 3, "model_state": {}},
               trun / "checkpoints" / "best" / "state.pt")
    torch.save({"text_model.token_embedding.weight": torch.from_numpy(emb),
                "text_model.final_layer_norm.weight": torch.ones(16)},
               trun / "checkpoints" / "frozen" / "frozen.pt")

    want = _script("analyze_prompts.py").analyze([jrun], tmp_path / "jax_out")
    got = _script("torch_analyze_prompts.py").main(
        [str(trun), "--out", str(tmp_path / "torch_out"), "--device", "cpu"])
    assert len(got) == 2 and [r["tensor"] for r in got] == [
        "learner/context_vectors", "learner/shared_context"]
    files = [json.loads((tmp_path / d / "contexts.json").read_text())
             for d in ("torch_out", "jax_out")]
    assert files[0] == json.loads(json.dumps(got))
    for g, w in zip(*files):
        assert g.pop("run") == str(trun) and w.pop("run") == str(jrun)
        np.testing.assert_allclose(g.pop("norm_mean"), w.pop("norm_mean"), rtol=1e-6)
        assert g == w
    assert len(files[0][0]["nearest_token_ids"]) == 12   # 3 x 4 vectors, top 3
    for method in ("pca", "tsne"):
        paths = [tmp_path / d / f"{method}.csv" for d in ("torch_out", "jax_out")]
        if method == "tsne" and not paths[1].exists():
            continue                   # sklearn not importable: no t-SNE
        g, w = (np.loadtxt(p, delimiter=",", skiprows=1) for p in paths)
        assert g.shape == w.shape == (14, 3)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())


# --- PhraseCut ------------------------------------------------------------------

def test_analyze_phrasecut_matches_jax(tmp_path, monkeypatch):
    """tests/test_analysis_scripts.py's folder plus a task on an invalid
    PhraseCut image id (dropped by both datasets) and a missing image (not
    scanned): `stats.json` is the JAX script's, byte for byte."""
    from tests.test_analysis_scripts import _make_phrasecut
    root = _make_phrasecut(tmp_path)
    tasks = json.loads((root / "tasks.json").read_text())
    tasks += [{"task_id": "13__0", "phrase": "tree"},
              {"task_id": "14__1", "phrase": "red car"}]
    cv2.imwrite(str(root / "images" / "13.jpg"), np.zeros((40, 30, 3), np.uint8))
    (root / "tasks.json").write_text(json.dumps(tasks))
    args = ["--task-json", str(root / "tasks.json"), "--image-dir",
            str(root / "images"), "--mask-dir", str(root / "masks"),
            "--target-size", "16"]
    _run_jax_main(monkeypatch, "analyze_phrasecut.py",
                  args + ["--out-dir", str(tmp_path / "jax")])
    got = _script("torch_analyze_phrasecut.py").main(
        args + ["--out-dir", str(tmp_path / "torch")])
    text = (tmp_path / "torch" / "stats.json").read_text()
    assert text == (tmp_path / "jax" / "stats.json").read_text()
    assert json.loads(text) == json.loads(json.dumps(got))
    assert got["tasks"] == 5 and got["image_shapes"]["scanned"] == 4


# --- zero-shot ------------------------------------------------------------------

@pytest.fixture(scope="module")
def zs(tmp_path_factory):
    """A synthetic zero-shot folder (three 64 x 64 images, square masks), a
    merges file, and the two packages' `ZeroShotRIS` on the same tiny
    weights (the eval_zeroshot CLI's tiny models, seeded numpy trees)."""
    tmp = tmp_path_factory.mktemp("zs")
    root = tmp / "data" / "zsds"
    for sub in ("images", "masks", "anns"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    tasks = []
    for i in range(3):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 255, (IMG, IMG, 3), dtype=np.uint8))
        mask = np.zeros((IMG, IMG), np.uint8)
        mask[8 + 4 * i:40 + 4 * i, 10:50] = 255
        cv2.imwrite(str(root / "masks" / f"{i}.png"), mask)
        tasks.append({"img_name": f"{i}.png", "mask_name": f"{i}.png",
                      "prompts": {"p0": "a polyp"}, "object_class": "polyp"})
    (root / "anns" / "test.json").write_text(json.dumps(tasks))
    merges = tmp / "merges.txt"
    merges.write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")

    ccfg, scfg, size = teval.ris_configs(TINY_CFG)
    jclip = jris.MaskedCLIP(_jcfg(ccfg))
    import functools
    image = jax.eval_shape(functools.partial(
        jclip.init, method=jclip.get_image_features), KEY,
        jnp.zeros((1, 3, size, size)))["params"]
    text = jax.eval_shape(functools.partial(
        jclip.init, method=jclip.get_text_features), KEY,
        jnp.zeros((2, 12), jnp.int32), jnp.ones((2, 12), jnp.int32))["params"]
    cparams = _filled(_merge(image, text), 11)
    jm = jsolo.SOLOv2(_jcfg(scfg))
    sparams = _filled(jax.eval_shape(jm.init, KEY, jnp.zeros((1, 3, IMG, IMG)))["params"], 10)
    jr = jris.ZeroShotRIS(_jcfg(ccfg), _jcfg(scfg), cparams, sparams,
                          clip_image_size=size)
    tr = tris.ZeroShotRIS(ccfg, scfg, _loaded(tris.MaskedCLIP(ccfg), cparams),
                          _loaded(tsolo.SOLOv2(scfg), sparams), clip_image_size=size)
    overrides = ["ds_name=zsds", f"paths.data_root={tmp / 'data'}",
                 f"paths.log_dir={tmp / 'logs'}", f"vocab_path={merges}",
                 "+tiny_model=true", f"img_size={IMG}"]
    return {"jax": jr, "torch": tr, "overrides": overrides, "tmp": tmp}


@pytest.mark.parametrize("mode,extra", [("limit", []), ("topk", ["--topk", "1", "2", "3"])])
def test_analyze_zeroshot_matches_jax(zs, mode, extra, monkeypatch, tmp_path):
    """`limit` (the best of every valid FreeSOLO proposal) and `topk` (the
    best of the k most similar, through `ZeroShotRIS.__call__`), each
    script's `main` in this process with its package's `build_ris` giving
    the shared RIS: the metrics agree, and each is in [0, 1]."""
    built = []
    monkeypatch.setattr(jeval, "build_ris", lambda cfg: built.append("jax") or zs["jax"])
    monkeypatch.setattr(teval, "build_ris", lambda cfg, device, dtype: built.append(
        f"{device} {dtype}") or zs["torch"])
    for ris in (zs["jax"], zs["torch"]):
        monkeypatch.setattr(ris, "num_masks", 1)
    _run_jax_main(monkeypatch, "analyze_zeroshot.py",
                  [mode, *extra, "--out-dir", str(tmp_path / "jax"), "--",
                   *zs["overrides"]])
    got = _script("torch_analyze_zeroshot.py").main(
        [mode, *zs["overrides"], "+trainer.device=cpu", *extra,
         "--out-dir", str(tmp_path / "torch")])
    assert built == ["jax", "cpu torch.float32"]
    want = json.loads((tmp_path / "jax" / f"{mode}_metrics.json").read_text())
    assert json.loads((tmp_path / "torch" / f"{mode}_metrics.json").read_text()) == got
    assert set(got) == set(want) and got["mode"] == mode and got["images"] == 3
    for k, v in want.items():
        if k not in ("mode", "images"):
            assert 0.0 <= got[k] <= 1.0, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    per_image = [np.load(tmp_path / d / f"{mode}_per_image.npz") for d in ("torch", "jax")]
    for key in ("max_dices", "max_ious"):
        np.testing.assert_allclose(per_image[0][key], per_image[1][key], rtol=0, atol=1e-6)
    if mode == "topk":
        assert zs["torch"].num_masks == 3
        assert got["top1_dice"] <= got["top2_dice"] <= got["top3_dice"]


# --- without a card --------------------------------------------------------------

def _mnist(tmp):
    return _script("torch_train_mnist.py").main(["--synthetic", "--epochs", "1"])


def _sweep(tmp):
    return _script("torch_sweep.py").main(
        ["--space", "tiny", "--trials", "1", "--results", str(tmp / "r.json"),
         "ds_name=kvasir_polyp"], train_main=lambda o: pytest.fail("a trial ran"))


def _prompts(tmp):
    return _script("torch_analyze_prompts.py").main([str(tmp), "--out", str(tmp / "o")])


def _zeroshot(tmp):
    return _script("torch_analyze_zeroshot.py").main(["limit", "ds_name=zsds"])


@pytest.mark.parametrize("run", [_mnist, _sweep, _prompts, _zeroshot],
                         ids=["mnist", "sweep", "prompts", "zeroshot"])
def test_entry_points_raise_without_a_card(run, tmp_path):
    """Each entry point of the slice that runs a model or a product goes to
    the card, and without one raises before any work, naming how to ask for
    the CPU (`--device cpu`, or `+trainer.device=cpu` for those composed
    from the configs); the CPU runs are the tests above."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match=r"no CUDA device.*(--device cpu|\+trainer.device=cpu)"):
        run(tmp_path)

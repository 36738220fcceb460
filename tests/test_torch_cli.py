"""The port's config composer and its `train` / `eval` entry points:
`compose` against the JAX composer on every experiment file and model
option of `configs/`, and train -> test -> predict cycles on the CPU
(`+trainer.device=cpu`) with tiny models on a synthetic image folder, with a
synthetic BPE merges file as `vocab_path` (tiny configs keep the real
vocabulary size, so its ids stay in range and `test_loss` stays finite).
Options of slices not ported yet raise and name their ROADMAP item."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("yaml")
pytest.importorskip("regex")

from tunevlseg_tpu.config.composer import compose as jcompose  # noqa: E402
from tunevlseg_torch import eval as eval_mod  # noqa: E402
from tunevlseg_torch import train as train_mod  # noqa: E402
from tunevlseg_torch.config.composer import compose  # noqa: E402
from tunevlseg_torch.config.instantiate import instantiate  # noqa: E402

CONFIG_DIR = train_mod.CONFIG_DIR
REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = sorted(str(p.relative_to(CONFIG_DIR / "experiment"))[:-5]
                     for p in (CONFIG_DIR / "experiment").rglob("*.yaml"))
MODELS = sorted(str(p.relative_to(CONFIG_DIR / "model"))[:-5]
                for p in (CONFIG_DIR / "model").rglob("*.yaml"))
MERGES = ["p o", "l y", "po ly", "polyp </w>", "a </w>", "t h", "th e</w>"]


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


def _compose_both(root, overrides):
    """(port, JAX) results of one composition, or the exception each raised."""
    out = []
    for fn in (compose, jcompose):
        try:
            out.append(fn(CONFIG_DIR, root, overrides))
        except Exception as e:   # both must raise alike
            out.append((type(e), str(e)))
    return out


@pytest.mark.parametrize("root", ["train", "eval", "eval_zeroshot"])
def test_compose_matches_jax_on_every_experiment(root):
    assert len(EXPERIMENTS) >= 8 and "coop/clipseg" in EXPERIMENTS
    for name in EXPERIMENTS:
        for extra in ([], ["trainer=debug", "model.optimizer.lr=1e-3",
                           "+tiny_model=true", "~tags"]):
            got, want = _compose_both(
                root, [f"experiment={name}", "ds_name=kvasir_polyp",
                       "ckpt_path=x", *extra])
            assert got == want, (root, name, extra)


def test_compose_matches_jax_on_every_model_and_group():
    assert {"coop/clipseg", "cocoop/cris", "maple_clipseg",
            "shared_attn_clipseg"} <= set(MODELS)
    groups = [f"model={m}" for m in MODELS] + [
        f"data={p.stem}" for p in (CONFIG_DIR / "data").glob("*.yaml")] + [
        f"debug={p.stem}" for p in (CONFIG_DIR / "debug").glob("*.yaml")] + [
        "trainer=cpu", "hparams_search=coop", "+trainer.device=cpu"]
    for override in groups:
        got, want = _compose_both("train", ["ds_name=busi", override])
        assert got == want, override
    got, want = _compose_both("train", [])     # a mandatory value missing
    assert got == want and got[0] is ValueError and "ds_name" in got[1]


def test_instantiate_partial_and_args():
    node = {"_target_": "builtins.dict", "a": 1,
            "b": {"_target_": "builtins.list", "_args_": [[1, 2]]}}
    assert instantiate(node) == {"a": 1, "b": [1, 2]}
    part = instantiate({"_target_": "builtins.int", "_partial_": True,
                        "base": 2})
    assert part("11") == 3


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Eight 40 x 40 images with square masks (the folder of
    tests/test_cli.py) and a BPE merges file."""
    tmp = tmp_path_factory.mktemp("cli")
    root = tmp / "data" / "kvasir_polyp"
    for sub in ("images", "masks", "anns"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    tasks = []
    for i in range(8):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
        mask = np.zeros((40, 40), np.uint8)
        mask[8:30, 8:30] = 255
        cv2.imwrite(str(root / "masks" / f"{i}.png"), mask)
        tasks.append({"img_name": f"{i}.png", "mask_name": f"{i}.png",
                      "prompts": {"p0": "polyp"}})
    for split in ("train", "val", "test"):
        (root / "anns" / f"{split}.json").write_text(json.dumps(tasks))
    merges = tmp / "merges.txt"
    merges.write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return {"data_root": tmp / "data", "vocab": merges}


def _common(synth, out, img=32):
    return ["ds_name=kvasir_polyp", f"paths.data_root={synth['data_root']}",
            f"paths.log_dir={out}", f"vocab_path={synth['vocab']}",
            f"img_size={img}", "+tiny_model=true", "data.batch_size=4",
            "data.num_workers=2", "trainer=debug", "+trainer.device=cpu"]


def test_train_test_predict_then_eval_from_best(synth, tmp_path):
    out = tmp_path / "logs"
    result = train_mod.main(_common(synth, out) + [
        "trainer.max_epochs=2", "predict=true", "exp_name=smoke"])
    assert "test_dice" in result and 0 <= result["test_dice"] <= 1
    assert np.isfinite(result["test_loss"])
    run = out / "train" / "smoke"
    ckpt = run / "checkpoints"
    for tag in ("best", "last", "frozen"):
        assert (ckpt / tag).is_dir(), tag
    masks = sorted(Path(result["output_masks_dir"]).glob("*.png"))
    assert len(masks) == 8
    assert cv2.imread(str(masks[0]), cv2.IMREAD_GRAYSCALE).shape == (40, 40)
    assert (run / "config.yaml").exists() and (run / "metrics.csv").exists()
    hparams = json.loads((run / "hparams.json").read_text())
    assert 0 < hparams["model/params/trainable"] < hparams["model/params/total"]
    assert not (run / "FAILED").exists()

    evaluated = eval_mod.main(_common(synth, out) + [
        f"ckpt_path={ckpt}", "exp_name=smoke_eval"])
    np.testing.assert_allclose(evaluated["test_dice"], result["test_dice"],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(evaluated["test_loss"], result["test_loss"],
                               rtol=1e-6)


def test_export_dir_in_train_and_eval(synth, tmp_path):
    """`export_dir` in both CLIs (tests/test_cli.py's export check): the
    train CLI exports the inference step after test and predict, the eval
    CLI the checkpoint-restored one; each program serves the weights of the
    checkpoint the train run wrote, and the two agree bit for bit (the
    artifacts carry no weights, so it does not matter that `Trainer.test`
    restored the best ones into the model in place)."""
    from tunevlseg_torch import serving
    out = tmp_path / "logs"
    trained = train_mod.main(_common(synth, out) + [
        "trainer.max_epochs=1", "exp_name=export",
        f"+export_dir={tmp_path / 'train_art'}"])
    evaluated = eval_mod.main(_common(synth, out) + [
        f"ckpt_path={out / 'train' / 'export' / 'checkpoints'}", "predict=false",
        "exp_name=export_eval", f"+export_dir={tmp_path / 'eval_art'}",
        "+export_platforms=[cpu]"])
    ckpt = out / "train" / "export" / "checkpoints"
    probs = []
    for result in (trained, evaluated):
        meta = serving.read_meta(result["export_dir"])
        assert meta["kind"] == "segmentation_task_predict"
        assert meta["model"] == "CLIPSegForSegmentation"
        assert meta["platforms"] == ["cpu"] and meta["tunevlseg_ops"] == {"cpu": []}
        assert (Path(result["export_dir"]) / "predict.cpu.pt2").exists()
        assert [s["shape"] for s in meta["in_specs"] if s["name"] == "1.image"] \
            == [[4, 3, 32, 32]]
        probs.append(exported_probs(result["export_dir"], ckpt))
    assert probs[0].shape == (4, 1, 32, 32) and bool(probs[0].isfinite().all())
    torch.testing.assert_close(probs[1], probs[0], rtol=0, atol=0)


def exported_probs(export_dir, ckpt, tag: str = "best") -> torch.Tensor:
    """The CPU program of `export_dir` on the weights of the checkpoint
    directory `ckpt` (its frozen tensors and the trainable ones of `tag`)
    and a seeded batch of the program's input shapes."""
    from tunevlseg_torch import serving
    params = {**torch.load(Path(ckpt) / "frozen" / "frozen.pt"),
              **torch.load(Path(ckpt) / tag / "state.pt")["trainable"]}
    meta = serving.read_meta(export_dir)
    shapes = {s["name"][2:]: s["shape"] for s in meta["in_specs"]
              if s["name"].startswith("1.")}
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randint(0, 256, shapes["image"], generator=g,
                                    dtype=torch.uint8),
             "input_ids": torch.full(shapes["input_ids"], 320, dtype=torch.int32),
             "attention_mask": torch.ones(shapes["attention_mask"],
                                          dtype=torch.int32)}
    batch["input_ids"][:, 0], batch["input_ids"][:, 3] = 49406, 49407
    if "text_index" in shapes:
        batch["text_index"] = torch.zeros(shapes["text_index"], dtype=torch.int32)
    return serving.load_fn(export_dir, device="cpu")(params, batch)


def test_cris_train_cycle(synth, tmp_path):
    result = train_mod.main(_common(synth, tmp_path / "logs", img=64) + [
        "experiment=coop/cris", "predict=false", "exp_name=cris_smoke"])
    assert 0 <= result["test_dice"] <= 1 and np.isfinite(result["test_loss"])


@pytest.mark.parametrize("layout", ["nchw", "flat"])
def test_trans_segmentor_train_test_predict_then_eval(synth, tmp_path, layout):
    """`model=trans_seg` (CLIP towers, the whole model trains) through fit ->
    test -> predict, then the eval entry point from its best checkpoint;
    `+model.layout=flat` runs the upsampler through the flat convolution."""
    out = tmp_path / "logs"
    extra = [] if layout == "nchw" else ["+model.layout=flat"]
    result = train_mod.main(_common(synth, out) + [
        "model=trans_seg", "trainer.max_epochs=2", "predict=true",
        "exp_name=ts_smoke", *extra])
    assert 0 <= result["test_dice"] <= 1 and np.isfinite(result["test_loss"])
    assert len(list(Path(result["output_masks_dir"]).glob("*.png"))) == 8
    run = out / "train" / "ts_smoke"
    hparams = json.loads((run / "hparams.json").read_text())
    assert hparams["model/params/trainable"] == hparams["model/params/total"]
    assert ("layout: flat" in (run / "config.yaml").read_text()) == (
        layout == "flat")
    evaluated = eval_mod.main(_common(synth, out) + [
        "model=trans_seg", f"ckpt_path={run / 'checkpoints'}",
        "exp_name=ts_eval", *extra])
    np.testing.assert_allclose(evaluated["test_loss"], result["test_loss"],
                               rtol=1e-6)


def _spiece(path: Path) -> Path:
    """A synthetic sentencepiece model (tests/test_torch_data.py's pieces),
    built through transformers' protobuf module: no file, no
    sentencepiece."""
    from transformers.convert_slow_tokenizer import import_protobuf

    from tests.test_torch_data import SIGLIP_PIECES
    proto = import_protobuf().ModelProto()
    for piece, score, kind in SIGLIP_PIECES:
        p = proto.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    proto.trainer_spec.model_type = 1   # unigram
    proto.trainer_spec.unk_id = 0
    path.write_bytes(proto.SerializeToString())
    return path


def test_trans_segmentor_siglip_train_cycle(synth, tmp_path):
    """`model=trans_seg_siglip` with the sentencepiece tokenizer: SigLIP
    towers fed real (synthetic-vocabulary) text, fit -> test."""
    pytest.importorskip("transformers")
    spiece = _spiece(tmp_path / "spiece.model")
    args = [a for a in _common(synth, tmp_path / "logs")
            if not a.startswith("vocab_path=")]
    result = train_mod.main(args + [
        "model=trans_seg_siglip", "tokenizer_family=siglip",
        f"vocab_path={spiece}", "max_length=64", "predict=false",
        "exp_name=ts_siglip_smoke"])
    assert 0 <= result["test_dice"] <= 1 and np.isfinite(result["test_loss"])


@pytest.mark.parametrize("overrides", [
    ["model=trans_seg"], ["model=trans_seg", "+tiny_model=true"],
    ["model=trans_seg_siglip"], ["experiment=phrasecut"],
    ["model=trans_seg", "model.upsampler_norm=group", "img_size=416",
     "model.add_pos_enc=true", "model.decoder_dropout=0.0"]],
    ids=["trans_seg", "tiny", "siglip", "phrasecut", "options"])
def test_trans_segmentor_config_matches_jax(overrides):
    from tunevlseg_tpu.train import trans_segmentor_config as jconfig
    cfg = compose(CONFIG_DIR, "train", ["ds_name=x", *overrides])
    assert (dataclasses.asdict(train_mod.trans_segmentor_config(cfg))
            == dataclasses.asdict(jconfig(cfg)))


def test_trans_segmentor_head_dim_96_raises_on_the_card_and_runs_on_the_cpu():
    """`model=trans_seg_siglip` runs its decoder at 768 / 8 = 96 dims a head,
    which K1, K2 and K3 are built for: its configuration passes the card's
    head-dim gate. A head dim still unbuilt (48, as
    `test_gate_raises_on_head_dim_k1_lacks` uses) raises on a CUDA device
    before anything is made (no card needed to see it), naming the head
    dim. Tiny models with a 96- and a 48-dim decoder head build and run on
    the CPU."""
    from tunevlseg_torch.models.presets import (build_trans_segmentor,
                                                trans_segmentor_head_dims,
                                                unbuilt_head_dims)
    from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
    from tunevlseg_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS
    assert SUPPORTED_HEAD_DIMS == (16, 32, 64, 96)
    cfg = compose(CONFIG_DIR, "train", ["model=trans_seg_siglip", "ds_name=x"])
    siglip = train_mod.trans_segmentor_config(cfg)
    assert siglip.effective_projection_dim == 768
    assert trans_segmentor_head_dims(siglip) == {
        "text tower": 64, "vision tower": 64, "decoder": 96}
    assert unbuilt_head_dims(siglip) == {}
    tiny96 = TransSegmentorConfig.tiny(projection_dim=96, decoder_num_heads=1)
    tiny48 = TransSegmentorConfig.tiny(projection_dim=96, decoder_num_heads=2)
    # the tiny towers' heads (8 and 12 dims) are unbuilt on the card too
    assert "decoder" not in unbuilt_head_dims(tiny96)
    assert unbuilt_head_dims(tiny48)["decoder"] == 48
    with pytest.raises(NotImplementedError, match="'decoder': 48"):
        build_trans_segmentor(tiny48, device=torch.device("cuda"))
    g = torch.Generator().manual_seed(0)
    for tiny in (tiny96, tiny48):
        model, _ = build_trans_segmentor(tiny, device="cpu")
        out = model(torch.randint(3, 999, (2, 12), generator=g),
                    torch.randn(2, 3, 32, 32, generator=g))
        assert out.shape == (2, 1, 32, 32) and bool(out.isfinite().all())


def test_loading_from_disk_leaves_cv2_on_one_thread(synth):
    """One sample decoded from disk through the port's dataset and train
    transforms, in a process of its own (cv2's thread count is global): cv2
    was imported first with its default pool, and afterwards runs on one
    thread, as the JAX pipeline sets it; the loader's worker threads each
    decode a sample, so cv2's own threads would multiply with them."""
    root = synth["data_root"] / "kvasir_polyp"
    script = f"""
import cv2
default = cv2.getNumThreads()
from tunevlseg_torch.data.datasets import ImageTextMaskDataset
from tunevlseg_torch.data.tokenizer import CLIPTokenizer
from tunevlseg_torch.data.transforms import train_transforms
ds = ImageTextMaskDataset(
    image_dir={str(root / "images")!r}, mask_dir={str(root / "masks")!r},
    task_path={str(root / "anns" / "train.json")!r},
    tokenizer=CLIPTokenizer({str(synth["vocab"])!r}),
    transforms=train_transforms(32))
item = ds[0]
assert item["image"].shape == (3, 32, 32), item["image"].shape
print("threads", default, cv2.getNumThreads())
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    _, default, after = proc.stdout.split()
    assert int(after) == 1, (default, after)


def test_module_entry_point_text_dedup_cycle(synth, tmp_path):
    """`python -m tunevlseg_torch.train experiment=coop/clipseg` (whose
    data.text_dedup is 1) in a process of its own."""
    out = tmp_path / "logs"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "tunevlseg_torch.train", "experiment=coop/clipseg",
         *_common(synth, out), "trainer.max_epochs=1", "predict=false",
         "exp_name=dedup"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    records = [json.loads(line) for line in
               (out / "train" / "dedup" / "metrics.jsonl").read_text().splitlines()]
    test = [r for r in records if "test_loss" in r]
    assert len(test) == 1 and np.isfinite(test[0]["test_loss"])
    cfg = (out / "train" / "dedup" / "config.yaml").read_text()
    assert "text_dedup: 1" in cfg


def test_the_card_is_the_default(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    args = [a for a in _common(synth, tmp_path) if a != "+trainer.device=cpu"]
    with pytest.raises(RuntimeError, match=r"\+trainer.device=cpu"):
        train_mod.main(args + ["exp_name=nocard"])
    assert (tmp_path / "train" / "nocard" / "FAILED").read_text().strip() == \
        "RuntimeError"


def test_eval_without_ckpt_raises(synth, tmp_path):
    with pytest.raises(ValueError, match="ckpt_path"):
        eval_mod.main(_common(synth, tmp_path) + ["ckpt_path=null",
                                                  "exp_name=nockpt"])


# the multi-device keys run (tests/test_torch_distributed.py starts two
# ranks through trainer.n_devices=2, tests/test_torch_tensor_parallel.py a
# grid with trainer.model_parallel=2): each case here either runs in this
# process (fsdp over one process: nothing to shard, the plain path; seq_shard
# without a model axis: a no-op) or fails cheaply, before any rank starts,
# naming what it needs (model_parallel must divide the ranks)
RANKS = "must divide by the 2 ranks"
OPTION_CASES = [
    (("trainer.n_devices=2", "data.batch_size=3"), ValueError, RANKS),
    (("trainer.model_parallel=2",), ValueError,
     "1 ranks not divisible by model_parallel=2"),
    (("trainer.seq_shard=true",), None, None),
    (("trainer.fsdp=true",), None, None),
    (("trainer.multihost=true",), ValueError,
     "trainer.coordinator_address.*trainer.num_processes.*trainer.process_id"),
    (("trainer.remat=true", "trainer.fsdp=true"), None, None),
    (("trainer.accumulate_grad_batches=2", "trainer.n_devices=0"), ValueError,
     "trainer.n_devices=0"),
]


@pytest.mark.parametrize(
    "overrides,error,match", OPTION_CASES,
    # the ids they had
    ids=["trainer.n_devices=2-Slice G", "trainer.model_parallel=2-Do not port",
         "trainer.seq_shard=true-Do not port", "trainer.fsdp=true-Slice G",
         "trainer.multihost=true-Slice G", "trainer.remat=true-Slice G",
         "trainer.accumulate_grad_batches=2-Slice G"])
def test_unported_options_raise_with_their_item(synth, tmp_path, overrides,
                                                error, match, monkeypatch):
    from tunevlseg_torch.parallel import distributed
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    args = _common(synth, tmp_path) + list(overrides) + ["exp_name=x"]
    if error is None:
        # one process: no group is made and nothing is sharded
        from tunevlseg_torch.parallel import data_parallel, tensor_parallel

        def no_shard(*args, **kwargs):
            raise AssertionError("sharded over one process")
        monkeypatch.setattr(data_parallel, "shard", no_shard)
        monkeypatch.setattr(tensor_parallel, "shard_model", no_shard)
        result = train_mod.main(args)
        assert np.isfinite(result["test_loss"])
        assert (tmp_path / "train" / "x" / "checkpoints" / "last").is_dir()
    else:
        with pytest.raises(error, match=match):
            train_mod.main(args)
    assert not distributed.is_initialized()


def test_accumulation_remat_cycle(synth, tmp_path):
    """trainer.accumulate_grad_batches + trainer.remat + gradient_clip_val
    through the CLI for 2 epochs, the counterpart of JAX
    `tests/test_cli.py::test_accumulation_remat_fsdp_cycle`, and again with
    trainer.fsdp, which over one process runs the plain path."""
    keys = ["trainer.max_epochs=2", "trainer.accumulate_grad_batches=2",
            "trainer.remat=true", "trainer.gradient_clip_val=1.0", "predict=false"]
    result = train_mod.main(_common(synth, tmp_path / "logs") + keys
                            + ["exp_name=accum_smoke"])
    assert np.isfinite(result["test_loss"])
    assert 0 <= result["test_dice"] <= 1
    sharded = train_mod.main(_common(synth, tmp_path / "logs") + keys
                             + ["trainer.fsdp=true", "exp_name=accum_fsdp"])
    assert np.isfinite(sharded["test_loss"])
    # the same weights and batches: fsdp over one process is the plain path
    assert sharded["test_loss"] == pytest.approx(result["test_loss"], rel=1e-5)


def test_unported_families_raise_in_build_model_and_task():
    """Zero-shot RIS is ported, but is training-free: the train CLI's model
    builder names its entry point, `tunevlseg_torch.eval_zeroshot`."""
    cfg = compose(CONFIG_DIR, "eval_zeroshot", ["experiment=zsseg_clip",
                                                "ds_name=x"])
    with pytest.raises(NotImplementedError,
                       match=r"python -m tunevlseg_torch\.eval_zeroshot"):
        train_mod.build_model_and_task(cfg, device="cpu")
    assert "zero_shot_ris" not in train_mod.UNPORTED_FAMILIES


def test_zsbench_script_on_the_cpu():
    """scripts/torch_zsbench.py rehearsed on the CPU with the test models: a
    pipelined fused pass, its JSON line naming the CPU (no device metric);
    `--n-devices 2` runs the proposals over the CPU twice."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_zsbench", REPO / "scripts" / "torch_zsbench.py")
    zsbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(zsbench)
    out = zsbench.main(["--tiny", "--device", "cpu", "--dtype", "f32", "--img",
                        "64", "--images", "2", "--alpha", "0.95", "--fused",
                        "--pipeline", "2"])
    assert out["metric"] == "zsseg_imgs_per_sec_alpha0.95_fused_pipe2"
    assert out["device"] == "cpu" and out["value"] > 0
    two = zsbench.main(["--tiny", "--device", "cpu", "--dtype", "f32", "--img",
                        "64", "--images", "1", "--alpha", "0.95", "--fused",
                        "--n-devices", "2"])
    assert two["n_devices"] == 2 and two["value"] > 0


def test_denseclip_family_names_its_trainer_script():
    """DenseCLIP is ported, but trains through its own script, as in the JAX
    package (whose CLI has no such family)."""
    cfg = compose(CONFIG_DIR, "train", ["experiment=coop/clipseg", "ds_name=x",
                                        "+model.family=denseclip"])
    with pytest.raises(NotImplementedError,
                       match="scripts/torch_train_denseclip.py") as raised:
        train_mod.build_model_and_task(cfg, device="cpu")
    assert "item 7" not in str(raised.value)
    assert "denseclip" not in train_mod.UNPORTED_FAMILIES


def test_initializer_embeddings_set_num_context(synth):
    """The context initializer ("a photo of a") through the token embedding
    of pretrained weights: its token count becomes num_context, as the JAX
    CLI does it."""
    from tunevlseg_torch.data.tokenizer import CLIPTokenizer
    cfg = compose(CONFIG_DIR, "train", ["experiment=coop/clipseg",
                                        "ds_name=x", "+tiny_model=true",
                                        "+trainer.device=cpu",
                                        "trainer.precision=f32"])
    tok = CLIPTokenizer(synth["vocab"])
    table = np.random.default_rng(0).normal(size=(49408, 16)).astype(np.float32)
    ids = tok.encode("a photo of a", add_special_tokens=False)
    emb, n = train_mod._initializer_embeddings(
        cfg, tok, {"text_model.token_embedding.weight": torch.from_numpy(table)})
    assert n == len(ids) and emb.shape == (1, len(ids), 16)
    np.testing.assert_array_equal(emb[0], table[np.asarray(ids)])
    assert train_mod._initializer_embeddings(cfg, tok, None) == (None, 4)
    model, _ = train_mod.build_model_and_task(
        cfg, tok, {"text_model.token_embedding.weight": torch.from_numpy(table)},
        device="cpu")
    ctx = model.learner.context_vectors.detach()
    assert ctx.shape[1] == len(ids)
    np.testing.assert_array_equal(ctx[0].numpy(), table[np.asarray(ids)])

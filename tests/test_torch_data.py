"""The port's data layer against the JAX package's: the tokenizers' ids
(CLIP BPE in both vocab layouts on a synthetic merges file, WordPiece on a
vocab.txt, SigLIP unigram on a sentencepiece proto), the transforms, the
datasets' arrays on synthetic image folders, and the `DataLoader`'s order
and batches (seeds, epochs, `start_batch`, `drop_last`, `valid` padding,
`text_dedup`, shards). Equal means equal: every array bit for bit. Also the
port's logger files and its PNG writer."""
import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("regex")

from tunevlseg_tpu.data import datasets as jdatasets  # noqa: E402
from tunevlseg_tpu.data import open_domain as jopen  # noqa: E402
from tunevlseg_tpu.data import pipeline as jpipeline  # noqa: E402
from tunevlseg_tpu.data import tokenizer as jtok  # noqa: E402
from tunevlseg_tpu.data import transforms as jtf  # noqa: E402
from tunevlseg_tpu.utils import logging as jlogging  # noqa: E402
from tunevlseg_torch.data import datasets as tdatasets  # noqa: E402
from tunevlseg_torch.data import open_domain as topen  # noqa: E402
from tunevlseg_torch.data import pipeline as tpipeline  # noqa: E402
from tunevlseg_torch.data import tokenizer as ttok  # noqa: E402
from tunevlseg_torch.data import transforms as ttf  # noqa: E402
from tunevlseg_torch.utils import logging as tlogging  # noqa: E402

# BPE merge rules over the letters of the texts below (a CLIP merges file:
# a version line, then one "left right" rule a line, in rank order)
MERGES = ["p o", "l y", "po ly", "polyp </w>", "t h", "th e</w>", "o f</w>",
          "a </w>", "ph o", "pho to</w>", "l e", "s i", "si o", "sio n</w>",
          "le sion</w>", "c a", "ca f", "i n</w>", "1 2"]
TEXTS = ["a photo of the polyp", "The PHOTO, of a polyp!",
         "lesion in 12 cm (left)", "café &amp; polyps", "  a\tb\nc ",
         "", "polyp " * 40]
WORDPIECE_VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "photo", "of", "a", "poly",
    "##p", "##ps", "lesion", "##s", "x", "-", "ray", "in", "left", "lobe",
    ".", ",", "(", ")", "2", "cm"]
SIGLIP_PIECES = [("<unk>", 0.0, 2), ("</s>", 0.0, 3), ("▁", -2.5, 1),
                 ("▁a", -3.0, 1), ("▁the", -2.0, 1), ("▁photo", -4.0, 1),
                 ("▁of", -2.2, 1), ("▁polyp", -5.0, 1), ("▁pol", -4.5, 1),
                 ("yp", -3.5, 1), ("o", -4.0, 1), ("l", -4.1, 1),
                 ("y", -4.2, 1), ("p", -4.3, 1), ("▁le", -3.4, 1),
                 ("sion", -3.6, 1), ("s", -3.9, 1)]


@pytest.fixture(scope="module")
def merges_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "merges.txt"
    path.write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    return path


def assert_same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


# --- tokenizers --------------------------------------------------------------

@pytest.mark.parametrize("layout", ["standard", "denseclip"])
def test_clip_bpe_ids_match_jax(merges_path, layout):
    got = ttok.CLIPTokenizer(merges_path, vocab_layout=layout)
    want = jtok.CLIPTokenizer(merges_path, vocab_layout=layout)
    assert (got.bos_token_id, got.eos_token_id, got.vocab_size) == (
        want.bos_token_id, want.eos_token_id, want.vocab_size)
    for text in TEXTS:
        for special in (True, False):
            assert (got.encode(text, add_special_tokens=special)
                    == want.encode(text, add_special_tokens=special)), text
        assert got.decode(got.encode(text)) == want.decode(want.encode(text))
    for style in ("hf", "openai"):
        for length in (77, 8):
            assert_same_arrays(got(TEXTS, max_length=length, style=style),
                               want(TEXTS, max_length=length, style=style))
    assert_same_arrays(got(TEXTS, padding="longest"),
                       want(TEXTS, padding="longest"))


def test_wordpiece_ids_match_jax(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(WORDPIECE_VOCAB) + "\n")
    got, want = ttok.WordPieceTokenizer(path), jtok.WordPieceTokenizer(path)
    texts = TEXTS + ["x-ray of the left lobe.", "肝臓 lesion", "polyps"]
    for text in texts:
        assert got.encode(text) == want.encode(text), text
    assert_same_arrays(got(texts, max_length=16), want(texts, max_length=16))


def test_siglip_ids_match_jax(tmp_path):
    pytest.importorskip("transformers")
    from transformers.convert_slow_tokenizer import import_protobuf
    proto = import_protobuf().ModelProto()
    for piece, score, kind in SIGLIP_PIECES:
        p = proto.pieces.add()
        p.piece, p.score, p.type = piece, score, kind
    proto.trainer_spec.model_type = 1   # unigram
    proto.trainer_spec.unk_id = 0
    path = tmp_path / "spiece.model"
    path.write_bytes(proto.SerializeToString())
    got = ttok.load_default_tokenizer(path, family="siglip")
    want = jtok.load_default_tokenizer(path, family="siglip")
    assert type(got).__name__ == type(want).__name__ == "SigLIPTokenizer"
    for text in TEXTS:
        assert got.encode(text) == want.encode(text), text
        assert got.decode(got.encode(text)) == want.decode(want.encode(text))
    assert_same_arrays(got(TEXTS, max_length=16), want(TEXTS, max_length=16))


def test_default_tokenizer_needs_a_vocabulary(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab_path"):
        ttok.load_default_tokenizer(None, family="wordpiece")


# --- transforms and datasets ---------------------------------------------------

def test_cv2_constants_are_cv2s():
    assert (ttf.INTER_NEAREST, ttf.INTER_CUBIC, ttf.BORDER_REPLICATE) == (
        cv2.INTER_NEAREST, cv2.INTER_CUBIC, cv2.BORDER_REPLICATE)
    assert (tdatasets.IMREAD_GRAYSCALE, tdatasets.IMREAD_COLOR,
            tdatasets.COLOR_BGR2RGB) == (
        cv2.IMREAD_GRAYSCALE, cv2.IMREAD_COLOR, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("kind", ["train", "eval"])
@pytest.mark.parametrize("on_device", [True, False])
def test_transforms_match_jax(kind, on_device):
    rng = np.random.default_rng(0)
    make = {"train": (ttf.train_transforms, jtf.train_transforms),
            "eval": (ttf.eval_transforms, jtf.eval_transforms)}[kind]
    got_tf, want_tf = (f(32, normalize_on_device=on_device) for f in make)
    for i in range(12):   # enough draws that every p=0.2 branch runs
        image = rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)
        mask = np.zeros((40 + i, 50), np.float32)
        mask[5:20, 10:30 + i] = 1.0
        got = got_tf(image, mask, np.random.default_rng((3, i)))
        want = want_tf(image, mask, np.random.default_rng((3, i)))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """The synthetic folder of tests/test_data.py: ten 48 x 64 images, masks
    and a task list with a fixed and a list-valued prompt."""
    root = tmp_path_factory.mktemp("ds")
    for sub in ("images", "masks", "anns"):
        (root / sub).mkdir()
    rng = np.random.default_rng(0)
    tasks = []
    for i in range(10):
        img = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
        mask = np.zeros((48, 64), np.uint8)
        mask[10:30, 20:40] = 255
        cv2.imwrite(str(root / "images" / f"img{i}.png"), img)
        cv2.imwrite(str(root / "masks" / f"m{i}.png"), mask)
        tasks.append({"img_name": f"img{i}.png", "mask_name": f"m{i}.png",
                      "prompts": {"p0": "polyp", "p1": ["a polyp", "the polyp"],
                                  "p2": "lesion"}})
    (root / "anns" / "train.json").write_text(json.dumps(tasks))
    return root


def _datasets(image_folder, merges_path, prompt_index, tf):
    out = []
    for mod, tokmod, tfmod in ((tdatasets, ttok, ttf), (jdatasets, jtok, jtf)):
        out.append(mod.ImageTextMaskDataset(
            image_dir=image_folder / "images", mask_dir=image_folder / "masks",
            task_path=image_folder / "anns" / "train.json",
            prompt_index=prompt_index, insert_stop_at_last=True,
            tokenizer=tokmod.CLIPTokenizer(merges_path), seed=4,
            transforms=getattr(tfmod, tf)(32, normalize_on_device=True)))
    return out


@pytest.mark.parametrize("prompt_index,tf", [(0, "eval_transforms"),
                                             (-1, "train_transforms"),
                                             (1, "train_transforms")])
def test_image_text_mask_dataset_matches_jax(image_folder, merges_path,
                                             prompt_index, tf):
    got, want = _datasets(image_folder, merges_path, prompt_index, tf)
    assert len(got) == len(want) == 10
    assert got.fixed_prompt() == want.fixed_prompt()
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g["image"].dtype == np.uint8 and g["image"].shape == (3, 32, 32)
        assert_same_arrays(g, w)


def test_image_dir_and_refcoco_datasets_match_jax(tmp_path, merges_path):
    (tmp_path / "images").mkdir()
    for cls in ("car", "road"):
        (tmp_path / "masks" / cls).mkdir(parents=True)
    rng = np.random.default_rng(1)
    records = []
    for i in range(3):
        cv2.imwrite(str(tmp_path / "images" / f"{i}.png"),
                    rng.integers(0, 256, (20, 24, 3), dtype=np.uint8))
        for cls in ("car", "road"):
            m = (rng.random((20, 24)) > 0.5).astype(np.uint8) * 255
            cv2.imwrite(str(tmp_path / "masks" / cls / f"{i}.png"), m)
        cv2.imwrite(str(tmp_path / "masks" / f"{i}-7-{i}.png"),
                    (rng.random((20, 24)) > 0.5).astype(np.uint8) * 255)
        records.append({"image_id": i, "image_name": f"{i}.png", "ann_id": 7,
                        "sent_id": i, "phrase": f"the left car {i}"})
    (tmp_path / "refcoco.json").write_text(json.dumps(records))
    pairs = []
    for mod, opmod, tokmod, tfmod in ((tdatasets, topen, ttok, ttf),
                                      (jdatasets, jopen, jtok, jtf)):
        tok = tokmod.CLIPTokenizer(merges_path)
        pairs.append((
            mod.ImageDirTextMaskDataset(
                image_dir=tmp_path / "images", mask_dir=tmp_path / "masks",
                insert_stop_at_last=True, tokenizer=tok,
                transforms=tfmod.eval_transforms(16)),
            opmod.RefCOCODataset(
                task_path=tmp_path / "refcoco.json",
                image_dir=tmp_path / "images", mask_dir=tmp_path / "masks",
                prompt_method="shuffle+", neg_prob=0.5, tokenizer=tok,
                transforms=tfmod.train_transforms(16, normalize_on_device=True))))
    for got, want in zip(*pairs):
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            assert_same_arrays(got[i], want[i])


# --- the loader ----------------------------------------------------------------

class _ListDataset:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[int(i)]


def _samples(n, prompts=1, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(3, 1000, size=(prompts, 10)).astype(np.int32)
    return [{"image": rng.integers(0, 256, (3, 8, 8), dtype=np.uint8),
             "mask": (rng.random((1, 8, 8)) > 0.5).astype(np.float32),
             "input_ids": rows[i % prompts],
             "attention_mask": np.ones(10, np.int32),
             "mask_name": f"{i}.png", "mask_shape": np.asarray([8, 8]),
             "prompt": f"p{i % prompts}"} for i in range(n)]


LOADER_CASES = {
    "shuffle": dict(shuffle=True, seed=7),
    "shuffle, other seed": dict(shuffle=True, seed=123),
    "in order, padded last batch": dict(),
    "drop_last": dict(shuffle=True, seed=7, drop_last=True),
    "text_dedup": dict(shuffle=True, seed=3, text_dedup=2),
    "shard 1 of 3": dict(shuffle=True, seed=7, num_shards=3, shard_index=1),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match_jax(case):
    kw = LOADER_CASES[case]
    ds = _ListDataset(_samples(21, prompts=2))
    got = tpipeline.DataLoader(ds, 4, num_workers=3, **kw)
    want = jpipeline.DataLoader(ds, 4, num_workers=3, **kw)
    assert len(got) == len(want)
    for epoch, start in ((0, 0), (1, 0), (1, 2), (2, 5)):
        got.set_epoch(epoch, start)
        want.set_epoch(epoch, start)
        np.testing.assert_array_equal(got._order(), want._order())
        g, w = list(got), list(want)
        assert len(g) == len(w) == max(len(want) - start, 0)
        for gb, wb in zip(g, w):
            assert_same_arrays(gb, wb)
    if case == "in order, padded last batch":
        assert w[-1]["valid"].tolist() == [1, 0, 0, 0]
    if case == "text_dedup":
        assert w[0]["input_ids"].shape[0] == 2 and "text_index" in w[0]


def test_loader_surfaces_worker_errors_and_stops_early():
    class Broken(_ListDataset):
        def __getitem__(self, i):
            if int(i) == 6:
                raise OSError("unreadable sample")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="unreadable"):
        list(tpipeline.DataLoader(Broken(_samples(12)), 4, num_workers=2))
    loader = tpipeline.DataLoader(_ListDataset(_samples(40)), 4, prefetch=1)
    first = next(iter(loader))      # the producer sees the consumer leave
    assert first["image"].shape == (4, 3, 8, 8)


def test_device_batch_strips_metadata_and_copies():
    batch = tpipeline.collate(_samples(3), 4, text_dedup=1)
    host = tpipeline.device_batch(batch)
    assert set(host) == {"image", "mask", "input_ids", "attention_mask",
                         "valid", "text_index"}
    assert all(isinstance(v, np.ndarray) for v in host.values())
    assert_same_arrays(host, jpipeline.device_batch(
        jpipeline.collate(_samples(3), 4, text_dedup=1)))
    on_cpu = tpipeline.device_batch(batch, "cpu")
    for k, v in on_cpu.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), host[k])


# --- loggers ----------------------------------------------------------------------

def test_metric_files_match_jax_logger(tmp_path):
    records = [({"loss": 1.25, "dice": 0.5}, 1, "train_"),
               ({"loss": 1.0, "val_iou": 0.4}, 2, "train_"),
               ({"epoch": 0, "val_dice": np.float32(0.25)}, 2, "")]
    for mod, out in ((tlogging, tmp_path / "t"), (jlogging, tmp_path / "j")):
        ml = mod.MultiLogger(out, backends=("jsonl", "csv", "mlflow"))
        for metrics, step, prefix in records:
            ml.log(metrics, step, prefix=prefix)
        ml.log_hyperparams({"model": {"strategy": "coop"}}, {"n": 3})
        ml.close()

    def strip(path):
        return [{k: v for k, v in json.loads(line).items() if k != "wall_s"}
                for line in path.read_text().splitlines()]

    assert strip(tmp_path / "t" / "metrics.jsonl") == strip(
        tmp_path / "j" / "metrics.jsonl")
    for name in ("metrics.csv", "hparams.json"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text())


def test_log_images_writes_pngs_cv2_reads(tmp_path):
    ml = tlogging.MultiLogger(tmp_path, backends=("jsonl",))
    gray = np.linspace(0, 1, 6 * 5).reshape(6, 5)
    rgb = np.random.default_rng(0).integers(0, 256, (7, 3, 3), dtype=np.uint8)
    ml.log_images("panel", [gray, rgb], step=4, captions=["g", "c"])
    rec = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    assert rec["tag"] == "panel" and rec["captions"] == ["g", "c"]
    want_gray = (gray * 255).astype(np.uint8)
    for path, want in zip(rec["images"], (np.repeat(want_gray[..., None], 3, -1),
                                          rgb)):
        got = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]   # BGR -> RGB
        np.testing.assert_array_equal(got, want)

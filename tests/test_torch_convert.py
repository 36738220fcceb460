"""The port's checkpoint layer against the JAX package's converters, on the
CPU.

Trees: each converter of `tunevlseg_torch/convert/` gives the JAX
converter's tree on the same numpy state dict, path for path, bit for bit
(HF CLIPSeg with the plain and the rd64-refined head, the reference's
wrapper under each strategy, OpenAI's RN and whole CRIS, HF CLIP / SigLIP
and the reference's TransformerSegmentor, FreeSOLO, BiomedCLIP, DenseCLIP).
Forwards: the port on `state_dict_from_jax` of its own tree against the JAX
forward on the JAX tree (f32 logits within `LOGIT_TOL` of the largest
|reference|), and CLIPSeg against the HF model itself in f64 (`HF_TOL`).
Full-width coverage: names and shapes only, on zero-stride views of the
real key sets and models on the meta device: every key is read or named
ignorable, every port tensor is filled or named, and what the model does not
build is named elidable. Then the readers (the safetensors format,
TorchScript, Lightning, prefixes), the train / eval CLIs with
`pretrained_checkpoint`, and zero-shot RIS with `solo_checkpoint` and
`clip_checkpoint`.

Source state dicts at tiny widths come from transformers' classes at tiny
configurations, the torch stub of BiomedCLIP, or a real key set shrunk to a
tiny port model (`shrink`: the converter's own reads define which keys and
the port model's shapes their tiny shapes), drawn from seeded numpy
generators."""
import dataclasses
import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

from tunevlseg_tpu.convert import biomed_clip as jbiomed_conv  # noqa: E402
from tunevlseg_tpu.convert import clipseg as jclipseg_conv  # noqa: E402
from tunevlseg_tpu.convert import cris as jcris_conv  # noqa: E402
from tunevlseg_tpu.convert import denseclip as jdense_conv  # noqa: E402
from tunevlseg_tpu.convert import solov2 as jsolo_conv  # noqa: E402
from tunevlseg_tpu.convert import trans_segmentor as jts_conv  # noqa: E402
from tunevlseg_tpu.models import presets as jpresets  # noqa: E402
from tunevlseg_tpu.models.clip import config as jclip_config  # noqa: E402
from tunevlseg_tpu.models.cris import model as jcris  # noqa: E402
from tunevlseg_tpu.training.task import SegmentationTask as JTask  # noqa: E402
from tunevlseg_torch.convert import biomed_clip as biomed_conv  # noqa: E402
from tunevlseg_torch.convert import checkpoint_io as cio  # noqa: E402
from tunevlseg_torch.convert import clipseg as clipseg_conv  # noqa: E402
from tunevlseg_torch.convert import coverage as cov  # noqa: E402
from tunevlseg_torch.convert import cris as cris_conv  # noqa: E402
from tunevlseg_torch.convert import denseclip as dense_conv  # noqa: E402
from tunevlseg_torch.convert import solov2 as solo_conv  # noqa: E402
from tunevlseg_torch.convert import trans_segmentor as ts_conv  # noqa: E402
from tunevlseg_torch.convert.from_jax import (flatten_params,  # noqa: E402
                                              state_dict_from_jax)
from tunevlseg_torch.models import presets as tpresets  # noqa: E402
from tunevlseg_torch.models.clip.config import CLIPSegConfig  # noqa: E402
from tunevlseg_torch.models.clipseg.model import CLIPSegForSegmentation  # noqa: E402
from tunevlseg_torch.models.cris.model import (CRISConfig,  # noqa: E402
                                               CRISForSegmentation)
from tunevlseg_torch.models.denseclip.model import DenseCLIPConfig  # noqa: E402
from tunevlseg_torch.models.solov2.model import SOLOv2, SOLOv2Config  # noqa: E402
from tunevlseg_torch.models.trans_segmentor.model import (  # noqa: E402
    TransformerSegmentor, TransSegmentorConfig)
from tunevlseg_torch.models.zero_shot_ris.biomed_clip import (  # noqa: E402
    BiomedCLIP, BiomedCLIPConfig)
from tunevlseg_torch.models.zero_shot_ris.model import MaskedCLIP  # noqa: E402
from tunevlseg_torch.training.task import SegmentationTask as TTask  # noqa: E402

from chip_smoke import write_torchscript  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# f32 logits through ~10 layers in another summation order (as
# tests/test_torch_clipseg.py); the HF model in f64 against the port in f32
# (as scripts/validate_pretrained.py)
LOGIT_TOL = 1e-4
HF_TOL = 5e-3
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread: the tiny models run many small ops, whose OpenMP
    teams otherwise wait on descheduled threads beside the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- helpers --------------------------------------------------------------------

def assert_same_tree(got, want):
    """The same paths, dtypes and shapes, bit-identical values."""
    g, w = flatten_params(got), flatten_params(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))[:6]
    for path in w:
        a, b = np.asarray(g[path]), np.asarray(w[path])
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def random_state_dict(listing, seed: int) -> dict[str, np.ndarray]:
    """numpy f32 tensors of `listing`'s shapes at an initialisation's scale
    (norm weights 1 +- 0.1, variances in [0.5, 1.5], else N(0, 0.02) except
    weight matrices at 1/sqrt(fan_in)); scalars as 0-d arrays."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in listing.items():
        shape = tuple(shape)
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(".weight") and len(shape) == 1:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2 and key.endswith(("weight", "proj")):
            v = rng.normal(size=shape) / math.sqrt(math.prod(shape[1:]))
        else:
            v = rng.normal(0.0, 0.02, shape)
        out[key] = np.asarray(v, np.float32)
    return out


def to_torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def meta_shapes(module_fn):
    with torch.device("meta"):
        module = module_fn()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def shrink(listing, convert, own_shapes: dict) -> dict[str, tuple]:
    """`listing` (a real key set) cut to a tiny port model: the keys
    `convert` reads from it (its loops run at the tiny config), each with
    the shape that gives the port model's tensor its `own_shapes` shape by
    the documented transform; unread keys dropped, except 0-d ones (counters
    a converter skips)."""
    sd = cio.TrackingDict(cov.shape_state_dict(listing))
    tree = convert(sd)
    full = cov.port_shapes(tree)
    tiny = {}
    for name, key in cov.sources(tree, sd).items():
        fs, fp, tp = tuple(listing[key]), full[name], own_shapes[name]
        if fs == fp:
            shape = tp
        elif len(fs) == 4 and len(fp) == 2:                 # patch embedding
            p = math.isqrt(tp[0] // fs[1])
            shape = (tp[1], fs[1], p, p)
        elif fs[0] == 3 * fp[0] and fs[1:] == fp[1:]:       # packed q / k / v
            shape = (3 * tp[0],) + tp[1:]
        else:                                               # reshape
            shape = (1,) * (len(fs) - len(fp)) + tp
        assert tiny.setdefault(key, shape) == shape, key
    return {k: tiny.get(k, ()) for k in listing if k in tiny or not listing[k]}


def _jcfg(cfg):
    """The JAX config dataclass of the port's `cfg` (same name and fields)."""
    import tunevlseg_tpu.models.solov2.model as jsolo
    import tunevlseg_tpu.models.trans_segmentor.model as jts
    import tunevlseg_tpu.models.zero_shot_ris.biomed_clip as jbc
    name = type(cfg).__name__
    cls = next(getattr(m, name) for m in (jclip_config, jcris, jsolo, jts, jbc)
               if hasattr(m, name))
    return cls(**{k: _jcfg(v) if dataclasses.is_dataclass(v) else v
                  for k, v in vars(cfg).items()})


def _close(got, want, tol=LOGIT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


# --- sources at tiny widths --------------------------------------------------------

def hf_clipseg_config(cfg: CLIPSegConfig, complex_head: bool):
    """transformers' CLIPSegConfig of the port's config (eager attention)."""
    t, v = cfg.text, cfg.vision
    hf = transformers.CLIPSegConfig(
        text_config=dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                         num_hidden_layers=t.num_layers,
                         num_attention_heads=t.num_heads,
                         intermediate_size=t.intermediate_size,
                         max_position_embeddings=t.max_position_embeddings,
                         eos_token_id=t.eos_token_id),
        vision_config=dict(hidden_size=v.hidden_size, num_hidden_layers=v.num_layers,
                           num_attention_heads=v.num_heads,
                           intermediate_size=v.intermediate_size,
                           patch_size=v.patch_size, image_size=v.image_size),
        projection_dim=cfg.projection_dim, reduce_dim=cfg.reduce_dim,
        extract_layers=list(cfg.extract_layers),
        decoder_num_attention_heads=cfg.decoder_num_heads,
        decoder_intermediate_size=cfg.decoder_intermediate_size,
        conditional_layer=cfg.conditional_layer,
        use_complex_transposed_convolution=complex_head)
    hf._attn_implementation = "eager"
    return hf


@functools.lru_cache(maxsize=None)
def hf_clipseg(complex_head: bool, cfg: CLIPSegConfig = CLIPSegConfig.tiny()):
    """A tiny HF CLIPSeg (f32, seeded) and its numpy state dict."""
    torch.manual_seed(0)
    hf = transformers.CLIPSegForImageSegmentation(
        hf_clipseg_config(cfg, complex_head)).eval()
    return hf, cio.to_numpy(hf.state_dict())


def tiny_rn(seed=3) -> dict[str, np.ndarray]:
    """OpenAI's RN50 key set shrunk to `CRISConfig.tiny()`."""
    listing = shrink(cov.read_keyset("clip_rn50"),
                     lambda sd: cov.merged(cris_conv.convert_cris(sd, CRISConfig.tiny())),
                     meta_shapes(lambda: CRISForSegmentation(CRISConfig.tiny())))
    sd = random_state_dict(listing, seed)
    sd.update((k, np.zeros((), np.int64)) for k in listing if not listing[k])
    return sd


def tiny_solo_cfg() -> SOLOv2Config:
    from tunevlseg_torch.eval_zeroshot import ris_configs
    return ris_configs({"model": {}, "tiny_model": True})[1]


def tiny_freesolo(seed=4) -> dict[str, np.ndarray]:
    """FreeSOLO R101's key set shrunk to the zero-shot CLI's tiny SOLOv2."""
    cfg = tiny_solo_cfg()
    listing = shrink(cov.read_keyset("freesolo_r101"),
                     lambda sd: solo_conv.convert_solov2(sd, cfg),
                     meta_shapes(lambda: SOLOv2(cfg)))
    sd = random_state_dict(listing, seed)
    sd["_iter"] = np.asarray(30000, np.int64)
    return sd


def learner_keys(strategy: str, depth=2, n_ctx=4, d=16, dv=24) -> dict:
    """The reference's `context_learner.*` keys of a strategy (tiny widths):
    MLP projections as Sequential [Linear, ReLU, Linear, LayerNorm], a bare
    Linear for the shared learner's visual side, TransformerEncoderLayers
    for shared_attn."""
    out = {"context_learner.context_vectors": (depth, n_ctx, d)}
    p = "context_learner"
    for i in range(depth):
        if strategy in ("cocoop", "maple"):
            for j, shape in ((0, (8, d)), (2, (dv, 8)), (3, (dv,))):
                out[f"{p}.projection_layers.{i}.{j}.weight"] = shape
                out[f"{p}.projection_layers.{i}.{j}.bias"] = shape[:1]
        elif strategy == "shared_separate":
            for j, shape in ((0, (8, d)), (2, (d, 8)), (3, (d,))):
                out[f"{p}.textual_projection_layers.{i}.{j}.weight"] = shape
                out[f"{p}.textual_projection_layers.{i}.{j}.bias"] = shape[:1]
            out[f"{p}.visual_projection_layers.{i}.weight"] = (dv, d)
            out[f"{p}.visual_projection_layers.{i}.bias"] = (dv,)
        elif strategy == "shared_attn":
            q = f"{p}.projection_layers.{i}"
            out.update({f"{q}.self_attn.in_proj_weight": (3 * d, d),
                        f"{q}.self_attn.in_proj_bias": (3 * d,),
                        f"{q}.self_attn.out_proj.weight": (d, d),
                        f"{q}.self_attn.out_proj.bias": (d,),
                        f"{q}.linear1.weight": (8, d), f"{q}.linear1.bias": (8,),
                        f"{q}.linear2.weight": (d, 8), f"{q}.linear2.bias": (d,),
                        f"{q}.norm1.weight": (d,), f"{q}.norm1.bias": (d,),
                        f"{q}.norm2.weight": (d,), f"{q}.norm2.bias": (d,)})
    return out


def cris_head_keys(d=8, layers=2) -> dict:
    """The reference CRIS head's keys (neck, decoder, projector) at width d."""
    out = {}

    def bn(p):
        out.update({f"{p}.weight": (d,), f"{p}.bias": (d,),
                    f"{p}.running_mean": (d,), f"{p}.running_var": (d,),
                    f"{p}.num_batches_tracked": ()})

    def conv_bn(p):
        out[f"{p}.0.weight"] = (d, d, 1, 1)
        bn(f"{p}.1")

    def mha(p):
        out.update({f"{p}.in_proj_weight": (3 * d, d), f"{p}.in_proj_bias": (3 * d,),
                    f"{p}.out_proj.weight": (d, d), f"{p}.out_proj.bias": (d,)})

    for name in ("f1_v_proj", "f2_v_proj", "f2_cat", "f3_v_proj", "f3_cat",
                 "f4_proj5", "f4_proj4", "f4_proj3", "aggr"):
        conv_bn(f"neck.{name}")
    out.update({"neck.txt_proj.0.weight": (d, d), "neck.txt_proj.0.bias": (d,)})
    bn("neck.txt_proj.1")
    bn("neck.norm_layer.0")
    conv_bn("neck.coordconv.0.conv1")
    conv_bn("neck.coordconv.1")
    for i in range(layers):
        p = f"decoder.layers.{i}"
        mha(f"{p}.self_attn")
        mha(f"{p}.multihead_attn")
        for n in ("self_attn_norm", "cross_attn_norm", "norm1", "norm2", "norm3",
                  "ffn.3"):
            out.update({f"{p}.{n}.weight": (d,), f"{p}.{n}.bias": (d,)})
        for n in ("ffn.0", "ffn.4"):
            out.update({f"{p}.{n}.weight": (d, d), f"{p}.{n}.bias": (d,)})
    out.update({"decoder.norm.weight": (d,), "decoder.norm.bias": (d,)})
    conv_bn("proj.vis.1")
    conv_bn("proj.vis.3")
    out.update({"proj.vis.4.weight": (d, d, 1, 1), "proj.vis.4.bias": (d,),
                "proj.txt.weight": (d, d), "proj.txt.bias": (d,),
                "additive_decoder_layer.0.weight": (4, d, 3, 3),
                "additive_decoder_layer.2.weight": (1, 4, 3, 3),
                "residual_ratio": ()})
    return out


class AutoStateDict(dict):
    """A state dict that makes a tensor for any key a converter reads (so
    every optional tensor it probes exists): packed in-projections (24, 8),
    other names (8, 8) or (8,). Run the JAX converter on it first, then the
    port's on a plain copy of what it made."""

    def __init__(self, seed: int):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def __missing__(self, key):
        shape = ((24, 8) if key.endswith("in_proj_weight") else
                 (24,) if key.endswith("in_proj_bias") else
                 (8, 8) if key.endswith(("weight", "proj", "embedding")) else (8,))
        self[key] = self.rng.normal(size=shape).astype(np.float32)
        return self[key]

    def __contains__(self, key):
        return True

    def get(self, key, default=None):
        return self[key]


# --- 1. trees ---------------------------------------------------------------------

@pytest.mark.parametrize("complex_head", [False, True], ids=["rd64", "refined"])
def test_hf_clipseg_tree_matches_jax(complex_head):
    hf, sd = hf_clipseg(complex_head)
    cfg = clipseg_conv.config_from_hf(hf.config)
    assert cfg == dataclasses.replace(CLIPSegConfig.tiny(),
                                      complex_transposed_convolution=complex_head)
    want = jclipseg_conv.convert_hf_clipseg(
        jclipseg_conv.torch_state_dict_to_numpy(hf.state_dict()),
        jclipseg_conv.config_from_hf(hf.config))
    assert_same_tree(clipseg_conv.convert_hf_clipseg(sd, cfg), want)
    if complex_head:
        assert {"head_conv", "head_up1", "head_up2"} <= set(want["decoder"])


def test_config_from_hf_reads_a_config_json():
    """config.json stores only what differs from transformers' defaults
    (`to_diff_dict`): the mapping gives the object's config."""
    hf_cfg = transformers.CLIPSegConfig(
        text_config=dict(eos_token_id=2), vision_config=dict(patch_size=16),
        use_complex_transposed_convolution=True)
    diff = json.loads(json.dumps(hf_cfg.to_diff_dict()))
    assert clipseg_conv.config_from_hf(diff) == clipseg_conv.config_from_hf(hf_cfg)
    assert clipseg_conv.config_from_hf(diff) == tpresets.clipseg_rd64_config(True)


STRATEGIES = ["coop", "cocoop", "vpt", "maple", "shared_separate", "shared_attn"]


def wrapper_state_dict(strategy: str, complex_head=True, seed=5) -> dict:
    """The reference wrapper's state dict: `model.*` (tiny HF CLIPSeg),
    `context_learner.*` of the strategy, the additive head, residual_ratio."""
    _, hf_sd = hf_clipseg(complex_head)
    extra = dict(learner_keys(strategy), residual_ratio=(),
                 **{"additive_decoder_layer.1.weight": (1, 8, 5, 5),
                    "additive_decoder_layer.1.bias": (1,)})
    sd = {f"model.{k}": v for k, v in hf_sd.items()}
    sd.update(random_state_dict(extra, seed))
    sd["residual_ratio"] = np.asarray(0.5, np.float32)
    return sd


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_reference_wrapper_tree_matches_jax(strategy):
    sd = wrapper_state_dict(strategy)
    cfg = dataclasses.replace(CLIPSegConfig.tiny(), complex_transposed_convolution=True)
    want = jclipseg_conv.convert_reference_wrapper(sd, _jcfg(cfg), strategy)
    got = clipseg_conv.convert_reference_wrapper(sd, cfg, strategy)
    assert_same_tree(got, want)
    assert "learner" in got and "additive_head" in got and "residual_ratio" in got


def test_cris_trees_match_jax_from_torchscript_and_lightning(tmp_path):
    """OpenAI's RN layout as a TorchScript archive, and the whole CRIS
    (`backbone.*`, neck, decoder, projector, CoOp learner, additive head) as
    a Lightning checkpoint with `model.` prefixes: the same trees, params
    and batch_stats, through both packages' `load_cris_checkpoint`."""
    rn = tiny_rn()
    archive = tmp_path / "RN50.pt"
    write_torchscript(archive, to_torch(rn))
    cfg = CRISConfig.tiny()
    want = jcris_conv.load_cris_checkpoint(str(archive), _jcfg(cfg), "coop")
    got = cris_conv.load_cris_checkpoint(archive, cfg, "coop")
    assert_same_tree(got, want)
    assert got["batch_stats"]["visual"]["bn1"]["running_var"].min() >= 0.5

    whole = {f"backbone.{k}": v for k, v in rn.items()}
    whole.update(random_state_dict({**cris_head_keys(), **learner_keys("coop")}, 6))
    ckpt = tmp_path / "cris.ckpt"
    torch.save({"state_dict": {f"model.{k}": torch.as_tensor(v)
                               for k, v in whole.items()}, "epoch": 3}, ckpt)
    want = jcris_conv.load_cris_checkpoint(str(ckpt), _jcfg(cfg), "coop")
    got = cris_conv.load_cris_checkpoint(ckpt, cfg, "coop")
    assert_same_tree(got, want)
    assert {"neck", "decoder", "proj", "learner", "additive_conv1",
            "residual_ratio"} <= set(got["params"])


def hf_siglip(seed=7):
    cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=49408, hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=32,
                         max_position_embeddings=77),
        vision_config=dict(hidden_size=24, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=48,
                           patch_size=16, image_size=32))
    cfg._attn_implementation = "eager"
    torch.manual_seed(seed)
    return transformers.SiglipModel(cfg).eval()


def hf_clip(seed=8):
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=49408, hidden_size=16, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=32),
        vision_config=dict(hidden_size=24, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=48,
                           patch_size=16, image_size=32),
        projection_dim=20)
    torch.manual_seed(seed)
    return transformers.CLIPModel(cfg).eval()


def reference_segmentor(cfg: TransSegmentorConfig, encoder, seed=9) -> dict:
    """The reference TransformerSegmentor's state dict: `encoder.model.*`,
    torch's TransformerDecoder, the upsampler's [Upsample, Conv2d,
    LayerNorm, act] blocks."""
    sd = {f"encoder.model.{k}": v for k, v in cio.to_numpy(encoder.state_dict()).items()}
    d = cfg.effective_projection_dim
    layer = torch.nn.TransformerDecoderLayer(d, cfg.decoder_num_heads,
                                             cfg.decoder_dim_feedforward,
                                             batch_first=True, norm_first=True)
    dec = torch.nn.TransformerDecoder(layer, cfg.decoder_num_layers,
                                      norm=torch.nn.LayerNorm(d))
    sd.update({f"decoder.transformer_decoder.{k}": v
               for k, v in cio.to_numpy(dec.state_dict()).items()})
    up = {}
    n = cfg.num_upsampler_layers
    for i in range(n):
        up[f"decoder.upsampler.{i}.1.weight"] = (4, 4, 3, 3)
        up[f"decoder.upsampler.{i}.1.bias"] = (4,)
        if i < n - 1:
            up[f"decoder.upsampler.{i}.2.weight"] = (4, 8, 8)
            up[f"decoder.upsampler.{i}.2.bias"] = (4, 8, 8)
    sd.update(random_state_dict(up, seed))
    return sd


@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_trans_segmentor_trees_match_jax(family):
    """A bare CLIPModel / SiglipModel, and the reference's whole
    TransformerSegmentor around it."""
    cfg = TransSegmentorConfig.tiny(encoder_family=family)
    encoder = hf_clip() if family == "clip" else hf_siglip()
    bare = cio.to_numpy(encoder.state_dict())
    jt = jts_conv._Tree()
    (jts_conv.convert_hf_siglip_model if family == "siglip"
     else jts_conv.convert_hf_clip_model)(bare, _jcfg(cfg), jt)
    assert_same_tree(ts_conv.convert_encoder(bare, cfg), jt)
    whole = reference_segmentor(cfg, encoder)
    assert_same_tree(ts_conv.convert_trans_segmentor(whole, cfg),
                     jts_conv.convert_trans_segmentor(whole, _jcfg(cfg)))


def test_freesolo_tree_matches_jax(tmp_path):
    """detectron2's payload (`{"model": sd}`) through both loaders."""
    path = tmp_path / "FreeSOLO.pt"
    torch.save({"model": to_torch(tiny_freesolo()), "iteration": 30000}, path)
    cfg = tiny_solo_cfg()
    assert_same_tree(solo_conv.load_freesolo_checkpoint(path, cfg),
                     jsolo_conv.load_freesolo_checkpoint(str(path), _jcfg(cfg)))


def biomed_stub(cfg: BiomedCLIPConfig, seed=10):
    from tests.test_biomed_clip import _StubCLIP
    torch.manual_seed(seed)
    return _StubCLIP(cfg).eval()


def test_biomed_clip_tree_matches_jax(tmp_path):
    stub = biomed_stub(BiomedCLIPConfig.tiny())
    path = tmp_path / "biomedclip.bin"
    torch.save({f"module.{k}": v for k, v in stub.state_dict().items()}, path)
    cfg = BiomedCLIPConfig.tiny()
    assert_same_tree(biomed_conv.load_biomedclip_checkpoint(path, cfg),
                     jbiomed_conv.load_biomedclip_checkpoint(str(path), _jcfg(cfg)))


@pytest.mark.parametrize("fn,cfg", [
    ("convert_backbone", DenseCLIPConfig.tiny()),
    ("convert_text_encoder", DenseCLIPConfig.tiny()),
    ("convert_context_decoder", DenseCLIPConfig.tiny()),
    ("convert_vit_backbone", DenseCLIPConfig.tiny_vit()),
    ("convert_vit_backbone", dataclasses.replace(DenseCLIPConfig.tiny_vit(),
                                                 patch_size=8))])
def test_denseclip_trees_match_jax(fn, cfg):
    source = AutoStateDict(seed=11)
    want = getattr(jdense_conv, fn)(source, _jcfg_dense(cfg), prefix="m.")
    got = getattr(dense_conv, fn)(dict(source), cfg, prefix="m.")
    assert_same_tree(got, want)


def _jcfg_dense(cfg):
    from tunevlseg_tpu.models.denseclip import model as jdense
    return jdense.DenseCLIPConfig(**vars(cfg))


# --- 2. forwards on converted weights ---------------------------------------------

def clipseg_batch(seed=0, b=2, img=64, rows=2, pad=49407):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, size=(rows, 12)).astype(np.int32)
    ids[:, 0] = 49406
    ids[:, 9], ids[:, 10:] = 49407, pad
    return {"image": rng.integers(0, 256, (b, 3, img, img), dtype=np.uint8),
            "mask": (rng.random((b, 1, img, img)) > 0.5).astype(np.float32),
            "input_ids": ids, "attention_mask": (np.arange(12) <= 9)[None]
            .repeat(rows, 0).astype(np.int32),
            "valid": np.ones(b, np.float32),
            "text_index": (np.arange(b) % rows).astype(np.int32)}


def _fill(shapes, seed: int):
    """A JAX tree of `shapes` (from `jax.eval_shape`) filled from a seeded
    numpy generator at an initialisation's scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("scale",) or (name == "weight" and len(shape) == 1):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "weight":
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif name in ("kernel", "patch_proj"):
            v = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            v = rng.normal(0.0, 0.02, shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _overlay(base, tree):
    """`tree`'s leaves over `base` where `base` has the place (the JAX task's
    merge: checkpoint tensors its model elides are dropped)."""
    if not tree:
        return base
    return {k: (_overlay(v, tree.get(k, {})) if isinstance(v, dict)
                else np.asarray(tree.get(k, v))) for k, v in base.items()}


def jax_pair_forward(jtask, batch, tree, batch_stats=None, seed=20):
    """(the JAX forward, jitted, with `tree` over a random init, that random
    init's params and stats): the random init stands for the parts a
    checkpoint does not hold, in both packages."""
    image = jnp.zeros(batch["image"].shape, jnp.float32)
    shapes = jax.eval_shape(jtask.model.init, KEY, batch["input_ids"], image,
                            batch.get("attention_mask"),
                            **jtask._model_kwargs(batch))
    random = _fill(dict(shapes), seed)
    params = _overlay(random["params"], tree)
    extras = ({"batch_stats": _overlay(random["batch_stats"], batch_stats)}
              if "batch_stats" in random else {})
    want = jax.jit(jtask._forward)(params, extras, batch)
    return np.asarray(want), random["params"], random.get("batch_stats")


def port_forward(model, spec, batch, random_params, random_stats, loaded,
                 elidable):
    """The port on JAX's random init, with the converted checkpoint overlaid
    through `SegmentationTask.init` (the CLI's load path)."""
    model.load_state_dict(state_dict_from_jax(random_params, model, random_stats))
    task = TTask(model, spec)
    task.init(params=loaded["params"], variables={"batch_stats": loaded.get(
        "batch_stats", {})}, elidable=elidable)
    with torch.no_grad():
        return task._forward({k: torch.from_numpy(v) for k, v in batch.items()})


def test_clipseg_coop_refined_forward_matches_jax():
    """The reference wrapper (CoOp learner, refined head, additive head the
    CoOp model does not build) converted by each package: the same logits."""
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    cfg = dataclasses.replace(CLIPSegConfig.tiny(), complex_transposed_convolution=True)
    sd = wrapper_state_dict("coop")
    batch = clipseg_batch()
    jm, jspec = jpresets.build_clipseg("coop", prompt_depth=2, num_context=4,
                                       config=_jcfg(cfg))
    want, rparams, _ = jax_pair_forward(
        JTask(jm, jspec), batch,
        jclipseg_conv.convert_reference_wrapper(sd, _jcfg(cfg), "coop"))
    model, spec = tpresets.build_clipseg("coop", prompt_depth=2, num_context=4,
                                         config=cfg, device="cpu")
    tree = clipseg_conv.load_checkpoint_params(None, cfg, "coop", sd=sd)
    got = port_forward(model, spec, batch, rparams, None,
                       {"params": tensors_from_jax(tree)},
                       clipseg_conv.CLIPSEG_ELIDABLE)
    assert got.shape == (2, 1, 64, 64)
    _close(got, want)
    np.testing.assert_array_equal(model.learner.context_vectors.detach().numpy(),
                                  sd["context_learner.context_vectors"])


@pytest.mark.parametrize("complex_head", [False, True], ids=["rd64", "refined"])
def test_clipseg_matches_the_hf_model_in_f64(complex_head):
    """The stock port model on the converted HF weights against the HF model
    itself, run in f64."""
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    hf, sd = hf_clipseg(complex_head)
    cfg = clipseg_conv.config_from_hf(hf.config)
    model, spec = tpresets.build_clipseg(None, config=cfg, device="cpu")
    TTask(model, spec).init(params=tensors_from_jax(
        clipseg_conv.convert_hf_clipseg(sd, cfg)), elidable=clipseg_conv.CLIPSEG_ELIDABLE)
    batch = clipseg_batch(img=32, b=2, rows=2)
    pix = np.random.default_rng(3).normal(size=(2, 3, 32, 32)).astype(np.float32)
    ids, am = batch["input_ids"], batch["attention_mask"]
    ref_model = transformers.CLIPSegForImageSegmentation(hf.config).double().eval()
    ref_model.load_state_dict(hf.state_dict())
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with torch.no_grad():
            ref = ref_model(input_ids=torch.from_numpy(ids.astype(np.int64)),
                            pixel_values=torch.from_numpy(pix).double(),
                            attention_mask=torch.from_numpy(am.astype(np.int64))
                            ).logits.numpy()
    finally:
        torch.set_default_dtype(prev)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(pix),
                    torch.from_numpy(am))
    err = float(np.abs(got[:, 0].numpy() - ref).max())
    assert err < HF_TOL, err


@pytest.fixture(scope="module")
def cris_jax(tmp_path_factory):
    """OpenAI's RN layout as a TorchScript archive, and the JAX CRIS CoOp
    forward on it: (archive, config, batch, JAX logits, random params and
    stats)."""
    archive = tmp_path_factory.mktemp("rn") / "RN50.pt"
    write_torchscript(archive, to_torch(tiny_rn()))
    cfg = CRISConfig.tiny(img_size=64)
    batch = clipseg_batch(pad=0)
    jm, jspec = jpresets.build_cris("coop", prompt_depth=2, num_context=4,
                                    config=_jcfg(cfg))
    jtrees = jcris_conv.load_cris_checkpoint(str(archive), _jcfg(cfg), "coop")
    return (archive, cfg, batch) + jax_pair_forward(
        JTask(jm, jspec), batch, jtrees["params"], jtrees["batch_stats"])


@pytest.mark.parametrize("layout", ["nchw", "flat"])
def test_cris_coop_forward_matches_jax(layout, cris_jax):
    """OpenAI's RN layout under CRIS CoOp: the port on either backbone
    layout (flat: K4's plain version here) against the JAX model; the
    BatchNorm statistics come from the checkpoint."""
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    archive, cfg, batch, want, rparams, rstats = cris_jax
    trees = cris_conv.load_cris_checkpoint(archive, cfg, "coop")
    model, spec = tpresets.build_cris("coop", prompt_depth=2, num_context=4,
                                      config=cfg, layout=layout, device="cpu")
    got = port_forward(model, spec, batch, rparams, rstats,
                       {k: tensors_from_jax(v) for k, v in trees.items()},
                       cris_conv.CRIS_ELIDABLE)
    _close(got, want)
    np.testing.assert_array_equal(
        model.visual.layer2[0].bn1.running_var.numpy(),
        trees["batch_stats"]["visual"]["layer2_0"]["bn1"]["running_var"])


def test_phrasecut_siglip_forward_matches_jax():
    """A bare SiglipModel under the PhraseCut TransformerSegmentor (existing
    projections, frozen towers, output bias): its vision head dropped by
    the named rule, the same logits."""
    from tunevlseg_tpu.models.trans_segmentor.model import TransformerSegmentor as JTS
    from tunevlseg_tpu.training.optim import FreezeSpec
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    cfg = TransSegmentorConfig.tiny(encoder_family="siglip", use_existing_proj=True,
                                    output_bias=-1.748104048321891)
    bare = cio.to_numpy(hf_siglip().state_dict())
    jt = jts_conv._Tree()
    jts_conv.convert_hf_siglip_model(bare, _jcfg(cfg), jt)
    batch = clipseg_batch(img=32, pad=1)
    jtask = JTask(JTS(_jcfg(cfg)), FreezeSpec(freeze_all=False, freeze_encoder=True,
                                              family="trans_segmentor"))
    want, rparams, _ = jax_pair_forward(jtask, batch, dict(jt))
    model, spec = tpresets.build_trans_segmentor(cfg, freeze_encoders=True,
                                                 device="cpu")
    got = port_forward(model, spec, batch, rparams, None,
                       {"params": tensors_from_jax(ts_conv.convert_encoder(bare, cfg))},
                       ts_conv.TRANS_SEGMENTOR_ELIDABLE)
    _close(got, want)


def ris_clip_cfg() -> CLIPSegConfig:
    from tunevlseg_torch.eval_zeroshot import ris_configs
    return ris_configs({"model": {}, "tiny_model": True})[0]


def test_masked_clip_features_match_jax():
    """A CLIPSeg-layout file's towers and projections in MaskedCLIP (the
    decoder dropped by the named rule): image features, masked image
    features and text features against the JAX MaskedCLIP."""
    from tunevlseg_tpu.models.zero_shot_ris.model import MaskedCLIP as JMaskedCLIP
    from tunevlseg_torch.eval_zeroshot import load_converted
    cfg = ris_clip_cfg()
    _, sd = hf_clipseg(False, cfg)
    jtree = jclipseg_conv.convert_hf_clipseg(sd, _jcfg(cfg))
    clip = load_converted(MaskedCLIP(cfg), clipseg_conv.convert_hf_clipseg(sd, cfg),
                          clipseg_conv.MASKED_CLIP_ELIDABLE).eval()
    jm = JMaskedCLIP(_jcfg(cfg))
    rng = np.random.default_rng(4)
    pix = rng.normal(size=(3, 3, 32, 32)).astype(np.float32)
    masks = (rng.random((3, 4, 4)) > 0.4).astype(np.float32)
    ids = clipseg_batch()["input_ids"]
    am = (ids != 49407).astype(np.int32)
    am[:, 9] = 1
    params = {"params": {k: v for k, v in jtree.items() if k != "decoder"}}
    image = functools.partial(jm.apply, method=jm.get_image_features)
    want_masked = jax.jit(image, static_argnums=3)(
        params, jnp.asarray(pix), jnp.asarray(masks), -1)
    want_text = jm.apply(params, jnp.asarray(ids), jnp.asarray(am),
                         method=jm.get_text_features)
    with torch.no_grad():
        got_masked = clip.get_image_features(torch.from_numpy(pix),
                                             torch.from_numpy(masks), -1)
        got_text = clip.get_text_features(torch.from_numpy(ids), torch.from_numpy(am))
    _close(got_masked, want_masked)
    _close(got_text, want_text)


# --- 3. full-width key coverage (names and shapes) ---------------------------------

def coverage(keyset: str, convert, module_fn, ignored, elidable, fresh=()):
    """The real key set `keyset` through `convert` into the port module of
    `module_fn` (built on meta): every key read or ignorable by `ignored`
    suffixes, every tensor the module lacks under `elidable`, every module
    tensor filled or under the `fresh` prefixes (what the checkpoint does
    not hold), the shapes equal."""
    sd = cio.TrackingDict(cov.shape_state_dict(cov.read_keyset(keyset)))
    tree = convert(sd)
    got = cov.port_shapes(tree)
    own = meta_shapes(module_fn)
    assert cov.unread_keys(tree, sd, ignored) == []
    assert [k for k in got if k not in own and not k.startswith(elidable)] == []
    assert [k for k in own if k not in got and not k.startswith(fresh)] == []
    assert {k: s for k, s in got.items() if k in own and own[k] != s} == {}
    return sd, got, own


def test_clipseg_rd64_refined_covers_the_coop_model_and_masked_clip():
    from tunevlseg_torch.models.prompt.learners import CoOpLearner
    cfg = tpresets.clipseg_rd64_config(complex_head=True)

    def coop():
        learner = CoOpLearner(prompt_depth=3, num_context=4,
                              context_dim=cfg.text.hidden_size)
        return CLIPSegForSegmentation(cfg, learner=learner)
    sd, got, own = coverage(
        "clipseg_rd64_refined", lambda sd: clipseg_conv.convert_hf_clipseg(sd, cfg),
        coop, clipseg_conv.CLIPSEG_IGNORED, clipseg_conv.CLIPSEG_ELIDABLE,
        fresh=("learner.", "residual_ratio"))
    assert "decoder.head_up1.weight" in own
    assert "vision_model.layers.10.mlp.fc1.weight" in set(got) - set(own)
    assert sorted(k for k in sd if k not in sd.accessed) == ["clip.logit_scale"]
    coverage("clipseg_rd64_refined",
             lambda sd: clipseg_conv.convert_hf_clipseg(sd, cfg),
             lambda: MaskedCLIP(CLIPSegConfig()), clipseg_conv.CLIPSEG_IGNORED,
             clipseg_conv.MASKED_CLIP_ELIDABLE)


def test_clip_rn50_covers_cris_and_its_batch_stats():
    cfg = tpresets.cris_rn50_config(416)
    sd, got, own = coverage(
        "clip_rn50", lambda sd: cov.merged(cris_conv.convert_cris(sd, cfg)),
        lambda: CRISForSegmentation(cfg), cris_conv.CRIS_IGNORED,
        cris_conv.CRIS_ELIDABLE, fresh=("neck.", "decoder.", "proj.", "learner.",
                                        "additive_", "residual_ratio"))
    assert len(sd) == 495 and "visual.layer4.2.bn3.running_var" in got


def test_freesolo_r101_covers_solov2():
    cfg = SOLOv2Config()
    sd, _, _ = coverage("freesolo_r101", lambda sd: solo_conv.convert_solov2(sd, cfg),
                        lambda: SOLOv2(cfg), solo_conv.SOLOV2_IGNORED, ())
    assert len(sd) == 591


def test_siglip_base_covers_the_phrasecut_segmentor():
    """Fresh: the decoder and upsampler, and the projections SigLIP has no
    tensor for; elided: its vision attention-pooling head."""
    cfg = TransSegmentorConfig.siglip_base(use_existing_proj=True,
                                           decoder_num_heads=16, image_size=384)
    _, got, own = coverage(
        "siglip_base_patch16_224", lambda sd: ts_conv.convert_encoder(sd, cfg),
        lambda: TransformerSegmentor(cfg), ts_conv.TRANS_SEGMENTOR_IGNORED,
        ts_conv.TRANS_SEGMENTOR_ELIDABLE,
        fresh=("decoder_layers.", "decoder_norm.", "upsampler.", "text_projection.",
               "visual_projection."))
    assert "vision_model.probe" in got and "vision_model.probe" not in own


def test_biomedclip_covers_the_model():
    cfg = BiomedCLIPConfig()
    coverage("biomedclip", lambda sd: biomed_conv.convert_biomed_clip(sd, cfg),
             lambda: BiomedCLIP(cfg), biomed_conv.BIOMED_CLIP_IGNORED, ())


@pytest.mark.parametrize("name", ["clipseg_rd64_refined", "siglip_base_patch16_224",
                                  "biomedclip"])
def test_dumped_keysets_equal_the_models_on_meta(name):
    """The committed key sets are what scripts/torch_dump_keysets.py builds
    now, from transformers' classes (and the BiomedCLIP stub) on meta."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_dump_keysets", REPO / "scripts" / "torch_dump_keysets.py")
    dump = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(dump)
    assert {k: tuple(v) for k, v in dump.keyset(name).items()} == cov.read_keyset(name)


# --- 4. readers -------------------------------------------------------------------

def test_safetensors_reader_against_the_library(tmp_path):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(3, 5, generator=g),
               "f16": torch.randn(4, 2, generator=g).half(),
               "bf16": torch.randn(2, 3, 2, generator=g).bfloat16(),
               "i64": torch.arange(-3, 9).reshape(3, 4),
               "empty": torch.zeros(0, 7), "scalar": torch.tensor(2.5)}
    path = tmp_path / "x.safetensors"
    st_torch.save_file(tensors, str(path), metadata={"format": "pt"})
    got = cio.read_safetensors(path)
    assert set(got) == set(tensors)
    # numpy has no bfloat16 (safetensors.numpy refuses a file that holds
    # one): the reader widens it to f32, exactly torch's value
    lib = st_torch.load_file(str(path))
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["bf16"], lib["bf16"].float().numpy())
    del tensors["bf16"]
    st_torch.save_file(tensors, str(path))
    got, want = cio.read_safetensors(path), st_numpy.load_file(str(path))
    assert set(got) == set(want)
    for key, ref in want.items():
        assert got[key].dtype == ref.dtype and got[key].shape == ref.shape, key
        np.testing.assert_array_equal(got[key], ref)


def test_prefixes_and_lightning_payloads(tmp_path):
    """Lightning's `state_dict` with `net.` / `module.` prefixes gives the
    plain HF file's tree in both packages; `model.` keys select the
    reference wrapper."""
    hf, sd = hf_clipseg(False)
    cfg = clipseg_conv.config_from_hf(hf.config)
    plain = clipseg_conv.convert_hf_clipseg(sd, cfg)
    for prefix in ("net.", "module."):
        path = tmp_path / f"{prefix}ckpt"
        torch.save({"state_dict": {prefix + k: v for k, v in hf.state_dict().items()},
                    "global_step": 7}, path)
        got = clipseg_conv.load_checkpoint_params(path, cfg)
        assert_same_tree(got, plain)
        assert_same_tree(got, jclipseg_conv.load_checkpoint_params(
            str(path), _jcfg(cfg)))
    assert cio.strip_prefixes({"model.a": 1, "model.b": 2}, ("net.", "model.")) == \
        {"a": 1, "b": 2}
    assert cio.strip_prefixes({"model.a": 1, "b": 2}, ("model.",)) == {"model.a": 1,
                                                                        "b": 2}


def test_a_missing_or_stray_tensor_raises_and_names_it():
    hf, sd = hf_clipseg(False)
    cfg = clipseg_conv.config_from_hf(hf.config)
    broken = dict(sd)
    del broken["decoder.film_mul.weight"]
    with pytest.raises(KeyError, match="decoder.film_mul.weight"):
        clipseg_conv.convert_hf_clipseg(broken, cfg)
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    model, spec = tpresets.build_clipseg("coop", config=cfg, device="cpu")
    tensors = tensors_from_jax(clipseg_conv.convert_hf_clipseg(sd, cfg))
    with pytest.raises(KeyError, match="visual_projection.weight"):
        TTask(model, spec).init(params=tensors)          # no elision rule given
    tensors["decoder.film_add.bias"] = torch.zeros(3)
    with pytest.raises(ValueError, match="decoder.film_add.bias"):
        TTask(model, spec).init(params=tensors, elidable=clipseg_conv.CLIPSEG_ELIDABLE)
    from tunevlseg_torch.eval_zeroshot import load_converted
    tree = clipseg_conv.convert_hf_clipseg(sd, cfg)
    del tree["text_projection"]
    with pytest.raises(KeyError, match="text_projection.weight"):
        load_converted(MaskedCLIP(cfg), tree, clipseg_conv.MASKED_CLIP_ELIDABLE)


# --- 5. the train / eval CLIs --------------------------------------------------------

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """The CLI tests' synthetic folder and merges file, and a tiny HF
    CLIPSeg checkpoint at `CLIPSegConfig.tiny()` (the real vocabulary size,
    so the initializer's ids index its table)."""
    pytest.importorskip("cv2")
    pytest.importorskip("yaml")
    pytest.importorskip("regex")
    from tests.test_torch_cli import synth
    data = synth.__wrapped__(tmp_path_factory)
    hf, _ = hf_clipseg(False)
    path = tmp_path_factory.mktemp("ckpt") / "clipseg_tiny.bin"
    torch.save(hf.state_dict(), path)
    return data, path


def test_load_pretrained_and_the_initializer_match_the_jax_cli(cli_data):
    """`load_pretrained` lands the token embedding bit for bit; the context
    initializer, embedded through it, sets num_context to its token count
    and the context vectors to the JAX CLI's."""
    from tunevlseg_torch import train as train_mod
    from tunevlseg_torch.config.composer import compose
    from tunevlseg_torch.data.tokenizer import CLIPTokenizer
    from tunevlseg_tpu import train as jtrain
    from tunevlseg_tpu.data.tokenizer import CLIPTokenizer as JCLIPTokenizer
    data, ckpt = cli_data
    cfg = compose(train_mod.CONFIG_DIR, "train", [
        "experiment=coop/clipseg", "ds_name=kvasir_polyp", "+tiny_model=true",
        f"pretrained_checkpoint={ckpt}", "+trainer.device=cpu"])
    assert cfg["model"]["context_initializer"] == "a photo of a"
    loaded = train_mod.load_pretrained(cfg)
    table = hf_clipseg(False)[1]["clip.text_model.embeddings.token_embedding.weight"]
    np.testing.assert_array_equal(
        loaded["params"]["text_model.token_embedding.weight"].numpy(), table)
    tok = CLIPTokenizer(data["vocab"])
    emb, n = train_mod._initializer_embeddings(cfg, tok, loaded)
    jemb, jn = jtrain._initializer_embeddings(cfg, JCLIPTokenizer(data["vocab"]),
                                              jtrain.load_pretrained(cfg))
    ids = tok.encode("a photo of a", add_special_tokens=False)
    assert n == jn == len(ids) != 4
    np.testing.assert_array_equal(emb, jemb)
    model, task = train_mod.build_model_and_task(cfg, tok, pretrained=loaded,
                                                 device="cpu")
    task.init(**train_mod.init_kwargs(loaded))
    np.testing.assert_array_equal(model.learner.context_vectors[0].detach().numpy(),
                                  table[np.asarray(ids)])
    np.testing.assert_array_equal(
        model.text_model.token_embedding.weight.detach().numpy(), table)
    assert not model.text_model.token_embedding.weight.requires_grad


def test_train_and_eval_clis_with_a_pretrained_checkpoint(cli_data, tmp_path):
    from tests.test_torch_cli import _common
    from tunevlseg_torch import eval as eval_mod
    from tunevlseg_torch import train as train_mod
    data, ckpt = cli_data
    out = tmp_path / "logs"
    args = _common(data, out) + [f"pretrained_checkpoint={ckpt}"]
    result = train_mod.main(args + ["trainer.max_epochs=1", "exp_name=pre"])
    assert np.isfinite(result["test_dice"]) and np.isfinite(result["test_loss"])
    evaluated = eval_mod.main(args + [
        f"ckpt_path={out / 'train' / 'pre' / 'checkpoints'}", "exp_name=pre_eval"])
    assert np.isfinite(evaluated["test_dice"])
    np.testing.assert_allclose(evaluated["test_loss"], result["test_loss"], rtol=1e-6)


# --- 6. zero-shot RIS ---------------------------------------------------------------

def zs_request(vocab: int, bos: int, eos: int, seed=2):
    """A 64^2 image and the [phrase, class name] rows: BOS, words, EOS,
    padding (0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, min(vocab - 3, 1000), (2, 12)).astype(np.int32)
    ids[:, 0] = bos
    ids[0, 6], ids[1, 3] = eos, eos
    ids[0, 7:], ids[1, 4:] = 0, 0
    mask = (np.arange(12)[None] <= np.array([[6], [3]])).astype(np.int32)
    return rng.normal(size=(3, 64, 64)).astype(np.float32), ids, mask


def _plain(tree):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in tree.items()}


@pytest.mark.parametrize("variant", ["clip", "biomedclip"])
def test_build_ris_with_checkpoints_picks_the_jax_mask(variant, tmp_path):
    """`solo_checkpoint` (detectron2's payload) and `clip_checkpoint` (a
    CLIPSeg-layout file, or an open_clip BiomedCLIP one with
    `is_hf_model: false`) read by both packages' `build_ris`: the same
    proposals and the same picked mask."""
    from tunevlseg_tpu import eval_zeroshot as jzs
    from tunevlseg_torch import eval_zeroshot as tzs
    solo = tmp_path / "FreeSOLO_R50.pt"
    torch.save({"model": to_torch(tiny_freesolo())}, solo)
    clip = tmp_path / "clip.bin"
    model = {"solo_checkpoint": str(solo), "clip_checkpoint": str(clip)}
    if variant == "clip":
        torch.save(hf_clipseg(False, ris_clip_cfg())[0].state_dict(), clip)
        request = zs_request(49408, 49406, 49407)
    else:
        torch.save(biomed_stub(BiomedCLIPConfig.tiny()).state_dict(), clip)
        model["is_hf_model"] = False
        request = zs_request(120, 2, 3)
    cfg = {"model": model, "tiny_model": True, "seed": 0}
    tr = tzs.build_ris(cfg, device="cpu")
    with torch.no_grad():
        picked, extras = tr._fused_forward(*(torch.from_numpy(x) for x in request),
                                           request[0].shape[-2:])
    sims = extras["sims"][extras["valid"]]
    assert len(sims) >= 2 and float(sims.max() - sims.sort().values[-2]) > 1e-3
    jr = jzs.build_ris(cfg)
    # the JAX converters' trees are a dict subclass, which `jax.jit` does not
    # take as a pytree: the JAX `build_ris` cannot serve them as it stands
    # (ROADMAP Queue 3), so its parameters go in as plain dicts
    jr = dataclasses.replace(jr, clip_params=_plain(jr.clip_params),
                             solo_params=_plain(jr.solo_params))
    want = jr.predict_fused(*request)
    np.testing.assert_array_equal(picked.numpy(), want)
    assert want.any()


def test_a_bare_clip_model_file_raises_the_named_error(tmp_path):
    """The JAX `build_ris` reads `clip_checkpoint` in CLIPSeg's layout and
    fails on a bare CLIPModel file with a KeyError; the port names the
    layout it expects."""
    from tunevlseg_tpu import eval_zeroshot as jzs
    from tunevlseg_torch import eval_zeroshot as tzs
    path = tmp_path / "clip_model.bin"
    torch.save(hf_clip().state_dict(), path)
    cfg = {"model": {"clip_checkpoint": str(path)}, "tiny_model": True}
    with pytest.raises(ValueError, match="CLIPSeg-layout"):
        tzs.build_ris(cfg, device="cpu")
    with pytest.raises(KeyError, match="clip.text_model"):
        jzs.build_ris(cfg)

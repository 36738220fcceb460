#!/usr/bin/env python3
"""Validate real (or synthetic) checkpoints through the port's converters.

    python3 scripts/torch_validate_pretrained.py \
        --clipseg   <CIDAS/clipseg-rd64(-refined) dir or file, or synth> \
        --clip-rn50 <RN50.pt, or synth> \
        --freesolo  <FreeSOLO_R101_30k.pt, or synth> \
        --siglip    <google/siglip-base-patch16-224 dir or file, or synth> \
        [--all synth] [--device cuda|cpu]

The counterpart of `scripts/validate_pretrained.py`, with its legs, flags
and exit code (0 iff every requested leg passes). `synth` draws a
checkpoint on the real key set (`tunevlseg_torch/convert/keysets/*.json`,
`tests/fixtures/keysets/{clip_rn50,freesolo_r101}.json`) from a seeded
generator, so no leg needs `transformers`. Per leg:

  * key coverage: every key of the checkpoint read by the converter, except
    a named ignorable set (buffers, contrastive temperatures, detectron2's
    pixel statistics);
  * structural match: every tensor of the port's full-width model filled
    from the checkpoint, except the named fresh parts (a CRIS head, a
    segmentor's decoder), every converted tensor the model lacks under the
    converter's elidable prefixes, the shapes equal;
  * a forward on the card, bf16 over the loaded f32 weights, on the kernel
    path against the plain path: CLIPSeg rd64 (b1 at 352^2), CRIS RN50 (b1
    at 416^2), the PhraseCut segmentor on SigLIP (b1 at 384^2; probabilities
    within 2e-2 max, 2e-3 mean, or, as `chip_smoke.py` allows CRIS's random
    head, within 5e-2 / 5e-3 where two kernel-free paths differ by at least
    half as much), FreeSOLO R101 on the flat layout (b1 at 1024^2, K4
    against its plain version; raw outputs within 0.1 max, 1e-2 mean of the
    largest);
  * where `transformers` imports and the run is on the CPU (f32), the HF
    model itself in f64 as an oracle: CLIPSeg logits (5e-3), SigLIP's
    pooled text and image outputs (2e-3).

`--device cpu` runs everything but the kernel comparisons there. The script
imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

PROB_TOL = (2e-2, 2e-3)
WIDE_PROB_TOL = (5e-2, 5e-3)
SOLO_RAW_TOL = (0.1, 1e-2)
HF_CLIPSEG_TOL = 5e-3
HF_SIGLIP_TOL = 2e-3


class Leg:
    def __init__(self, name: str):
        self.name, self.rows, self.ok = name, [], True

    def check(self, label: str, passed: bool, detail: str = "") -> None:
        self.ok &= bool(passed)
        self.rows.append(f"  [{'PASS' if passed else 'FAIL'}] {label}"
                         + (f": {detail}" if detail else ""))

    def info(self, label: str) -> None:
        self.rows.append(f"  [info] {label}")

    def report(self) -> bool:
        print(f"== {self.name}: {'PASS' if self.ok else 'FAIL'}")
        for row in self.rows:
            print(row)
        return self.ok


# --- sources ----------------------------------------------------------------------

def synthetic(keyset: str, seed: int):
    import torch
    from tunevlseg_torch.convert.checkpoint_io import to_numpy
    from tunevlseg_torch.convert.coverage import read_keyset, synthetic_state_dict
    return to_numpy(synthetic_state_dict(read_keyset(keyset),
                                         torch.Generator().manual_seed(seed)))


def weights_file(path: Path) -> Path:
    """A model directory's weights file, or the file itself."""
    if path.is_dir():
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (path / name).exists():
                return path / name
        raise FileNotFoundError(f"{path}: no model.safetensors or pytorch_model.bin")
    return path


def hf_config(path: str):
    """The `config.json` of a model directory as a mapping, or None."""
    p = Path(path)
    return json.loads((p / "config.json").read_text()) \
        if p.is_dir() and (p / "config.json").exists() else None


# --- checks -----------------------------------------------------------------------

def coverage(leg: Leg, sd, tree, ignored: tuple) -> None:
    from tunevlseg_torch.convert.coverage import unread_keys
    unread = unread_keys(tree, sd, ignored)
    n_ignored = sum(k.endswith(ignored) for k in sd)
    leg.check("key coverage", not unread,
              f"{len(sd.accessed)} of {len(sd)} keys read, {n_ignored} ignorable "
              f"(suffixes {', '.join(ignored)})"
              + (f", UNREAD {unread[:5]}" if unread else ""))


def structural(leg: Leg, got: dict, model, elidable: tuple, fresh: tuple) -> None:
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    unfilled = [k for k in own if k not in got and not k.startswith(fresh)]
    stray = [k for k in got if k not in own and not k.startswith(elidable)]
    shapes = [k for k in got if k in own and own[k] != got[k]]
    dropped = sum(k not in own for k in got)
    leg.check("structural match", not (unfilled or stray or shapes),
              f"{len(own)} model tensors, {sum(k in own for k in got)} filled, "
              f"{len(own) - sum(k in own for k in got)} fresh ({', '.join(fresh) or 'none'}), "
              f"{dropped} converted tensors elided ({', '.join(elidable) or 'none'})"
              + (f"; UNFILLED {unfilled[:3]} STRAY {stray[:3]} SHAPE {shapes[:3]}"
                 if unfilled or stray or shapes else ""))


@contextlib.contextmanager
def plain_path(f32_scores: bool = False):
    """Every attention on `plain_attention` and every flat convolution on
    `conv_flat_ref`: the path the kernels are held against. With
    `f32_scores` the attentions take the kernels' plain version, which keeps
    its scores in f32 as the kernels do: a second path without a kernel."""
    import torch
    from tunevlseg_torch.nn import attention
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention as fa

    def launch(spec, relu, x, w_mat, scale, offset, residual, k, for_dx=False):
        if scale is None:
            scale = torch.ones(w_mat.shape[1], dtype=torch.float32, device=x.device)
            offset = torch.zeros_like(scale)
        return cf.conv_flat_ref(spec, relu, x, w_mat, scale, offset, residual)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(attention, "_kernel_eligible",
                                              lambda *a: ""))
        stack.enter_context(mock.patch.object(cf, "_launch", launch))
        if f32_scores:
            stack.enter_context(mock.patch.object(attention, "plain_attention",
                                                  fa.biased_attention_ref))
        yield


def launches() -> tuple:
    from tunevlseg_torch.ops import conv_flat as cf
    from tunevlseg_torch.ops import flash_attention as fa
    return fa.launch_count(), fa.bias_launch_count(), cf.launch_count()


def kernel_vs_plain(leg: Leg, device, run, compare, label: str) -> None:
    """`run()` on the kernel path and on the plain path; `compare(kernel,
    plain, plain with f32 scores)` returns (passed, detail)."""
    import torch
    if device.type != "cuda":
        leg.info(f"{label}: kernel path against plain path not run (no card)")
        return
    with torch.no_grad():
        before = launches()
        got = run()
        torch.cuda.synchronize()
        grew = tuple(a - b for a, b in zip(launches(), before))
        refs = []
        for f32_scores in (False, True):
            with plain_path(f32_scores):
                refs.append(run())
        torch.cuda.synchronize()
    passed, detail = compare(got, *refs)
    leg.check(f"{label}: kernel path against plain path", passed and any(grew),
              f"{detail}; launches (K1, K3, K4) {grew}")


def probs_close(got, ref, ref32):
    """Within the common bounds of the plain path; or within the wider
    bounds `chip_smoke.py` allows CRIS's randomly initialised head, earned
    only where the two kernel-free paths differ among themselves by at least
    half as much (the model amplifies a rounding, whichever code made it)."""
    def differ(a, b):
        d = (a.float() - b.float()).abs()
        return d.max().item(), d.mean().item()
    dmax, dmean = differ(got, ref)
    detail = (f"max abs diff {dmax:.4g} (bound {PROB_TOL[0]}), mean {dmean:.4g} "
              f"(bound {PROB_TOL[1]})")
    if dmax <= PROB_TOL[0] and dmean <= PROB_TOL[1]:
        return True, detail
    pmax, pmean = differ(ref, ref32)
    earned = 2 * pmax >= dmax and 2 * pmean >= dmean
    ok = earned and dmax <= WIDE_PROB_TOL[0] and dmean <= WIDE_PROB_TOL[1]
    return ok, (f"{detail}; the two kernel-free paths differ by max {pmax:.4g}, "
                f"mean {pmean:.4g}: the wider bound {WIDE_PROB_TOL} is "
                f"{'earned' if earned else 'not earned'}")


def request(device, img: int, ids_fn):
    import torch
    g = torch.Generator().manual_seed(0)
    ids, mask = ids_fn(g)
    return {"image": torch.randint(0, 256, (1, 3, img, img), generator=g,
                                   dtype=torch.uint8).to(device),
            "input_ids": ids.to(device), "attention_mask": mask.to(device)}


def clip_ids(pad: int):
    def make(g):
        import torch
        ids = torch.randint(3, 1000, (1, 77), generator=g, dtype=torch.int32)
        ids[:, 0], ids[:, 9], ids[:, 10:] = 49406, 49407, pad
        mask = (torch.arange(77) <= 9).int()[None]
        return ids, mask
    return make


def f64_default():
    """HF's mask helpers take finfo(default dtype).min: run them in f64."""
    import torch

    @contextlib.contextmanager
    def ctx():
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            yield
        finally:
            torch.set_default_dtype(prev)
    return ctx()


def transformers_or_none():
    try:
        import transformers
        return transformers
    except ImportError:
        return None


# --- legs -------------------------------------------------------------------------

def leg_clipseg(path: str, device) -> Leg:
    import torch
    from tunevlseg_torch.convert import clipseg as conv
    from tunevlseg_torch.convert.checkpoint_io import TrackingDict
    from tunevlseg_torch.convert.coverage import port_shapes
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    from tunevlseg_torch.models.presets import build_clipseg, clipseg_rd64_config
    from tunevlseg_torch.training.task import SegmentationTask

    leg = Leg(f"clipseg rd64 ({path})")
    if path == "synth":
        sd = synthetic("clipseg_rd64_refined", 0)
        leg.info("synthetic tensors on the CIDAS rd64-refined key set "
                 "(tunevlseg_torch/convert/keysets/clipseg_rd64_refined.json)")
        cfg = clipseg_rd64_config(complex_head=True)
    else:
        sd = conv.read_clipseg_state_dict(weights_file(Path(path)))
        config = hf_config(path)
        cfg = (conv.config_from_hf(config) if config else clipseg_rd64_config(
            "decoder.transposed_convolution.0.weight" in sd))
    sd = TrackingDict(sd)
    t0 = time.perf_counter()
    tree = conv.load_checkpoint_params(None, cfg, sd=sd)
    leg.info(f"converted in {time.perf_counter() - t0:.2f} s")
    coverage(leg, sd, tree, conv.CLIPSEG_IGNORED)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, spec = build_clipseg(None, config=cfg, dtype=dtype, device=device)
    structural(leg, port_shapes(tree), model, conv.CLIPSEG_ELIDABLE, ())
    task = SegmentationTask(model, spec)
    task.init(params=tensors_from_jax(tree), elidable=conv.CLIPSEG_ELIDABLE)
    req = request(device, 352, clip_ids(49407))
    kernel_vs_plain(leg, device, lambda: task.predict_step(req), probs_close,
                    "b1 352^2 request")
    transformers = transformers_or_none()
    if transformers is not None and device.type == "cpu":
        if path == "synth":
            hf_cfg = hf_config_of(transformers, cfg)
        else:
            hf_cfg = transformers.CLIPSegConfig.from_pretrained(path) \
                if Path(path).is_dir() else hf_config_of(transformers, cfg)
        hf_cfg._attn_implementation = "eager"
        hf = transformers.CLIPSegForImageSegmentation(hf_cfg).double().eval()
        hf.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
                           strict=False)
        pix = torch.randn(1, 3, 352, 352, generator=torch.Generator().manual_seed(1))
        with torch.no_grad(), f64_default():
            ref = hf(input_ids=req["input_ids"].long(), pixel_values=pix.double(),
                     attention_mask=req["attention_mask"].long()).logits
        with torch.no_grad():
            got = model(req["input_ids"], pix, req["attention_mask"])[:, 0]
        diff = (got.double() - ref.reshape(got.shape)).abs().max().item()
        leg.check("logits against the HF model in f64", diff < HF_CLIPSEG_TOL,
                  f"max abs diff {diff:.3g} (bound {HF_CLIPSEG_TOL})")
    return leg


def hf_config_of(transformers, cfg):
    """transformers' CLIPSegConfig of the port's config."""
    return transformers.CLIPSegConfig(
        text_config=dict(eos_token_id=cfg.text.eos_token_id),
        vision_config=dict(patch_size=cfg.vision.patch_size,
                           image_size=cfg.vision.image_size),
        extract_layers=list(cfg.extract_layers), reduce_dim=cfg.reduce_dim,
        decoder_num_attention_heads=cfg.decoder_num_heads,
        decoder_intermediate_size=cfg.decoder_intermediate_size,
        conditional_layer=cfg.conditional_layer,
        use_complex_transposed_convolution=cfg.complex_transposed_convolution)


def leg_clip_rn50(path: str, device) -> Leg:
    import torch
    from tunevlseg_torch.convert import cris as conv
    from tunevlseg_torch.convert.checkpoint_io import TrackingDict
    from tunevlseg_torch.convert.coverage import merged, port_shapes
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    from tunevlseg_torch.models.presets import build_cris, cris_rn50_config
    from tunevlseg_torch.training.task import SegmentationTask

    leg = Leg(f"clip rn50 ({path})")
    if path == "synth":
        sd = synthetic("clip_rn50", 1)
        leg.info("synthetic tensors on the RN50.pt key set "
                 "(tests/fixtures/keysets/clip_rn50.json)")
    else:
        sd = conv.read_cris_state_dict(path)
    sd = TrackingDict(sd)
    inferred = conv.config_from_clip_state_dict(sd)
    cfg = cris_rn50_config(416)
    leg.check("build_model's shape inference",
              (inferred.vision_layers, inferred.vision_width, inferred.embed_dim,
               inferred.transformer_width) == ((3, 4, 6, 3), 64, 1024, 512),
              f"vision_layers {inferred.vision_layers}, embed_dim {inferred.embed_dim}")
    t0 = time.perf_counter()
    trees = conv.convert_cris(sd, cfg)
    leg.info(f"converted in {time.perf_counter() - t0:.2f} s")
    coverage(leg, sd, merged(trees), conv.CRIS_IGNORED)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, spec = build_cris("coop", prompt_depth=3, num_context=4, config=cfg,
                             dtype=dtype, device=device)
    got = port_shapes(merged(trees))
    structural(leg, got, model, conv.CRIS_ELIDABLE,
               ("neck.", "decoder.", "proj.", "learner.", "additive_",
                "residual_ratio"))
    task = SegmentationTask(model, spec)
    task.init(params=tensors_from_jax(trees["params"]),
              variables={"batch_stats": tensors_from_jax(trees["batch_stats"])},
              elidable=conv.CRIS_ELIDABLE)
    req = request(device, 416, clip_ids(0))
    kernel_vs_plain(leg, device, lambda: task.predict_step(req), probs_close,
                    "CRIS CoOp b1 416^2 request")
    return leg


def leg_freesolo(path: str, device) -> Leg:
    import torch
    from tunevlseg_torch.convert import solov2 as conv
    from tunevlseg_torch.convert.checkpoint_io import TrackingDict
    from tunevlseg_torch.convert.coverage import port_shapes
    from tunevlseg_torch.eval_zeroshot import load_converted
    from tunevlseg_torch.models.solov2.model import SOLOv2, SOLOv2Config

    leg = Leg(f"freesolo r101 ({path})")
    if path == "synth":
        sd = synthetic("freesolo_r101", 2)
        leg.info("synthetic tensors on the FreeSOLO_R101_30k.pt key set "
                 "(tests/fixtures/keysets/freesolo_r101.json)")
    else:
        sd = conv.read_freesolo_state_dict(path)
    sd = TrackingDict(sd)
    cfg = SOLOv2Config()
    t0 = time.perf_counter()
    tree = conv.convert_solov2(sd, cfg)
    leg.info(f"converted in {time.perf_counter() - t0:.2f} s")
    coverage(leg, sd, tree, conv.SOLOV2_IGNORED)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = SOLOv2(cfg, layout="flat", dtype=dtype)
    structural(leg, port_shapes(tree), model, (), ())
    load_converted(model, tree)
    model.to(device).eval()
    image = torch.randn(1, 3, 1024, 1024, generator=torch.Generator().manual_seed(3),
                        device="cpu").to(device)

    def compare(got, ref, _):
        worst_max, worst_mean = 0.0, 0.0
        for a, b in zip(got, ref):
            top = b.float().abs().max().item()
            d = (a.float() - b.float()).abs()
            worst_max = max(worst_max, d.max().item() / top)
            worst_mean = max(worst_mean, d.mean().item() / top)
        ok = worst_max <= SOLO_RAW_TOL[0] and worst_mean <= SOLO_RAW_TOL[1]
        return ok, (f"raw outputs: worst max abs diff {worst_max:.4g} of the "
                    f"largest (bound {SOLO_RAW_TOL[0]}), mean {worst_mean:.4g} "
                    f"(bound {SOLO_RAW_TOL[1]})")

    def run():
        cate, kernel, emb, mask_feats = model(image)
        return [*cate, *kernel, *emb, mask_feats]
    kernel_vs_plain(leg, device, run, compare, "flat R101 b1 1024^2 forward")
    return leg


def leg_siglip(path: str, device) -> Leg:
    import torch
    from tunevlseg_torch.convert import trans_segmentor as conv
    from tunevlseg_torch.convert.checkpoint_io import TrackingDict, read_state_dict
    from tunevlseg_torch.convert.coverage import port_shapes
    from tunevlseg_torch.convert.from_jax import tensors_from_jax
    from tunevlseg_torch.models.presets import build_trans_segmentor
    from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
    from tunevlseg_torch.training.task import SegmentationTask

    leg = Leg(f"siglip base ({path})")
    if path == "synth":
        sd = synthetic("siglip_base_patch16_224", 4)
        leg.info("synthetic tensors on the siglip-base-patch16-224 key set "
                 "(tunevlseg_torch/convert/keysets/siglip_base_patch16_224.json)")
    else:
        sd = read_state_dict(weights_file(Path(path)))
    sd = TrackingDict(sd)
    cfg = TransSegmentorConfig.siglip_base(
        use_existing_proj=True, decoder_num_heads=16, decoder_dropout=0.1,
        output_bias=-1.748104048321891, image_size=384)
    t0 = time.perf_counter()
    tree = conv.convert_encoder(sd, cfg)
    leg.info(f"converted in {time.perf_counter() - t0:.2f} s")
    coverage(leg, sd, tree, conv.TRANS_SEGMENTOR_IGNORED)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model, spec = build_trans_segmentor(cfg, freeze_encoders=True, dtype=dtype,
                                        device=device)
    structural(leg, port_shapes(tree), model, conv.TRANS_SEGMENTOR_ELIDABLE,
               ("decoder_layers.", "decoder_norm.", "upsampler.",
                "text_projection.", "visual_projection."))
    task = SegmentationTask(model, spec)
    task.init(params=tensors_from_jax(tree), elidable=conv.TRANS_SEGMENTOR_ELIDABLE)

    def siglip_ids(g):
        ids = torch.randint(3, 1000, (1, 64), generator=g, dtype=torch.int32)
        ids[:, 9:] = 1
        return ids, (torch.arange(64) < 10).int()[None]
    req = request(device, 384, siglip_ids)
    kernel_vs_plain(leg, device, lambda: task.predict_step(req), probs_close,
                    "PhraseCut b1 384^2 request")
    transformers = transformers_or_none()
    if transformers is not None and device.type == "cpu":
        from tunevlseg_torch.models.trans_segmentor.siglip import (SiglipTextTower,
                                                                   SiglipVisionTower)
        hf_cfg = (transformers.SiglipConfig.from_pretrained(path)
                  if path != "synth" and Path(path).is_dir()
                  else transformers.SiglipConfig())
        hf_cfg._attn_implementation = "eager"
        hf = transformers.SiglipModel(hf_cfg).double().eval()
        hf.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
                           strict=False)
        text = SiglipTextTower(cfg.text)
        vision = SiglipVisionTower(cfg.vision, use_head=True)
        tensors = tensors_from_jax(tree)
        for tower, prefix in ((text, "text_model."), (vision, "vision_model.")):
            tower.load_state_dict({k[len(prefix):]: v for k, v in tensors.items()
                                   if k.startswith(prefix)})
        ids = req["input_ids"].long()
        pix = torch.randn(1, 3, 224, 224, generator=torch.Generator().manual_seed(5))
        with torch.no_grad(), f64_default():
            ref_t = hf.text_model(input_ids=ids).pooler_output
            ref_v = hf.vision_model(pixel_values=pix.double()).pooler_output
        with torch.no_grad():
            got_t = text(ids)[1]
            got_v = vision(pix)[2]
        for what, got, ref in (("text", got_t, ref_t), ("image", got_v, ref_v)):
            diff = (got.double() - ref).abs().max().item()
            leg.check(f"pooled {what} output against the HF model in f64",
                      diff < HF_SIGLIP_TOL,
                      f"max abs diff {diff:.3g} (bound {HF_SIGLIP_TOL})")
    return leg


LEGS = {"clipseg": leg_clipseg, "clip_rn50": leg_clip_rn50,
        "freesolo": leg_freesolo, "siglip": leg_siglip}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clipseg", default=None,
                    help="CIDAS/clipseg-rd64(-refined) model dir or file, or 'synth'")
    ap.add_argument("--clip-rn50", dest="clip_rn50", default=None,
                    help="OpenAI RN50.pt path, or 'synth'")
    ap.add_argument("--freesolo", default=None,
                    help="FreeSOLO_R101_30k.pt path, or 'synth'")
    ap.add_argument("--siglip", default=None,
                    help="google/siglip-base-patch16-224 dir or file, or 'synth'")
    ap.add_argument("--all", dest="all_mode", default=None, metavar="synth",
                    help="run every leg with this source (only 'synth' makes sense)")
    ap.add_argument("--device", default="cuda",
                    help="where the models run (default the card; 'cpu' skips "
                         "the kernel comparisons)")
    args = ap.parse_args(argv)
    requested = {name: getattr(args, name) or args.all_mode for name in LEGS}
    requested = {k: v for k, v in requested.items() if v}
    if not requested:
        ap.error("nothing to validate: pass at least one leg or --all synth")

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    ok = True
    for name, src in requested.items():
        t0 = time.perf_counter()
        try:
            leg = LEGS[name](src, device)
        except Exception as e:          # a crashed converter is a failed leg
            leg = Leg(f"{name} ({src})")
            leg.check("converter ran", False, f"{type(e).__name__}: {e}")
        leg.info(f"{time.perf_counter() - t0:.1f} s")
        ok &= leg.report()
    print(f"\noverall: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

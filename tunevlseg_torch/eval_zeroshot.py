"""Zero-shot referring-segmentation evaluation entry point of the port.

    python -m tunevlseg_torch.eval_zeroshot model=zsseg ds_name=refcoco \
        paths.data_root=/data vocab_path=... \
        +model.cache_dir=cache/ model.write_cache=true

The counterpart of `tunevlseg_tpu/eval_zeroshot.py`, reading the same
`configs/` (`eval_zeroshot.yaml`, `experiment=zsseg_clip` /
`zsseg_biomedclip`): the reference runs ZeroShotRIS through src/eval.py with
model=zsseg and batch 1. Each image goes through the fused device path,
`pipeline_depth` requests in flight (`ZeroShotRIS.predict_fused_many`),
unless the run reads a prebuilt cache (`+model.read_cache=true`, the
model-free alpha / beta sweep), which takes the host path. The run goes to
the CUDA card; `+trainer.device=cpu` asks for the CPU. The models compute
in f32, as the JAX package's do; `build_ris(dtype=torch.bfloat16)` runs them
in bf16 over f32 weights. `+model.layout=flat` runs FreeSOLO's ResNet
through the flat convolution.

`model.solo_checkpoint` (FreeSOLO's detectron2 payload) and
`model.clip_checkpoint` load converted weights: a CLIPSeg-layout file
(`clip.text_model.*`, `clip.vision_model.*`, the projections; its decoder is
dropped), which is what the JAX `build_ris` reads there, or, with
`model.is_hf_model: false`, an open_clip BiomedCLIP state dict. A bare HF
`CLIPModel` file raises a ValueError that names the layout expected (the
JAX package fails on it with a KeyError). Without a checkpoint the weights
are random, seeded from `seed` (CLIP) and 1 (FreeSOLO), and a warning says
so.
"""
from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from tunevlseg_torch.config.composer import compose
from tunevlseg_torch.convert.from_jax import tensors_from_jax
from tunevlseg_torch.data.datasets import ZeroShotDataset
from tunevlseg_torch.data.tokenizer import (WordPieceTokenizer,
                                            load_default_tokenizer)
from tunevlseg_torch.data.transforms import eval_transforms
from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                CLIPVisionConfig)
from tunevlseg_torch.models.solov2.model import SOLOv2, SOLOv2Config
from tunevlseg_torch.models.zero_shot_ris.biomed_clip import (BiomedCLIP,
                                                              BiomedCLIPConfig)
from tunevlseg_torch.models.zero_shot_ris.model import MaskedCLIP, ZeroShotRIS
from tunevlseg_torch.nn.layers import init_params
from tunevlseg_torch.ops.metrics import SegMetricState, compute, update_state
from tunevlseg_torch.train import CONFIG_DIR, resolve_device
from tunevlseg_torch.training.task import load_partial_state
from tunevlseg_torch.utils.logging import MetricLogger, get_logger

log = get_logger(__name__)



def ris_configs(cfg: dict):
    """(CLIP config, SOLOv2 config, CLIP input size) of the composed config:
    CLIP ViT-B/16 (or BiomedCLIP) and the R101 FreeSOLO, or the tiny test
    models with `tiny_model`."""
    m = cfg["model"]
    tiny = bool(cfg.get("tiny_model"))
    if not m.get("is_hf_model", True):
        clip_cfg = BiomedCLIPConfig.tiny() if tiny else BiomedCLIPConfig()
    elif tiny:
        clip_cfg = CLIPSegConfig(
            text=CLIPTextConfig(vocab_size=49408, hidden_size=16, num_layers=2,
                                num_heads=2, intermediate_size=32),
            vision=CLIPVisionConfig(hidden_size=24, num_layers=2, num_heads=2,
                                    intermediate_size=48, patch_size=8,
                                    image_size=32),
            projection_dim=20)
    else:
        clip_cfg = CLIPSegConfig()       # ViT-B/16 CLIP, the masked-feature path
    solo_cfg = (SOLOv2Config.tiny(fpn_channels=32, num_kernels=32, num_masks=32,
                                  instance_channels=32, mask_channels=32)
                if tiny else SOLOv2Config())
    size = m.get("clip_image_size", 32 if tiny else 224)
    return clip_cfg, solo_cfg, size


def load_converted(module: torch.nn.Module, tree: dict,
                   elidable: tuple = ()) -> torch.nn.Module:
    """A converted tree onto `module`: every tensor of the module filled
    (it raises and names the ones the checkpoint lacks), and the
    checkpoint's tensors the module does not build dropped where `elidable`
    names them (`load_partial_state`)."""
    tensors = tensors_from_jax(tree)
    unfilled = sorted(set(module.state_dict()) - set(tensors))
    if unfilled:
        raise KeyError(f"{type(module).__name__} tensors the checkpoint does "
                       f"not fill: {unfilled[:8]}")
    load_partial_state(module, tensors, elidable)
    return module


def clip_checkpoint_tree(path, clip_cfg) -> dict:
    """`model.clip_checkpoint` -> the tree: a BiomedCLIP state dict for a
    `BiomedCLIPConfig`, else a CLIPSeg-layout file, as the JAX `build_ris`
    reads it. A bare HF CLIPModel file (`text_model.*` / `vision_model.*`
    at the top) raises a ValueError naming the layout expected. The
    decoder's head converts in the layout the file has (rd64 or
    rd64-refined; the JAX `build_ris` takes only the plain one): MaskedCLIP
    drops the decoder either way."""
    if isinstance(clip_cfg, BiomedCLIPConfig):
        from tunevlseg_torch.convert.biomed_clip import load_biomedclip_checkpoint
        return load_biomedclip_checkpoint(path, clip_cfg)
    from tunevlseg_torch.convert.clipseg import (clipseg_layout,
                                                 load_checkpoint_params,
                                                 read_clipseg_state_dict)
    sd = read_clipseg_state_dict(path)
    if not clipseg_layout(sd):
        raise ValueError(
            f"clip_checkpoint {path}: expected a CLIPSeg-layout checkpoint "
            "(clip.text_model.*, clip.vision_model.*, clip.text_projection, "
            "clip.visual_projection; the decoder is dropped), which is what "
            "the JAX eval_zeroshot reads there; this file has "
            f"{sorted(sd)[:2]}..., a bare CLIPModel layout perhaps, which "
            "neither package converts here")
    refined = any(k.endswith("decoder.transposed_convolution.0.weight") for k in sd)
    return load_checkpoint_params(path, dataclasses.replace(
        clip_cfg, complex_transposed_convolution=refined), sd=sd)


def build_ris(cfg: dict, device="cuda",
              dtype: torch.dtype = torch.float32) -> ZeroShotRIS:
    """`ZeroShotRIS` of the composed config on `device`, computing in
    `dtype`, with the weights of `model.clip_checkpoint` and
    `model.solo_checkpoint`, or, where one is not given, seeded random f32
    weights (drawn on the CPU: CLIP from `seed`, FreeSOLO from 1, as the JAX
    CLI keys them; logged). The CUDA card unless the caller names another
    device; without one it raises."""
    m = cfg["model"]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: build_ris puts the models on the "
                           'card unless given device="cpu"')
    devices = proposal_devices(int(cfg.get("n_devices", 1) or 1), device)
    clip_cfg, solo_cfg, size = ris_configs(cfg)
    hf = isinstance(clip_cfg, CLIPSegConfig)
    clip = MaskedCLIP(clip_cfg, dtype) if hf else BiomedCLIP(clip_cfg, dtype)
    solo = SOLOv2(solo_cfg, layout=m.get("layout", "nchw"), dtype=dtype)
    if m.get("clip_checkpoint"):
        from tunevlseg_torch.convert.clipseg import MASKED_CLIP_ELIDABLE
        load_converted(clip, clip_checkpoint_tree(m["clip_checkpoint"], clip_cfg),
                       MASKED_CLIP_ELIDABLE if hf else ())
    else:
        init_params(clip, torch.Generator().manual_seed(cfg.get("seed", 0)))
        log.warning("no clip_checkpoint given: using RANDOM %s weights",
                    "clip" if hf else "BiomedCLIP")
    if m.get("solo_checkpoint"):
        from tunevlseg_torch.convert.solov2 import load_freesolo_checkpoint
        load_converted(solo, load_freesolo_checkpoint(m["solo_checkpoint"],
                                                      solo_cfg))
    else:
        init_params(solo, torch.Generator().manual_seed(1))
        log.warning("no solo_checkpoint given: using RANDOM FreeSOLO weights")
    return ZeroShotRIS(
        clip_cfg, solo_cfg, clip.to(device).eval(), solo.to(device).eval(),
        masking_block_idx=m.get("masking_block_idx", -3),
        alpha=m.get("alpha", 0.95), beta=m.get("beta", 0.5),
        num_masks=m.get("num_masks", 1), clip_image_size=size,
        cache_dir=m.get("cache_dir"), read_cache=m.get("read_cache", False),
        write_cache=m.get("write_cache", False), devices=devices)


def proposal_devices(n: int, device: torch.device) -> tuple:
    """The `n_devices` the proposal batch runs over: `device` and the next
    cards after it (n times the CPU for a CPU run). More than the visible
    cards raises, as the JAX CLI does rather than run on fewer."""
    if device.type != "cuda":
        return (device,) * n
    first = device.index or 0
    if first + n > torch.cuda.device_count():
        raise ValueError(f"n_devices={n} but only {torch.cuda.device_count()} "
                         "device(s) visible; lower n_devices")
    return tuple(torch.device("cuda", first + i) for i in range(n))


def main(argv: Optional[list[str]] = None) -> dict:
    overrides = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "eval_zeroshot", overrides)
    from tunevlseg_torch.utils.task_wrapper import run_guarded
    return run_guarded(lambda: _run(cfg), cfg["paths"]["output_dir"])


def zero_shot_dataset(cfg: dict) -> ZeroShotDataset:
    """The composed config's test `ZeroShotDataset`, with its tokenizer (the
    CLIP BPE, or BiomedBERT's WordPiece with `model.is_hf_model: false`)."""
    if cfg["model"].get("is_hf_model", True):
        tokenizer = load_default_tokenizer(cfg.get("vocab_path"))
    else:
        # BiomedCLIP pairs with the BiomedBERT WordPiece tokenizer
        if not cfg.get("vocab_path"):
            raise ValueError("is_hf_model=false needs vocab_path pointing at a "
                             "BERT vocab.txt")
        tokenizer = WordPieceTokenizer(cfg["vocab_path"])
    d = cfg["data"]
    # the reference's zsseg pipeline CLIP-normalizes the one image tensor that
    # feeds BOTH FreeSOLO and CLIP (experiment/zsseg_clip.yaml:65-80: FreeSOLO
    # never sees detectron2's pixel statistics; a quirk, kept)
    transforms = eval_transforms(cfg.get("img_size", 1024), cfg.get("img_mean"),
                                 cfg.get("img_std"))
    return ZeroShotDataset(
        image_dir=d["image_dir"], mask_dir=d["mask_dir"],
        task_path=d["test_task_path"], prompt_index=cfg["prompt_index"],
        insert_stop_at_last=cfg.get("insert_stop_at_last", True),
        tokenizer=tokenizer, max_length=cfg.get("max_length", 77),
        transforms=transforms, seed=cfg.get("seed", 0))


def _run(cfg: dict) -> dict:
    dataset = zero_shot_dataset(cfg)
    ris = build_ris(cfg, device=resolve_device(cfg))

    metric_logger = MetricLogger(cfg["paths"]["output_dir"])
    state = SegMetricState.zeros()
    threshold = cfg["model"].get("threshold", 0.5)
    limit = cfg["trainer"].get("limit_batches")
    n = len(dataset) if limit is None else min(limit, len(dataset))
    gt_masks: collections.deque = collections.deque()   # those in flight

    def items():
        for i in range(n):
            item = dataset[i]
            gt_masks.append(item["mask"])
            yield item

    # unless READING a prebuilt cache (the model-free sweep), every request
    # runs on the device, the crop-resize of alpha < 1 included; write_cache
    # works there too, from the device's intermediates
    if cfg["model"].get("fused", "auto") != "off" and not ris.read_cache:
        log.info("using the fused device path%s",
                 " (writing the feature cache)" if ris.write_cache else "")
        preds = ris.predict_fused_many(
            items(), depth=int(cfg["model"].get("pipeline_depth", 2)))
    else:
        preds = (ris(item["image"], item["input_ids"], item["attention_mask"],
                     cache_name=item["cache_name"]) for item in items())
    for i, pred in enumerate(preds):
        state = update_state(state, torch.from_numpy(np.asarray(pred[:1])),
                             torch.from_numpy(np.asarray(gt_masks.popleft())[None]),
                             threshold)
        if (i + 1) % 25 == 0:
            metric_logger.log(compute(state), i + 1, prefix="running_")

    result = {f"test_{k}": float(v) for k, v in compute(state).items()}
    metric_logger.log(result, len(dataset))
    log.info(f"done: {result}")
    return result


if __name__ == "__main__":
    main()

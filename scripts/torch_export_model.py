"""Export a model family's predict step for serving: the port's counterpart
of `scripts/export_model.py` (`jax.export` there, `torch.export` here).

`tunevlseg_torch.serving.export_task_predict` traces the predict step ONCE
at static shapes and writes one program per platform (`predict.<platform>
.pt2`) and `meta.json` into `--out`; a server loads it with
`serving.load_fn(out, device=...)` and calls it with the weights as
arguments, without the model's Python code. On "cuda" the program holds the
port's kernels as `tunevlseg::` ops (K1 / K3 for attention, K4 for CRIS's
flat backbone); on "cpu" their plain versions. The weights are seeded random
ones (replace them at call time with converted or trained ones); the export
reads only their shapes.

Usage:
  python scripts/torch_export_model.py --family coop_clipseg --batch 8 \
      --img 352 --out exports/clipseg_b8 [--tiny] [--platforms cuda,cpu]
  python scripts/torch_export_model.py --family coop_cris --layout flat ...
  python scripts/torch_export_model.py --family trans_seg --siglip ...
  # load + run:
  from tunevlseg_torch import serving
  predict = serving.load_fn("exports/clipseg_b8", device="cuda")
  probs = predict(params, {"image": ..., "input_ids": ..., "attention_mask": ...})

Prints one JSON line: the family, batch, image size, sequence length, the
program's bytes, the platforms, the number of inputs and the `tunevlseg::`
ops of each program. `--tiny` builds the tiny test configurations (32^2
images, 12 tokens; CRIS at 64^2), which run on the CPU
(`--platforms cpu --device cpu`).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FAMILIES = ("coop_clipseg", "coop_cris", "trans_seg")


def build(family: str, tiny: bool, device: str, layout: str = "nchw",
          siglip: bool = False, strategy: str = "coop", img: int = 352):
    """(task, sequence length, vocabulary size) of a family, bf16 compute
    over f32 weights on the card (f32 on the CPU); the TransformerSegmentor
    is built for `img`-pixel images, as the train CLI builds it at
    `img_size`."""
    import torch

    from tunevlseg_torch.models.presets import (build_clipseg, build_cris,
                                                build_trans_segmentor)
    from tunevlseg_torch.training.task import SegmentationTask

    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    vocab, seq = 49408, 77
    if family == "coop_clipseg":
        from tunevlseg_torch.models.clip.config import CLIPSegConfig
        model, spec = build_clipseg(strategy, prompt_depth=3, num_context=4,
                                    config=CLIPSegConfig.tiny() if tiny else None,
                                    dtype=dtype, device=device)
    elif family == "coop_cris":
        from tunevlseg_torch.models.cris.model import CRISConfig
        model, spec = build_cris(strategy, prompt_depth=3, num_context=4,
                                 config=CRISConfig.tiny() if tiny else None,
                                 layout=layout, dtype=dtype, device=device)
        seq = 17
    elif family == "trans_seg":
        from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
        if tiny:
            config = TransSegmentorConfig.tiny(
                encoder_family="siglip" if siglip else "clip")
        elif siglip:      # model=trans_seg_siglip: the decoder at 96 dims a head
            config = TransSegmentorConfig.siglip_base(decoder_dropout=0.0,
                                                      image_size=img)
            vocab, seq = 32000, 64
        else:
            config = TransSegmentorConfig(decoder_dropout=0.0, image_size=img)
        model, spec = build_trans_segmentor(config, dtype=dtype, device=device)
    else:
        raise ValueError(f"unknown family {family}")
    return SegmentationTask(model, spec), seq, vocab


def example_batch(batch: int, img: int, seq: int, vocab: int, device: str):
    """A request of `batch` uint8 images and CLIP-style ids (BOS, words,
    EOS, padding with the EOS id) with their attention mask."""
    import torch
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, min(1000, vocab - 2), (batch, seq), generator=g,
                        dtype=torch.int32)
    ids[:, 0] = vocab - 2
    ids[:, min(9, seq - 1):] = vocab - 1
    mask = torch.ones_like(ids)
    mask[:, min(10, seq):] = 0
    out = {"image": torch.randint(0, 256, (batch, 3, img, img), generator=g,
                                  dtype=torch.uint8),
           "input_ids": ids, "attention_mask": mask}
    return {k: v.to(device) for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--family", default="coop_clipseg", choices=FAMILIES)
    ap.add_argument("--strategy", default="coop")
    ap.add_argument("--layout", default="nchw", choices=("nchw", "flat"),
                    help="CRIS's backbone: cuDNN or the flat K4 layout")
    ap.add_argument("--siglip", action="store_true",
                    help="trans_seg with the SigLIP towers (model=trans_seg_siglip)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img", type=int, default=352)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated: cuda, cpu (default: --device's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)

    from tunevlseg_torch import serving

    task, seq, vocab = build(args.family, args.tiny, args.device, args.layout,
                             args.siglip, args.strategy, args.img)
    if args.tiny:
        args.img = 64 if args.family == "coop_cris" else 32
        seq = 12
    seq = args.seq or seq
    batch = example_batch(args.batch, args.img, seq, vocab, args.device)
    platforms = (tuple(args.platforms.split(",")) if args.platforms
                 else (args.device.split(":")[0],))
    graph = serving.export_task_predict(task, dict(task.model.state_dict()),
                                        batch, args.out, platforms=platforms)
    meta = serving.read_meta(graph.parent)
    info = {"family": args.family, "batch": args.batch, "img": args.img,
            "seq": seq, "bytes": meta["graph_bytes"],
            "platforms": meta["platforms"], "n_inputs": len(meta["in_specs"]),
            "ops": meta["tunevlseg_ops"]}
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Write the key sets of three real checkpoints as `{key: shape}` JSON.

    python3 scripts/torch_dump_keysets.py [--check]

The files, under `tunevlseg_torch/convert/keysets/`, are what the port's
tests, `scripts/torch_validate_pretrained.py --all synth` and
`chip_smoke.py` draw synthetic full-width checkpoints on, where no real
file is at hand:

  * `clipseg_rd64_refined.json`: `transformers.CLIPSegForImageSegmentation`
    at the CIDAS rd64 dimensions (ViT-B/16 at 224, extract layers 3 / 6 / 9,
    reduce dim 64, 4 decoder heads, the legacy `eos_token_id=2`) with the
    refined head (`use_complex_transposed_convolution=True`): the class
    whose `from_pretrained` reads CIDAS/clipseg-rd64-refined;
  * `siglip_base_patch16_224.json`: `transformers.SiglipModel()`, whose
    defaults are google/siglip-base-patch16-224's;
  * `biomedclip.json`: the open_clip CustomTextCLIP layout of BiomedCLIP
    (timm ViT-B/16, PubMedBERT, the projections) at the port's
    `BiomedCLIPConfig()` dimensions, through the torch stub of
    `tests/test_biomed_clip.py`.

Every model is built on the meta device from explicit configuration
arguments: nothing is downloaded or allocated. It needs `transformers` (and
the repository's tests for the stub), so it runs where they are installed;
the key sets of OpenAI's RN50 and of FreeSOLO R101 are
`tests/fixtures/keysets/{clip_rn50,freesolo_r101}.json`. `--check` compares
the files with freshly built key sets and exits nonzero on a difference.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tunevlseg_torch" / "convert" / "keysets"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def clipseg_rd64_refined():
    import transformers
    from tunevlseg_torch.models.presets import clipseg_rd64_config
    c = clipseg_rd64_config(complex_head=True)
    return transformers.CLIPSegForImageSegmentation(transformers.CLIPSegConfig(
        text_config=dict(eos_token_id=2),
        vision_config=dict(patch_size=c.vision.patch_size,
                           image_size=c.vision.image_size),
        extract_layers=list(c.extract_layers), reduce_dim=c.reduce_dim,
        decoder_num_attention_heads=c.decoder_num_heads,
        decoder_intermediate_size=c.decoder_intermediate_size,
        conditional_layer=c.conditional_layer,
        use_complex_transposed_convolution=True))


def siglip_base_patch16_224():
    import transformers
    return transformers.SiglipModel(transformers.SiglipConfig())


def biomedclip():
    from tests.test_biomed_clip import _StubCLIP
    from tunevlseg_torch.models.zero_shot_ris.biomed_clip import BiomedCLIPConfig
    return _StubCLIP(BiomedCLIPConfig())


MODELS = {"clipseg_rd64_refined": clipseg_rd64_refined,
          "siglip_base_patch16_224": siglip_base_patch16_224,
          "biomedclip": biomedclip}


def keyset(name: str) -> dict[str, list[int]]:
    """{key: shape} of the state dict of `MODELS[name]`, built on meta."""
    import torch
    with torch.device("meta"):
        model = MODELS[name]()
    return {k: list(v.shape) for k, v in model.state_dict().items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the files instead of writing them")
    args = ap.parse_args(argv)
    differ = []
    for name in MODELS:
        listing = keyset(name)
        path = OUT / f"{name}.json"
        if args.check:
            if json.loads(path.read_text()) != listing:
                differ.append(name)
            continue
        OUT.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(listing, indent=0, sort_keys=True) + "\n")
        n = sum(math.prod(s) for s in listing.values())
        print(f"{name}: {len(listing)} keys, {n} values -> {path}")
    if differ:
        print(f"key sets differ from the files: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

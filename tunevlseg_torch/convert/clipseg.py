"""HF CLIPSeg checkpoints -> the JAX package's CLIPSeg parameter tree.

The port's own copy of `tunevlseg_tpu/convert/clipseg.py`: the same tree,
path for path and leaf for leaf, from the same flat state dict (numpy
values), which `convert/from_jax.py` then maps onto the port's names.

Layout conventions of the tree:
  * torch Linear weight (out, in)      -> Dense `kernel` (in, out): transposed
  * torch Embedding weight             -> Embed `embedding` (as it is)
  * torch LayerNorm weight / bias      -> `scale` / `bias`
  * Conv2d patch embedding (D, C, p, p) -> `patch_proj` (C*p*p, D)
  * Conv2d / ConvTranspose2d elsewhere -> kept in torch's layout

`load_checkpoint_params` reads HF `CLIPSegForImageSegmentation` state dicts
(`.safetensors`, `.bin`, `.pt`) and the reference's wrapper checkpoints
(prefix `model.`, plus `context_learner.*`, `additive_decoder_layer.*`,
`residual_ratio`; Lightning's `state_dict` and `net.` / `module.` prefixes
included). The CIDAS rd64-refined head (`decoder.transposed_convolution.
{0,2,4}`) converts to `head_conv`, `head_up1`, `head_up2`.

The port's CLIPSeg builds its vision tower only up to the deepest extract
layer (outside CoCoOp), so a checkpoint's later vision layers, its
`post_layernorm` and `visual_projection` have no place in it:
`CLIPSEG_ELIDABLE` names them (and the wrapper's additive head, which CoOp
and CoCoOp do not build), and `load_partial_state` drops those (and only
those) the model lacks. The zero-shot MaskedCLIP takes CLIPSeg-layout
checkpoints as the JAX `eval_zeroshot` does, without the decoder
(`MASKED_CLIP_ELIDABLE`).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np

from tunevlseg_torch.convert.checkpoint_io import (Tree, read_state_dict,
                                                   strip_prefixes)
from tunevlseg_torch.models.clip.config import (CLIPSegConfig, CLIPTextConfig,
                                                CLIPVisionConfig)

# port-name prefixes of checkpoint tensors a CLIPSeg model may not build: the
# vision tail past the early exit, and the reference wrapper's additive head,
# which CoOp and CoCoOp models do not build (they never apply it)
CLIPSEG_ELIDABLE = ("vision_model.layers.", "vision_model.post_layernorm.",
                    "visual_projection.", "additive_head.")
MASKED_CLIP_ELIDABLE = ("decoder.",)
# suffixes of checkpoint keys no converter reads: buffers and the
# contrastive head's temperature
CLIPSEG_IGNORED = ("position_ids", "logit_scale")

# transformers' CLIPSeg defaults, for a config.json that stores only the
# values that differ from them
_HF_TEXT = dict(vocab_size=49408, hidden_size=512, num_hidden_layers=12,
                num_attention_heads=8, intermediate_size=2048,
                max_position_embeddings=77, eos_token_id=49407,
                hidden_act="quick_gelu", layer_norm_eps=1e-5)
_HF_VISION = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                  intermediate_size=3072, patch_size=32, image_size=224,
                  num_channels=3, hidden_act="quick_gelu", layer_norm_eps=1e-5)
_HF_TOP = dict(projection_dim=512, extract_layers=(3, 6, 9), reduce_dim=64,
               decoder_num_attention_heads=4, decoder_intermediate_size=2048,
               conditional_layer=0, use_complex_transposed_convolution=False,
               text_config=None, vision_config=None)


def _reader(node, defaults: dict):
    """`key -> value` of a config given as a mapping (config.json) or an
    object with the same attributes, with `defaults` for what it lacks."""
    def get(key):
        if isinstance(node, Mapping):
            value = node.get(key)
        else:
            value = getattr(node, key, None)
        return defaults[key] if value is None else value
    return get


def config_from_hf(hf_config) -> CLIPSegConfig:
    """The port's static config from a `transformers.CLIPSegConfig`, or from
    the mapping of its `config.json` (transformers' defaults where it stores
    nothing)."""
    top = _reader(hf_config, _HF_TOP)
    t = _reader(top("text_config") or {}, _HF_TEXT)
    v = _reader(top("vision_config") or {}, _HF_VISION)
    return CLIPSegConfig(
        text=CLIPTextConfig(
            vocab_size=t("vocab_size"), hidden_size=t("hidden_size"),
            num_layers=t("num_hidden_layers"), num_heads=t("num_attention_heads"),
            intermediate_size=t("intermediate_size"),
            max_position_embeddings=t("max_position_embeddings"),
            eos_token_id=t("eos_token_id"), hidden_act=t("hidden_act"),
            layer_norm_eps=t("layer_norm_eps")),
        vision=CLIPVisionConfig(
            hidden_size=v("hidden_size"), num_layers=v("num_hidden_layers"),
            num_heads=v("num_attention_heads"),
            intermediate_size=v("intermediate_size"), patch_size=v("patch_size"),
            image_size=v("image_size"), num_channels=v("num_channels"),
            hidden_act=v("hidden_act"), layer_norm_eps=v("layer_norm_eps")),
        projection_dim=top("projection_dim"),
        extract_layers=tuple(top("extract_layers")),
        reduce_dim=top("reduce_dim"),
        decoder_num_heads=top("decoder_num_attention_heads"),
        decoder_intermediate_size=top("decoder_intermediate_size"),
        conditional_layer=top("conditional_layer"),
        complex_transposed_convolution=bool(
            top("use_complex_transposed_convolution")),
    )


def _dense(tree: Tree, dst: str, sd: Mapping[str, np.ndarray], src: str) -> None:
    tree.set(f"{dst}/kernel", sd[f"{src}.weight"].T)
    if f"{src}.bias" in sd:
        tree.set(f"{dst}/bias", sd[f"{src}.bias"])


def _layer_norm(tree: Tree, dst: str, sd, src: str) -> None:
    tree.set(f"{dst}/scale", sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        tree.set(f"{dst}/bias", sd[f"{src}.bias"])


def _encoder_layer(tree: Tree, dst: str, sd, src: str) -> None:
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(tree, f"{dst}/self_attn/{proj}", sd, f"{src}.self_attn.{proj}")
    _layer_norm(tree, f"{dst}/layer_norm1", sd, f"{src}.layer_norm1")
    _layer_norm(tree, f"{dst}/layer_norm2", sd, f"{src}.layer_norm2")
    _dense(tree, f"{dst}/mlp/fc1", sd, f"{src}.mlp.fc1")
    _dense(tree, f"{dst}/mlp/fc2", sd, f"{src}.mlp.fc2")


def _split_qkv(tree: Tree, dst: str, w: np.ndarray, b: Optional[np.ndarray]) -> None:
    """A packed (3D, D) in-projection -> q / k / v Dense leaves."""
    d = w.shape[0] // 3
    for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
        tree.set(f"{dst}/{name}/kernel", w[j * d:(j + 1) * d].T)
        if b is not None:
            tree.set(f"{dst}/{name}/bias", b[j * d:(j + 1) * d])


def _packed_mha(tree: Tree, dst: str, sd, src: str) -> None:
    """torch nn.MultiheadAttention (packed in-projection) -> q / k / v / out."""
    _split_qkv(tree, dst, sd[f"{src}.in_proj_weight"], sd.get(f"{src}.in_proj_bias"))
    _dense(tree, f"{dst}/out_proj", sd, f"{src}.out_proj")


def convert_hf_clipseg(sd: Mapping[str, np.ndarray],
                       config: CLIPSegConfig) -> dict[str, Any]:
    """A `CLIPSegForImageSegmentation` state dict (numpy values) -> tree."""
    t = Tree()

    tm = "clip.text_model"
    t.set("text_model/token_embedding/embedding",
          sd[f"{tm}.embeddings.token_embedding.weight"])
    t.set("text_model/position_embedding/embedding",
          sd[f"{tm}.embeddings.position_embedding.weight"])
    for i in range(config.text.num_layers):
        _encoder_layer(t, f"text_model/layers_{i}", sd, f"{tm}.encoder.layers.{i}")
    _layer_norm(t, "text_model/final_layer_norm", sd, f"{tm}.final_layer_norm")

    vm = "clip.vision_model"
    t.set("vision_model/class_embedding", sd[f"{vm}.embeddings.class_embedding"])
    t.set("vision_model/position_embedding",
          sd[f"{vm}.embeddings.position_embedding.weight"])
    pw = sd[f"{vm}.embeddings.patch_embedding.weight"]   # (D, C, p, p)
    t.set("vision_model/patch_proj", pw.reshape(pw.shape[0], -1).T)
    _layer_norm(t, "vision_model/pre_layernorm", sd, f"{vm}.pre_layrnorm")
    for i in range(config.vision.num_layers):
        _encoder_layer(t, f"vision_model/layers_{i}", sd, f"{vm}.encoder.layers.{i}")
    _layer_norm(t, "vision_model/post_layernorm", sd, f"{vm}.post_layernorm")

    _dense(t, "text_projection", sd, "clip.text_projection")
    _dense(t, "visual_projection", sd, "clip.visual_projection")

    _dense(t, "decoder/film_mul", sd, "decoder.film_mul")
    _dense(t, "decoder/film_add", sd, "decoder.film_add")
    for i in range(len(config.extract_layers)):
        _dense(t, f"decoder/reduces_{i}", sd, f"decoder.reduces.{i}")
        _encoder_layer(t, f"decoder/layers_{i}", sd, f"decoder.layers.{i}")
    head = "decoder.transposed_convolution"
    if config.complex_transposed_convolution:
        for dst, index in (("head_conv", 0), ("head_up1", 2), ("head_up2", 4)):
            t.set(f"decoder/{dst}/weight", sd[f"{head}.{index}.weight"])
            t.set(f"decoder/{dst}/bias", sd[f"{head}.{index}.bias"])
    else:
        t.set("decoder/head_up/weight", sd[f"{head}.weight"])
        t.set("decoder/head_up/bias", sd[f"{head}.bias"])
    return t


def _mlp_projector(t: Tree, dst: str, sd, src: str) -> None:
    """The reference's `get_mlp_projection` Sequential -> MLPProjector names.

    Sequential indices: [Linear, ReLU]*k, Linear, (LayerNorm). A bare Linear
    (no Sequential, intermediate_dim None) has its tensors at `src`."""
    if f"{src}.weight" in sd:
        _dense(t, f"{dst}/out", sd, src)
        return
    idxs = sorted({int(k[len(src) + 1:].split(".")[0])
                   for k in sd if k.startswith(f"{src}.")})
    linear = [i for i in idxs if f"{src}.{i}.weight" in sd
              and sd[f"{src}.{i}.weight"].ndim == 2]
    norms = [i for i in idxs if f"{src}.{i}.weight" in sd
             and sd[f"{src}.{i}.weight"].ndim == 1]
    for j, i in enumerate(linear[:-1]):
        _dense(t, f"{dst}/hidden_{j}", sd, f"{src}.{i}")
    _dense(t, f"{dst}/out", sd, f"{src}.{linear[-1]}")
    for i in norms:
        _layer_norm(t, f"{dst}/norm", sd, f"{src}.{i}")


def _torch_transformer_layer(t: Tree, dst: str, sd, src: str) -> None:
    """torch.nn.TransformerEncoderLayer -> TorchTransformerEncoderLayer."""
    _split_qkv(t, f"{dst}/self_attn", sd[f"{src}.self_attn.in_proj_weight"],
               sd.get(f"{src}.self_attn.in_proj_bias"))
    _dense(t, f"{dst}/self_attn/out_proj", sd, f"{src}.self_attn.out_proj")
    _dense(t, f"{dst}/linear1", sd, f"{src}.linear1")
    _dense(t, f"{dst}/linear2", sd, f"{src}.linear2")
    _layer_norm(t, f"{dst}/norm1", sd, f"{src}.norm1")
    _layer_norm(t, f"{dst}/norm2", sd, f"{src}.norm2")


def _indices(sd, prefix: str) -> list[int]:
    """The sorted integers that follow `prefix` in the keys of `sd`."""
    return sorted({int(k[len(prefix):].split(".")[0]) for k in sd
                   if k.startswith(prefix)})


def convert_context_learner(sd: Mapping[str, np.ndarray], strategy: str,
                            prefix: str = "context_learner") -> dict[str, Any]:
    """The reference's context learner (any of the six strategies) -> the
    learner subtree."""
    t = Tree()
    t.set("context_vectors", sd[f"{prefix}.context_vectors"])
    projections = _indices(sd, f"{prefix}.projection_layers.")
    if strategy in ("cocoop", "maple"):
        for i in projections:
            _mlp_projector(t, f"proj_{i}", sd, f"{prefix}.projection_layers.{i}")
    elif strategy == "shared_separate":
        for i in _indices(sd, f"{prefix}.textual_projection_layers."):
            _mlp_projector(t, f"text_proj_{i}", sd,
                           f"{prefix}.textual_projection_layers.{i}")
            _mlp_projector(t, f"visual_proj_{i}", sd,
                           f"{prefix}.visual_projection_layers.{i}")
    elif strategy == "shared_attn":
        for i in projections:
            _torch_transformer_layer(t, f"proj_{i}", sd,
                                     f"{prefix}.projection_layers.{i}")
    return t


def convert_reference_wrapper(sd: Mapping[str, np.ndarray],
                              config: CLIPSegConfig,
                              strategy: Optional[str] = None) -> dict[str, Any]:
    """The reference's whole wrapper (a BaseCLIPSeg subclass): `model.*`
    (HF CLIPSeg), `context_learner.*` (with a strategy), the additive head
    and `residual_ratio`."""
    inner = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    params = convert_hf_clipseg(inner, config)
    if strategy is not None and any(k.startswith("context_learner.") for k in sd):
        params["learner"] = convert_context_learner(sd, strategy)
    if "residual_ratio" in sd:
        params["residual_ratio"] = sd["residual_ratio"]
    if "additive_decoder_layer.1.weight" in sd:
        params.setdefault("additive_head", {})["conv"] = {
            "weight": sd["additive_decoder_layer.1.weight"],
            "bias": sd["additive_decoder_layer.1.bias"],
        }
    return params


def clipseg_layout(sd: Mapping[str, np.ndarray]) -> bool:
    """Whether `sd` (prefixes stripped) is a CLIPSeg checkpoint: HF's
    `clip.*` + `decoder.*`, or the reference wrapper's `model.*`."""
    return (any(k.startswith("model.") for k in sd)
            or "clip.text_model.embeddings.token_embedding.weight" in sd)


def read_clipseg_state_dict(path) -> dict[str, np.ndarray]:
    """The flat state dict of a CLIPSeg checkpoint file, as the JAX
    `load_checkpoint_params` reads it: Lightning's `state_dict` unwrapped,
    `net.` and `module.` stripped."""
    return strip_prefixes(read_state_dict(path), ("net.", "module."))


def load_checkpoint_params(path, config: CLIPSegConfig,
                           strategy: Optional[str] = None,
                           sd: Optional[Mapping[str, np.ndarray]] = None
                           ) -> dict[str, Any]:
    """A CLIPSeg checkpoint file (`.safetensors`, `.bin`, `.pt`, `.pth`,
    `.ckpt`) -> tree: the reference wrapper when any key starts with
    `model.`, else an HF state dict. `sd`: the file's state dict, already
    read."""
    if sd is None:
        sd = read_clipseg_state_dict(path)
    if any(k.startswith("model.") for k in sd):
        return convert_reference_wrapper(sd, config, strategy)
    return convert_hf_clipseg(sd, config)

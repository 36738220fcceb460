"""JAX param, trainable and gradient trees -> the port's parameter names.

The JAX package's parameters (a nested dict of arrays, as `model.init` or
its checkpoint converters give them) map onto the port's parameter names
mechanically:

  * path components `layers_3` / `reduces_0` / `resblocks_3` / `layer2_1` /
    `decoder_layers_2` / `decoder_1` / `blocks_4` / `res4_22` -> `layers.3` /
    `reduces.0` / `resblocks.3` / `layer2.1` / `decoder_layers.2` /
    `decoder.1` / `blocks.4` / `res4.22`; every
    other module name is the port's own (the TransformerSegmentor's
    `block0_conv`, `block0_norm`, `out_conv`, SigLIP's `head`, `head_attn`,
    `head_layernorm`, `head_mlp_fc1` / `fc2`; DenseCLIP's `attnpool`,
    `memory_proj_{0,1,2}`, `text_proj_{0,1}`, `out_proj_{0,1}`, `mlp_{0,3}`,
    `lateral_{i}`, `output_{i}`, `scale_head_{i}`, `scale_gn_{i}`,
    `fpn{1..4}_gn`, `fpn1_bn`, `fpn{1,2}_deconv*`, `cls_seg`; SOLOv2's
    `stem_conv1`, `fpn_lateral{i}`, `{cate,kernel}_tower_{i}`,
    `level{i}_conv{j}`, `conv_pred_*`; BiomedCLIP's `visual_head`,
    `text_proj_fc{1,2}`, `embed_norm`);
  * Flax `Dense.kernel` (in, out) -> `weight` (out, in), transposed;
  * `LayerNorm.scale` -> `weight` (the upsampler's sample LayerNorm keeps
    its (C, H, W) shape), `GroupNorm.scale` -> `weight`;
    `Embed.embedding` -> `weight`;
  * everything else (`bias`, convolution `weight` in OIHW, ConvTranspose
    `weight`, BatchNorm `weight` / `bias`, `patch_proj` in its channel-major
    (C*p*p, D) layout, `class_embedding`, `position_embedding`,
    `positional_embedding`, `text_projection`, `context_vectors`,
    `residual_ratio`, SigLIP's `patch_bias` and `probe`, DenseCLIP's
    `contexts`, `gamma` and the ViT's `proj`, BiomedCLIP's `cls_token` and
    `token_type_embedding`, and SOLOv2's FrozenBN `running_mean` /
    `running_var`, which are parameters in both packages) is copied as it is;
  * the `batch_stats` collection (`running_mean`, `running_var` of every
    BatchNorm, under the same module paths) fills the port's buffers, and
    the JAX `TrainState.model_state` (that collection, as a train step
    updates it) maps to the port's `TrainState.model_state` and back.

Flax creates parameters only for the modules a forward calls, and the port
builds the same set (see `models/clip/vision.py`): with the early exit there
are no vision layers past max(extract_layers), no `post_layernorm` and no
`visual_projection`, and text-only prompting has no `additive_head`. So the
mapping skips nothing: it raises on a leaf it cannot place and on a port
parameter or buffer it leaves unfilled.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(
    r"(layers|decoder_layers|decoder|reduces|resblocks|blocks|layer\d+|res\d)_(\d+)")
_RENAMED_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_COPIED_LEAVES = {"bias", "weight", "class_embedding", "position_embedding",
                  "positional_embedding", "text_projection", "patch_proj",
                  "context_vectors", "residual_ratio", "running_mean",
                  "running_var", "patch_bias", "probe", "contexts", "gamma",
                  "proj", "cls_token", "token_type_embedding"}


def flatten_params(params: Mapping[str, Any], prefix: tuple = ()) -> dict:
    """Nested mapping -> {path tuple: leaf}."""
    out = {}
    for key, value in params.items():
        if isinstance(value, Mapping):
            out.update(flatten_params(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def port_name(path: tuple[str, ...]) -> tuple[str, bool]:
    """JAX param path -> (port state_dict name, whether to transpose)."""
    *modules, leaf = path
    if leaf not in _RENAMED_LEAVES and leaf not in _COPIED_LEAVES:
        raise KeyError(f"no mapping for JAX leaf {'/'.join(path)}")
    parts = []
    for m in modules:
        match = _INDEXED.fullmatch(m)
        parts.extend(match.groups() if match else (m,))
    return ".".join(parts + [_RENAMED_LEAVES.get(leaf, leaf)]), leaf == "kernel"


def _tensor(leaf, transpose: bool) -> torch.Tensor:
    arr = np.asarray(leaf, dtype=np.float32)
    return torch.from_numpy(np.array(arr.T if transpose else arr, order="C"))


def tensors_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Every leaf of a JAX tree (a converted checkpoint, say) as an f32 CPU
    tensor under its port name, transposed where the name map says, with no
    model to check the names against. `None` leaves are skipped."""
    out = {}
    for path, leaf in flatten_params(tree).items():
        if leaf is not None:
            name, transpose = port_name(path)
            out[name] = _tensor(leaf, transpose)
    return out


def trainable_from_jax(tree: Mapping[str, Any],
                       model: nn.Module) -> dict[str, torch.Tensor]:
    """A JAX trainable, gradient or full param tree -> f32 CPU tensors under
    `model`'s parameter names, with the same transposes as the weights (a
    gradient has its parameter's layout). `None` leaves (the frozen places
    of a trainable tree) are skipped. Raises on unmapped leaves and shape
    mismatches."""
    expected = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for path, leaf in flatten_params(tree).items():
        if leaf is None:
            continue
        name, transpose = port_name(path)
        if name not in expected:
            raise KeyError(f"JAX leaf {'/'.join(path)} maps to {name!r}, "
                           "which the port model does not have")
        tensor = _tensor(leaf, transpose)
        if tuple(tensor.shape) != expected[name]:
            raise ValueError(f"{'/'.join(path)} -> {name}: shape "
                             f"{tuple(tensor.shape)} != {expected[name]}")
        out[name] = tensor
    return out


def state_dict_from_jax(params: Mapping[str, Any], model: nn.Module,
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> dict[str, torch.Tensor]:
    """f32 CPU tensors under `model`'s parameter and buffer names, for
    `model.load_state_dict`; `batch_stats` is the JAX collection of that name
    (the BatchNorm running statistics). Raises on unmapped leaves, shape
    mismatches and unfilled port parameters or buffers."""
    out = trainable_from_jax(params, model)
    if batch_stats:
        stats = trainable_from_jax(batch_stats, model)
        clash = sorted(set(stats) & set(out))
        if clash:
            raise KeyError(f"batch_stats leaves name parameters: {clash}")
        out.update(stats)
    unfilled = sorted(set(model.state_dict()) - set(out))
    if unfilled:
        raise KeyError(f"port parameters left unfilled: {unfilled}")
    return out


def model_state_from_jax(model_state: Mapping[str, Any],
                         model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX task's `TrainState.model_state` ({"batch_stats": tree}, or {}
    without mutable collections) -> the port's: f32 CPU tensors under
    `model`'s buffer names."""
    return trainable_from_jax(model_state.get("batch_stats", {}), model)


def model_state_to_jax(model_state: Mapping[str, torch.Tensor]) -> dict:
    """The port's `TrainState.model_state` -> the JAX task's: numpy arrays in
    the nested `batch_stats` tree ('neck.f2_cat.bn.running_var' ->
    neck / f2_cat / bn / running_var, 'visual.layer2.1.bn1.running_mean' ->
    visual / layer2_1 / bn1 / running_mean)."""
    tree: dict = {}
    for name, value in model_state.items():
        path: list[str] = []
        for part in name.split("."):
            if part.isdigit() and path:
                path[-1] = f"{path[-1]}_{part}"
            else:
                path.append(part)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.detach().cpu().numpy()
    return {"batch_stats": tree} if tree else {}


def simple_dense_net_state_dict(variables: Mapping[str, Any],
                                model: nn.Module) -> dict[str, torch.Tensor]:
    """The JAX `SimpleDenseNet` variables ({"params": lin{i} kernel / bias,
    bn{i} scale / bias, head kernel / bias; "batch_stats": bn{i} mean /
    var}) -> the port net's `state_dict`: kernels transposed, `scale` as
    `weight`, the statistics as the `running_mean` / `running_var`
    buffers."""
    stats = {module: {{"mean": "running_mean", "var": "running_var"}[k]: v
                      for k, v in leaves.items()}
             for module, leaves in variables.get("batch_stats", {}).items()}
    return state_dict_from_jax(variables["params"], model, stats)

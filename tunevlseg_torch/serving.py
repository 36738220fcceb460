"""Serving: the pure inference function of a SegmentationTask, and its
ahead-of-time export (`torch.export`) into programs that a server runs
without the model's Python code.

Counterpart of `tunevlseg_tpu/serving.py`, under its names:

  * `task_predict_fn(task)`: (params, batch) -> sigmoid probabilities. The
    weights are an argument, a mapping from the model's `state_dict` names
    to tensors (parameters and buffers such as the BatchNorm running
    statistics alike, e.g. `dict(model.state_dict())` or the result of
    `tunevlseg_torch.convert.from_jax.state_dict_from_jax`).
  * `export_fn(fn, example_args, out_dir, platforms)`: traces `fn` at the
    shapes and dtypes of `example_args` (their values are never read: fake
    tensors, `meta` tensors or any tensor of the right shape will do) and
    writes one program per platform, `<name>.<platform>.pt2`
    (`torch.export.save`), and `meta.json`. Exporting for "cuda" traces the
    port's kernels as the `tunevlseg::` ops of `ops/library.py`; exporting
    for "cpu" traces their plain versions (the wrappers take those for CPU
    tensors), so `platforms=("cuda", "cpu")` gives the pair that
    `jax.export` lowers into one artifact.
  * `load_fn(out_dir, name, device)`: the program for `device` as a
    callable (params, batch) -> probabilities. It imports
    `tunevlseg_torch.ops.library` (the ops' registrations; the kernels are
    built at their first launch) and nothing of `tunevlseg_torch.models`,
    and raises for a platform that was not exported.
  * `export_task_predict(task, state_or_params, example_batch, out_dir)`.

The weights stay outside the programs: a program takes them as call
arguments, so it is far smaller than the weights it serves, and one export
serves every checkpoint of its model. Shapes are static: export one program
per batch size, as the JAX package exports one artifact per bucket.
`meta.json` holds the torch version, the platforms, the in and out specs
(with the names of the weights and of the batch's keys, which the loaded
callable passes in that order), the largest program's bytes
(`graph_bytes`), `kind`, `model` and the `tunevlseg::` ops each program
calls.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Callable, Mapping, Optional, Sequence

import torch
from torch.func import functional_call
from torch.utils._pytree import tree_map_only

GRAPH_SUFFIX = ".pt2"
PLATFORMS = ("cuda", "cpu")
# the batch entries a SegmentationTask's model reads (`task.model_inputs`)
BATCH_KEYS = ("image", "input_ids", "attention_mask", "text_index")


def task_predict_fn(task) -> Callable[[Mapping[str, torch.Tensor], dict], torch.Tensor]:
    """(params, batch) -> (B, 1, H, W) f32 probabilities. `params` must name
    every parameter and every buffer of `task.model`."""

    @torch.no_grad()
    def predict(params: Mapping[str, torch.Tensor], batch: dict) -> torch.Tensor:
        args, kwargs = task.model_inputs(batch)
        logits = functional_call(task.model, dict(params), args, kwargs,
                                 strict=True)
        return torch.sigmoid(logits.float())

    return predict


class _Call(torch.nn.Module):
    """`fn` as the module `torch.export` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _leaves(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, Mapping):
        return [x for k, v in tree.items() for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _example_on(example_args: tuple, device: str, mode) -> tuple:
    """Fake tensors of the example tensors' shapes, strides and dtypes on
    `device` (made in the fake mode `mode`: nothing is allocated or read)."""
    def fake(x):
        with mode:
            return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                       device=device)
    return tree_map_only(torch.Tensor, fake, example_args)


def _spec(path: str, x) -> dict:
    return {"name": path, "shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", "")}


def graph_ops(module: torch.nn.Module) -> list[str]:
    """The `tunevlseg::` ops that a graph module and the graphs nested in it
    (a `torch.no_grad` region is a submodule of its own) call, by name."""
    return sorted({str(n.target).split(".")[1]
                   for m in module.modules() if isinstance(m, torch.fx.GraphModule)
                   for n in m.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("tunevlseg.")})


def default_platform() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def program_path(out_dir, name: str, platform: str) -> pathlib.Path:
    return pathlib.Path(out_dir) / f"{name}.{platform}{GRAPH_SUFFIX}"


def export_fn(fn: Callable, example_args: tuple, out_dir,
              platforms: Optional[Sequence[str]] = None,
              name: str = "predict", extra_meta: Optional[dict] = None
              ) -> pathlib.Path:
    """Trace `fn` at `example_args`' shapes and dtypes for each of
    `platforms` ("cuda", "cpu"; default: the card if there is one, else the
    CPU) and write the programs and `meta.json` to `out_dir`; returns the
    path of the first platform's program. The example tensors' values are
    never read (nor their devices: each platform traces on fake tensors of
    its own)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plats = tuple(platforms) if platforms else (default_platform(),)
    unknown = [p for p in plats if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown}: the port exports for {PLATFORMS}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    example_args = tuple(example_args)
    graph_bytes, ops, out_specs = 0, {}, None
    for plat in plats:
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        program = torch.export.export(_Call(fn), _example_on(example_args, plat, mode))
        program.example_inputs = None     # fake tensors: nothing to keep
        path = program_path(out, name, plat)
        torch.export.save(program, path)
        graph_bytes = max(graph_bytes, path.stat().st_size)
        ops[plat] = graph_ops(program.graph_module)
        if out_specs is None:
            outs = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
            out_specs = [_spec(str(i), o.meta["val"]) for i, o in enumerate(outs)]
    meta = {
        "name": name,
        "torch_version": torch.__version__,
        "platforms": list(plats),
        "in_specs": [_spec(p, x) for p, x in _leaves(example_args)
                     if isinstance(x, torch.Tensor)],
        "out_specs": out_specs,
        "graph_bytes": graph_bytes,
        "tunevlseg_ops": ops,
    }
    if extra_meta:
        meta.update(extra_meta)
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return program_path(out, name, plats[0])


def read_meta(out_dir) -> dict:
    return json.loads((pathlib.Path(out_dir) / "meta.json").read_text())


def load_fn(out_dir, name: str = "predict", device=None) -> Callable:
    """The exported program of `out_dir` for `device` (default: the card if
    there is one, else the CPU) as a callable. An export of
    `export_task_predict` is called as predict(params, batch): the weights
    and the batch entries named in `meta.json` are taken from the mappings
    in the exported order (other entries are ignored). Raises for a
    platform that was not exported."""
    import tunevlseg_torch.ops.library  # noqa: F401  (the ops the programs call)

    platform = torch.device(device).type if device is not None else default_platform()
    meta = read_meta(out_dir)
    if platform not in meta["platforms"]:
        raise ValueError(f"{out_dir} holds programs for {meta['platforms']}, "
                         f"not for {platform!r}")
    module = torch.export.load(program_path(out_dir, name, platform)).module()
    if meta.get("kind") != "segmentation_task_predict":
        return module
    param_names = [s["name"][len("0."):] for s in meta["in_specs"]
                   if s["name"].startswith("0.")]
    batch_keys = [s["name"][len("1."):] for s in meta["in_specs"]
                  if s["name"].startswith("1.")]

    def predict(params: Mapping[str, torch.Tensor], batch: Mapping) -> torch.Tensor:
        return module({k: params[k] for k in param_names},
                      {k: batch[k] for k in batch_keys})

    predict.module = module
    predict.meta = meta
    return predict


def serving_batch(batch: Mapping) -> dict:
    """The entries of a batch that the model reads (`BATCH_KEYS`)."""
    return {k: batch[k] for k in BATCH_KEYS if k in batch}


def export_task_predict(task, state_or_params, example_batch: dict, out_dir,
                        platforms: Optional[Sequence[str]] = None,
                        name: str = "predict") -> pathlib.Path:
    """Export a SegmentationTask's inference step (`task_predict_fn`).
    `state_or_params` is a `TrainState` or a params mapping; only the names,
    shapes and dtypes of the model's parameters and buffers are read (a
    TrainState's optimizer state does not enter the program's signature),
    and of the batch only the entries the model reads."""
    if isinstance(state_or_params, Mapping):
        params = dict(state_or_params)
    else:
        params = dict(task.model.state_dict())
    return export_fn(
        task_predict_fn(task), (params, serving_batch(example_batch)), out_dir,
        platforms=platforms, name=name,
        extra_meta={"kind": "segmentation_task_predict",
                    "model": type(task.model).__name__})

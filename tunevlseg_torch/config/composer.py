"""Hydra-compatible YAML config composition (self-contained).

Hydra is not a dependency, so the framework ships a small composer
implementing the subset of Hydra 1.3 semantics the reference's
experiment surface uses (SURVEY §5.6):

  * a root config with a `defaults` list: `- group: option` entries load
    `<config_dir>/<group>/<option>.yaml` into the `group` subtree,
    `- _self_` controls merge order, `- override /group: option` (inside
    experiment overlays) replaces an earlier selection;
  * `# @package _global_` overlays (the `experiment=` mechanism) merging at
    the root;
  * `${a.b.c}` interpolation, plus the reference's custom resolvers
    `${env:VAR}`, `${literal_eval:...}` and `${import_eval:dotted.path}`
    (src/utils/resolvers.py:51-77) and `${oc.env:...}`;
  * CLI dotlist overrides `a.b=v`, `+a.b=v` (add), `~a.b` (delete), and
    group selection `group=option` / `experiment=name`;
  * `_target_` / `_partial_` instantiation (config/instantiate.py).

Values parse as YAML scalars (so `lr=2e-4` is a float, `flag=true` a bool).

The port's own copy of `tunevlseg_tpu/config/composer.py`; `yaml` is
imported at first use.
"""
from __future__ import annotations

import ast
import copy
import importlib
import os
import re
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence, Union

MISSING = "???"
_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


# ---------------------------------------------------------------------------
# basic tree ops
# ---------------------------------------------------------------------------

def deep_merge(base: dict, overlay: Mapping) -> dict:
    """Merge overlay into base (overlay wins; dicts merge recursively)."""
    for k, v in overlay.items():
        if (k in base and isinstance(base[k], dict)
                and isinstance(v, Mapping)):
            deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def set_by_path(cfg: dict, path: str, value: Any, create: bool = True) -> None:
    node = cfg
    parts = path.split(".")
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if not create:
                raise KeyError(f"no such config path: {path}")
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def get_by_path(cfg: Mapping, path: str) -> Any:
    node: Any = cfg
    for p in path.split("."):
        if isinstance(node, Mapping) and p in node:
            node = node[p]
        elif isinstance(node, (list, tuple)) and p.lstrip("-").isdigit():
            node = node[int(p)]
        else:
            raise KeyError(path)
    return node


def delete_by_path(cfg: dict, path: str) -> None:
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node[p]
    node.pop(parts[-1], None)


# ---------------------------------------------------------------------------
# resolvers
# ---------------------------------------------------------------------------

def _import_from_path(dotted: str) -> Any:
    module_name, _, attr_chain = dotted.partition(".")
    obj = importlib.import_module(module_name)
    parts = attr_chain.split(".") if attr_chain else []
    for i, attr in enumerate(parts):
        try:
            obj = getattr(obj, attr)
        except AttributeError:
            # maybe a deeper module: import progressively
            obj = importlib.import_module(
                module_name + "." + ".".join(parts[:i + 1]))
    return obj


def _resolve_expr(expr: str, root: Mapping) -> Any:
    expr = expr.strip()
    if ":" in expr:
        name, _, arg = expr.partition(":")
        name = name.strip()
        arg = arg.strip()
        if name in ("env", "oc.env"):
            default = None
            if "," in arg:
                arg, _, default = [s.strip() for s in arg.partition(",")]
            return os.environ.get(arg, default)
        if name == "literal_eval":
            return ast.literal_eval(_interp_str(arg, root))
        if name == "import_eval":
            return _import_from_path(_interp_str(arg, root))
        raise ValueError(f"unknown resolver: {name}")
    return get_by_path(root, expr)


def _interp_str(s: str, root: Mapping) -> Any:
    """Resolve interpolations inside a string; full-string interpolation
    preserves the referenced value's type."""
    m = _INTERP_RE.fullmatch(s.strip())
    if m:
        return _resolve_expr(m.group(1), root)

    def sub(match):
        v = _resolve_expr(match.group(1), root)
        return "" if v is None else str(v)

    return _INTERP_RE.sub(sub, s)


def resolve(cfg: Any, root: Optional[Mapping] = None, _depth: int = 0) -> Any:
    """Eagerly resolve all interpolations (iterating until fixpoint)."""
    if root is None:
        for _ in range(10):
            before = repr(cfg)
            cfg = resolve(cfg, cfg)
            if repr(cfg) == before:
                return cfg
        return cfg
    if isinstance(cfg, dict):
        return {k: resolve(v, root) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [resolve(v, root) for v in cfg]
    if isinstance(cfg, str) and "${" in cfg:
        try:
            return _interp_str(cfg, root)
        except KeyError:
            return cfg  # target may appear in a later pass
    return cfg


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def _load_yaml(path: Path) -> tuple[dict, bool]:
    """Returns (content, is_global_package)."""
    import yaml
    text = path.read_text()
    is_global = bool(re.search(r"^#\s*@package\s+_global_", text, re.M))
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise TypeError(f"{path}: top level must be a mapping")
    return data, is_global


def _parse_override(s: str):
    if s.startswith("~"):
        return ("del", s[1:], None)
    add = s.startswith("+")
    if add:
        s = s[1:]
    if "=" not in s:
        raise ValueError(f"override must be key=value: {s}")
    import yaml
    key, _, raw = s.partition("=")
    value = yaml.safe_load(raw) if raw != "" else None
    if isinstance(value, str):
        # YAML 1.1 misses bare scientific notation ("1e-3"); coerce it
        if re.fullmatch(r"[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+", value):
            value = float(value)
    return ("add" if add else "set", key, value)


class Composer:
    def __init__(self, config_dir: Union[str, Path]):
        self.config_dir = Path(config_dir)

    def _group_file(self, group: str, option: str) -> Path:
        return self.config_dir / group.strip("/") / f"{option}.yaml"

    def compose(self, config_name: str = "train",
                overrides: Sequence[str] = ()) -> dict:
        parsed = [_parse_override(o) for o in overrides]

        # group selections from the CLI (e.g. experiment=x, trainer=cpu)
        selections: dict[str, str] = {}
        value_overrides = []
        for op, key, val in parsed:
            if (op == "set" and isinstance(val, str) and "." not in key
                    and self._group_file(key, val).exists()):
                selections[key] = val
            else:
                value_overrides.append((op, key, val))

        root_file = self.config_dir / f"{config_name}.yaml"
        root_data, _ = _load_yaml(root_file)
        defaults = root_data.pop("defaults", [])

        cfg: dict = {}
        self_merged = False
        global_overlays: list[dict] = []
        # the `local/` group (machine-specific overrides, reference
        # configs/local/) always merges LAST — after experiment overlays,
        # whatever their order in the defaults list; only explicit CLI
        # value overrides beat it
        late_overlays: list[dict] = []
        used_groups: set[str] = set()

        def include(group_path: str):
            """String defaults entry: include another config file, merging
            into the subtree named by its first path segment."""
            path = self.config_dir / f"{group_path}.yaml"
            data, is_global = _load_yaml(path)
            sub_defaults = data.pop("defaults", [])
            top = group_path.split("/")[0]
            for sub in sub_defaults:
                if sub == "_self_":
                    continue
                handle_entry(sub, base_group="/".join(
                    group_path.split("/")[:-1]))
            if is_global:
                global_overlays.append(data)
            else:
                deep_merge(cfg, {top: data})

        def handle_entry(entry, base_group=""):
            nonlocal self_merged
            if entry == "_self_":
                deep_merge(cfg, root_data)
                self_merged = True
                return
            if isinstance(entry, str):
                if entry.startswith("/"):
                    include(entry.strip("/"))
                elif base_group:
                    include(f"{base_group}/{entry}")
                else:
                    include(entry)
                return
            (key, option), = entry.items()
            optional = False
            if isinstance(key, str) and key.startswith("optional "):
                optional = True
                key = key[len("optional "):]
            is_override = isinstance(key, str) and key.startswith("override")
            if is_override:
                key = key.split(None, 1)[1]
            group = key.strip("/")
            if option is None:
                return
            # CLI group selections win over both defaults AND experiment
            # overrides (Hydra priority); consult without popping so a later
            # `override /group` entry still sees the CLI choice
            option = selections.get(group, option)
            used_groups.add(group)
            path = self._group_file(group, option)
            if not path.exists():
                if optional:
                    return
                raise FileNotFoundError(path)
            data, is_global = _load_yaml(path)
            sub_defaults = data.pop("defaults", [])
            if is_override and not is_global:
                # Hydra: an override REPLACES the earlier group selection
                # (the option file's own defaults re-include any base)
                cfg[group.split("/")[0]] = {}
            for sub in sub_defaults:
                if sub == "_self_":
                    continue
                handle_entry(sub, base_group=group)
            if group.split("/")[0] == "local":
                late_overlays.append(data if is_global else data or {})
            elif is_global:
                global_overlays.append(data)
            else:
                deep_merge(cfg, {group.split("/")[0]: data})

        for entry in defaults:
            handle_entry(entry)
        if not self_merged:
            deep_merge(cfg, root_data)
        # group selections with no matching defaults entry (e.g.
        # `experiment=...`): processed with full defaults handling, so
        # `override /model: x` inside an experiment overlay takes effect
        for group, option in list(selections.items()):
            if group not in used_groups:
                handle_entry({group: option})
        for overlay in global_overlays:
            deep_merge(cfg, overlay)
        for overlay in late_overlays:
            deep_merge(cfg, overlay)

        for op, key, val in value_overrides:
            if op == "del":
                delete_by_path(cfg, key)
            else:
                set_by_path(cfg, key, val, create=True)

        cfg = resolve(cfg)
        _check_missing(cfg)
        return cfg


def _check_missing(cfg: Any, path: str = "") -> None:
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            _check_missing(v, f"{path}.{k}" if path else str(k))
    elif isinstance(cfg, list):
        for i, v in enumerate(cfg):
            _check_missing(v, f"{path}.{i}")
    elif cfg in ("???", "??"):
        raise ValueError(f"missing mandatory config value: {path}")


def compose(config_dir: Union[str, Path], config_name: str = "train",
            overrides: Sequence[str] = ()) -> dict:
    return Composer(config_dir).compose(config_name, overrides)

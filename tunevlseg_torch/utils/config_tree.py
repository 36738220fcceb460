"""Run-start config UX: tree printing + tag enforcement (the reference's
`extras` hooks, src/utils/rich_utils.py:23-88 / utils.py:30-50, without the
rich dependency — this image has none, so the tree renders with plain
box-drawing characters).

Driven by the `extras` config group (configs/extras/default.yaml):
  ignore_warnings: silence Python warnings
  enforce_tags:    prompt for tags when none are set (non-interactive runs
                   get a warning instead of a blocking prompt)
  print_config:    print the composed config as a tree before the run

The port's own copy of `tunevlseg_tpu/utils/config_tree.py`.
"""
from __future__ import annotations

import sys
import warnings
from pathlib import Path
from typing import Any, Optional

from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)

PRINT_ORDER = ("data", "model", "trainer", "paths", "extras")


def _render(node: Any, prefix: str, lines: list[str]) -> None:
    if isinstance(node, dict):
        items = list(node.items())
        for i, (k, v) in enumerate(items):
            last = i == len(items) - 1
            branch = "└── " if last else "├── "
            cont = "    " if last else "│   "
            if isinstance(v, dict) and v:
                lines.append(f"{prefix}{branch}{k}")
                _render(v, prefix + cont, lines)
            else:
                lines.append(f"{prefix}{branch}{k}: {v!r}")


def format_config_tree(cfg: dict, print_order=PRINT_ORDER) -> str:
    """The composed config as an indented tree, groups in `print_order`
    first (reference print_config_tree semantics), scalars last."""
    lines = ["CONFIG"]
    ordered = [k for k in print_order if k in cfg]
    ordered += [k for k, v in cfg.items()
                if k not in ordered and isinstance(v, dict)]
    scalars = {k: v for k, v in cfg.items()
               if k not in ordered and not isinstance(v, dict)}
    tree: dict = {k: cfg[k] for k in ordered}
    if scalars:
        tree["(root)"] = scalars
    _render(tree, "", lines)
    return "\n".join(lines)


def apply_extras(cfg: dict, save_dir: Optional[str] = None) -> None:
    """Honor the `extras` group before the run starts. Mirrors the
    reference's utils.extras(cfg) contract; `save_dir` persists the
    printed tree as config_tree.log like rich_utils save_to_file."""
    ex = cfg.get("extras") or {}
    if ex.get("ignore_warnings"):
        log.info("extras.ignore_warnings=true — disabling python warnings")
        warnings.filterwarnings("ignore")
    if ex.get("enforce_tags") and not cfg.get("tags"):
        if sys.stdin is not None and sys.stdin.isatty():
            entered = input("No tags set. Enter a comma-separated list of "
                            "tags (empty for ['dev']): ").strip()
            cfg["tags"] = ([t.strip() for t in entered.split(",") if t.strip()]
                           or ["dev"])
        else:
            cfg["tags"] = ["dev"]
            log.warning("extras.enforce_tags=true but no tags set and no "
                        "tty — tagging the run ['dev']")
    if ex.get("print_config"):
        tree = format_config_tree(cfg)
        print(tree, flush=True)
        if save_dir:
            try:
                Path(save_dir).mkdir(parents=True, exist_ok=True)
                (Path(save_dir) / "config_tree.log").write_text(tree + "\n")
            except OSError as e:
                log.warning("could not save config tree: %s", e)

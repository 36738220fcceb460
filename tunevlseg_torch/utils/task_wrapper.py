"""Single-run failure handling — the reference `task_wrapper` role.

The reference decorates its train/eval tasks (src/utils/utils.py:53-105) so
that a crash inside one run:
  * saves the exception to a log file,
  * marks the run as failed with a dedicated marker in the output dir
    (so a sweep/multirun can find and re-run it later),
  * always closes the wandb run (a dangling run fails the next multirun
    trial), and
  * still re-raises (sweeps that want isolation catch at their own level —
    scripts/sweep.py already does).

Here the same contract wraps the composed-config entry points
(train / eval `main`). The exception text is also checked for an
out-of-memory error (a CUDA OOM says "out of memory") so OOMing hparam
combinations are labeled as such in the marker file, which is what the
reference's Optuna setup keys on when pruning invalid trials.

The port's own copy of `tunevlseg_tpu/utils/task_wrapper.py`.
"""
from __future__ import annotations

import traceback
from pathlib import Path
from typing import Any, Callable, Mapping

from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)


def run_guarded(task_fn: Callable[[], Mapping[str, Any]],
                output_dir: str | Path | None) -> Mapping[str, Any]:
    """Execute `task_fn`, mirroring the reference task_wrapper's
    save-exception / mark-failed / close-loggers / re-raise behavior."""
    out = Path(output_dir) if output_dir else None
    try:
        result = task_fn()
    except Exception as e:  # noqa: BLE001 — faithfully catch-all, re-raise
        log.exception("task failed")
        if out is not None:
            out.mkdir(parents=True, exist_ok=True)
            (out / "error.log").write_text(traceback.format_exc())
            kind = ("oom" if "out of memory" in str(e)
                    else type(e).__name__)
            (out / "FAILED").write_text(kind + "\n")
        raise
    else:
        if out is not None:
            marker = out / "FAILED"
            if marker.exists():  # stale marker from a previous failed run
                marker.unlink()
        return result
    finally:
        if out is not None:
            log.info(f"Output dir: {out}")
        _close_wandb()


def _close_wandb() -> None:
    """Always close wandb, even on exceptions (ref utils.py:95-101)."""
    import importlib.util
    import sys

    if importlib.util.find_spec("wandb") is None:
        return
    wandb = sys.modules.get("wandb")
    if wandb is None:  # never imported this run — nothing to close
        return
    try:
        if wandb.run:
            log.info("Closing wandb!")
            wandb.finish()
    except Exception:  # noqa: BLE001 — closing must never mask the task error
        log.warning("wandb.finish() failed", exc_info=True)

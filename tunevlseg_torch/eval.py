"""Evaluation entry point of the port (reference src/eval.py: test and
predict from a checkpoint, no fit).

    python -m tunevlseg_torch.eval experiment=coop/clipseg ds_name=... \
        ckpt_path=logs/train/<exp>/checkpoints

The counterpart of `tunevlseg_tpu/eval.py`, with its families and device
rule from `tunevlseg_torch.train` (`+trainer.device=cpu` for the CPU).
`pretrained_checkpoint` loads converted weights first, as in the train CLI;
the checkpoint of `ckpt_path` is restored over them. `export_dir` (and
`export_platforms`) exports the inference step for serving, as in the train
CLI (`train.export_serving`).

`trainer.n_devices=k` evaluates on k ranks, as the train CLI starts them;
with `trainer.model_parallel=tp` (and `trainer.seq_shard`) they form the
train CLI's (k / tp, tp) grid: the checkpoint's whole tensors, the frozen
ones included, load on every rank, the towers are sliced after, each data
rank evaluates its shard of the test set, the metric sums are added over
the data axis, and model rank 0 of each data rank writes its masks.
`export_dir` exports on any grid: global rank 0 traces a whole model built
again from the config, the checkpoint's tensors gathered into it
(`train.export_task`).
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

from tunevlseg_torch.config.composer import compose
from tunevlseg_torch.data.pipeline import DataLoader
from tunevlseg_torch.data.tokenizer import load_default_tokenizer
from tunevlseg_torch.parallel.mesh import make_mesh
from tunevlseg_torch.train import (CONFIG_DIR, build_datasets,
                                   build_model_and_task, check_batch,
                                   export_serving, init_kwargs, join_group,
                                   load_pretrained, model_parallel,
                                   ranks_to_start, resolve_device, start_ranks)
from tunevlseg_torch.training.checkpoint import CheckpointManager
from tunevlseg_torch.training.loop import Trainer
from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)


def main(argv: Optional[list[str]] = None) -> dict:
    overrides = argv if argv is not None else sys.argv[1:]
    cfg = compose(CONFIG_DIR, "eval", overrides)
    from tunevlseg_torch.utils.task_wrapper import run_guarded

    def run() -> dict:
        n = ranks_to_start(cfg)
        return start_ranks(_run, cfg, n) if n > 1 else _run(cfg)
    return run_guarded(run, cfg["paths"]["output_dir"])


def _run(cfg: dict) -> dict:
    device, undo = join_group(cfg, resolve_device(cfg))
    try:
        return _run_rank(cfg, device)
    finally:
        for fn in undo:
            fn()


def _run_rank(cfg: dict, device) -> dict:
    from tunevlseg_torch.utils.config_tree import apply_extras
    apply_extras(cfg, save_dir=cfg["paths"].get("output_dir"))
    ckpt_path = cfg.get("ckpt_path")
    if not cfg.get("disable_ckpt") and not ckpt_path:
        # the reference refuses to evaluate without a checkpoint unless
        # disable_ckpt: testing random weights by accident is silent garbage
        raise ValueError(
            "ckpt_path is required for evaluation; pass ckpt_path=... "
            "or set disable_ckpt=true to evaluate initial weights "
            "deliberately")
    grid = make_mesh(model_parallel(cfg))
    check_batch(cfg, grid.data_size, grid.model_size)
    tokenizer = load_default_tokenizer(cfg.get("vocab_path"),
                                       family=cfg.get("tokenizer_family", "clip"))
    datasets = build_datasets(cfg, tokenizer)
    pretrained = load_pretrained(cfg)
    model, task = build_model_and_task(cfg, tokenizer, pretrained=pretrained,
                                       device=device)
    t = cfg["trainer"]
    d = cfg["data"]
    test_loader = DataLoader(datasets["test"], d["batch_size"] // grid.data_size,
                             shuffle=False, num_workers=d.get("num_workers", 8),
                             num_shards=grid.data_size,
                             shard_index=grid.data_rank,
                             text_dedup=int(d.get("text_dedup", 0) or 0))
    state = task.init(**init_kwargs(pretrained))

    if not cfg.get("disable_ckpt"):
        ckpt = CheckpointManager(ckpt_path, model)
        tag = "best" if (Path(ckpt_path) / "best").exists() else "last"
        state = ckpt.restore(tag, state)
        if (Path(ckpt_path) / "frozen").exists():
            ckpt.restore_frozen()
        else:
            log.info("no frozen weights in the checkpoint; using the model's")

    trainer = Trainer(task=task, output_dir=cfg["paths"]["output_dir"],
                      limit_batches=t.get("limit_batches"), mesh=grid,
                      seq_shard=bool(t.get("seq_shard", False)))
    result = trainer.test(state, test_loader, use_best=False)
    if cfg.get("predict", True):
        out_dir = Path(cfg["paths"]["output_dir"]) / "output_masks"
        trainer.predict(state, test_loader, save_dir=out_dir, use_best=False)
        result["output_masks_dir"] = str(out_dir)
    if cfg.get("export_dir"):
        # the (checkpoint-restored) inference step, for serving; every rank
        # takes part, global rank 0 writes it
        graph = export_serving(cfg, task, state, test_loader, device,
                               tokenizer, pretrained)
        if graph is not None:
            result["export_dir"] = graph
    log.info(f"done: {result}")
    return result


if __name__ == "__main__":
    main()

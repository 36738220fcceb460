"""The ranks of `tests/test_torch_tensor_parallel.py`: gloo process groups
on the CPU, started by `spawn`, which import torch and the port and nothing
of JAX. The parent writes the inputs (weights as state dicts, numpy
batches) into a work directory; every rank lays the ranks out as the
(world / tp, tp) grid, runs the checks it is asked for on its data rank's
rows of each global batch, and saves what it saw to `rank<r>.pt` there."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.cris.model import CRISConfig
from tunevlseg_torch.models.presets import (build_clipseg, build_cris,
                                            build_trans_segmentor)
from tunevlseg_torch.models.trans_segmentor.model import TransSegmentorConfig
from tunevlseg_torch.parallel import (activation_sharding, distributed,
                                      tensor_parallel)
from tunevlseg_torch.parallel.mesh import make_mesh
from tunevlseg_torch.training.checkpoint import CheckpointManager, full
from tunevlseg_torch.training.task import SegmentationTask

# the JAX `tests/test_training.py` tensor-parallel test's learning rate
LR = 1e-3
STEPS = 3


def spawn(workdir: Path, checks: tuple, world: int):
    """Start `world` gloo ranks that meet through a file in `workdir` and
    run `checks`; `collect` waits for them."""
    return mp.start_processes(_rank, args=(world, str(workdir), checks),
                              nprocs=world, join=False, start_method="spawn")


def collect(ranks, workdir: Path) -> list[dict]:
    """Wait for the ranks of `spawn` (a failing rank raises here) and return
    every rank's results in rank order."""
    while not ranks.join():
        pass
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(len(ranks.processes))]


def _rank(rank: int, world: int, workdir: str, checks: tuple) -> None:
    torch.set_num_threads(1)
    workdir = Path(workdir)
    distributed.initialize_distributed(
        {"coordinator_address": f"file://{workdir / 'store'}",
         "num_processes": world, "process_id": rank}, "cpu")
    try:
        inputs = torch.load(workdir / "inputs.pt", weights_only=False)
        grid = make_mesh(2)
        out = {name: CHECKS[name](inputs, workdir, grid) for name in checks}
        torch.save(out, workdir / f"rank{rank}.pt")
    finally:
        distributed.destroy()


def local(batch: dict, grid) -> dict:
    """The data rank's contiguous rows of a global numpy batch (the rows the
    JAX mesh's data axis gives its devices), as tensors."""
    n = batch["image"].shape[0] // grid.data_size
    lo = grid.data_rank * n
    return {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + n]))
            for k, v in batch.items()}


def maple(sd: dict) -> SegmentationTask:
    """Tiny CLIPSeg MaPLe (the JAX tensor-parallel tests' model) on `sd`."""
    model, spec = build_clipseg("maple", prompt_depth=2, num_context=4,
                                config=CLIPSegConfig.tiny(), device="cpu")
    model.load_state_dict(sd)
    return SegmentationTask(model, spec, learning_rate=LR)


def cris(sd: dict) -> SegmentationTask:
    model, spec = build_cris("coop", config=CRISConfig.tiny(), device="cpu")
    model.load_state_dict(sd)
    return SegmentationTask(model, spec, learning_rate=LR)


def trans_seg(sd: dict, siglip: bool) -> SegmentationTask:
    config = (TransSegmentorConfig.tiny(encoder_family="siglip") if siglip
              else TransSegmentorConfig.tiny())
    model, spec = build_trans_segmentor(config, freeze_encoders=True,
                                        device="cpu")
    model.load_state_dict(sd)
    return SegmentationTask(model, spec, learning_rate=LR)


def steps(task, batches, grid, fsdp=False, seq_shard=False,
          n_steps=STEPS) -> dict:
    """The grid's tensor (and sequence) parallelism on `task`'s model, then,
    in a process group, its data parallel (`compile_steps`; `Mesh(1, 1)`
    without a group is one process), and `n_steps` steps over `batches`
    (the last repeated): each step's metrics and collective bytes, the
    trainable weights after, the frozen tensors' bytes on this rank."""
    state = task.init()
    before = sum(p.numel() * p.element_size() for p in task.model.parameters()
                 if not p.requires_grad)
    tensor_parallel.shard_model(task.model, grid)
    towers = (activation_sharding.enable(task.model, grid) if seq_shard else 0)
    if distributed.is_initialized():
        task.compile_steps(fsdp=fsdp)
    if fsdp:
        state = task.state_fsdp_shardings(state)
    seen = []
    for i in range(n_steps):
        tensor_parallel.reset_bytes()
        state, m = task.train_step(state, local(batches[min(i, len(batches) - 1)],
                                                grid))
        seen.append({"metrics": {k: float(v) for k, v in m.items()},
                     "bytes": dict(tensor_parallel.COLLECTIVE_BYTES)})
    frozen = sum(p.numel() * p.element_size() for p in task.model.parameters()
                 if not p.requires_grad and not hasattr(p, "device_mesh"))
    return {"steps": seen, "towers": towers,
            "trainable": {n: full(p).detach().clone()
                          for n, p in task.model.named_parameters()
                          if p.requires_grad},
            "frozen_bytes": (before, frozen),
            "plan": dict(getattr(task.model, "tp_plan", {}))}


def check_tp2(inputs, workdir, grid):
    """(ii) three tp = 2 steps of tiny MaPLe; a predict step; the frozen
    checkpoint (whole tensors) written and restored into the slices."""
    task = maple(inputs["maple"])
    out = steps(task, inputs["batches"], grid)
    probs = task.predict_step(local(inputs["batches"][0], grid))
    ckpt = CheckpointManager(workdir / "tp_ckpt", task.model)
    ckpt.save_frozen()
    params = dict(task.model.named_parameters())
    sliced = {n: params[n].detach().clone() for n in out["plan"]}
    with torch.no_grad():
        for n in sliced:
            params[n].zero_()
    ckpt.restore_frozen()
    out["restored"] = all(torch.equal(params[n], v) for n, v in sliced.items())
    out["probs"] = probs
    out["local_heads"] = task.model.vision_model.layers[0].self_attn.num_heads
    return out


def check_sp(inputs, workdir, grid):
    """(iii) sequence parallelism against plain tp = 2 at 48^2 (10 vision
    tokens + 4 contexts, 16 text tokens: both towers shard) and 32^2 (5 + 4
    vision tokens: the vision stream stays replicated)."""
    out = {}
    for img in (48, 32):
        for sp in (False, True):
            out[(img, sp)] = steps(maple(inputs["maple"]), inputs[f"sp{img}"],
                                   grid, seq_shard=sp)
    return out


def check_families(inputs, workdir, grid):
    """tp = 2 on CRIS CoOp (its RN50 attention pool gathers its heads before
    `c_proj`) and on the TransformerSegmentor with CLIP towers (and sequence
    parallelism) and with SigLIP towers: two steps each."""
    return {
        "cris": steps(cris(inputs["cris"]), inputs["cris_batches"], grid,
                      n_steps=2),
        "ts": steps(trans_seg(inputs["ts"], False), inputs["ts_batches"], grid,
                    seq_shard=True, n_steps=2),
        "ts_siglip": steps(trans_seg(inputs["ts_siglip"], True),
                           inputs["siglip_batches"], grid, n_steps=2)}


def check_dp2tp2(inputs, workdir, grid):
    """(iv) dp 2 x tp 2: three steps under DDP over the data groups, and
    under FSDP over them."""
    return {"ddp": steps(maple(inputs["maple"]), inputs["batches"], grid),
            "fsdp": steps(maple(inputs["maple"]), inputs["batches"], grid,
                          fsdp=True)}


def check_trainer_mesh(inputs, workdir, grid):
    """A Trainer makes its mesh the one the data-axis helpers read (another
    rank's, a grid without groups and one with its groups swapped raise);
    `shard_model` binds the model group's gradient mean once, which
    `bind_reductions` reads. The grid is set again after."""
    from tunevlseg_torch.parallel.mesh import Mesh
    from tunevlseg_torch.training.loop import Trainer
    from tunevlseg_torch.training.task import bind_reductions
    task = maple(inputs["maple"])
    out = {"unbound": getattr(task.model, "tp_reduce_grads", None) is None}
    tensor_parallel.shard_model(task.model, grid)
    state = task.init()
    bind_reductions(state.optimizer, None, task.model)
    out["bound"] = state.optimizer.reduce_grads is task.model.tp_reduce_grads
    distributed.set_mesh(None)
    Trainer(task, workdir / f"trainer{grid.model_rank}", mesh=grid)
    out["set"] = distributed.mesh() is grid
    refused = []
    for bad in (Mesh(1, 2), Mesh(1, 2, 0, 1 - grid.model_rank, grid.data_group,
                                 grid.model_group),
                Mesh(1, 2, 0, grid.model_rank, grid.model_group, grid.data_group)):
        try:
            Trainer(task, workdir / "refused", mesh=bad)
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    Trainer(task, workdir / f"trainer{grid.model_rank}")
    out["cleared"] = distributed.mesh() is None
    distributed.set_mesh(grid)
    return out


CHECKS = {"tp2": check_tp2, "sp": check_sp, "families": check_families,
          "dp2tp2": check_dp2tp2, "trainer_mesh": check_trainer_mesh}

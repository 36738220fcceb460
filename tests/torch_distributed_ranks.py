"""The ranks of `tests/test_torch_distributed.py`: gloo process groups on
the CPU, started by `spawn`, which import torch and the port and nothing of
JAX. The parent writes the inputs (weights as state dicts, numpy batches)
into a work directory, every rank runs the checks it is asked for on its
rows of each global batch, and saves what it saw to `rank<r>.pt` there for
the parent to compare.

Each rank runs on one torch thread: beside the test workers, an OpenMP
team on descheduled threads once took minutes for what one thread does in
seconds."""
from __future__ import annotations

import os
import signal
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from tunevlseg_torch.data.pipeline import DataLoader
from tunevlseg_torch.models.clip.config import CLIPSegConfig
from tunevlseg_torch.models.clipseg.model import CLIPSegForSegmentation
from tunevlseg_torch.models.cris.model import CRISConfig
from tunevlseg_torch.models.prompt.learners import CoOpLearner
from tunevlseg_torch.parallel import data_parallel, distributed
from tunevlseg_torch.training.checkpoint import CheckpointManager, full
from tunevlseg_torch.training.loop import Trainer
from tunevlseg_torch.training.optim import FreezeSpec
from tunevlseg_torch.training.task import SegmentationTask

LR = 1e-2


def spawn(workdir: Path, checks: tuple, world: int = 2):
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
        out = {name: CHECKS[name](inputs, workdir) for name in checks}
        torch.save(out, workdir / f"rank{rank}.pt")
    finally:
        distributed.destroy()


def local(batch: dict) -> dict:
    """This rank's contiguous rows of a global numpy batch (the rows the JAX
    mesh's data axis gives its device), as tensors; the prompt-dedup rows
    stay whole."""
    r, w = distributed.rank(), distributed.world_size()
    out = {}
    for k, v in batch.items():
        if "text_index" in batch and k in ("input_ids", "attention_mask"):
            out[k] = torch.from_numpy(v)
            continue
        n = v.shape[0] // w
        out[k] = torch.from_numpy(np.ascontiguousarray(v[r * n:(r + 1) * n]))
    return out


def clipseg_task(sd: dict, **kw) -> SegmentationTask:
    """Tiny CLIPSeg CoOp with the "residual" additive head (the JAX
    `tests/test_training.py` model of its accumulation and FSDP tests) on
    the weights `sd`."""
    cfg = CLIPSegConfig.tiny()
    model = CLIPSegForSegmentation(cfg, learner=CoOpLearner(
        prompt_depth=2, num_context=4, context_dim=cfg.text.hidden_size),
        additive_mode="residual")
    model.load_state_dict(sd)
    spec = FreezeSpec(freeze_all=True, use_new_last_layer=True)
    return SegmentationTask(model, spec, **kw)


def trainable(model) -> dict:
    """The trainable tensors, whole (DTensors gathered: every rank calls)."""
    return {n: full(p).detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def record_applied(opt, model) -> list:
    """The (reduced, averaged) gradient each update applies, whole, by
    parameter name, appended as the updates happen."""
    applied = []
    names = {id(p): n for n, p in model.named_parameters()}
    opt.optimizer.register_step_pre_hook(lambda o, a, k: applied.append(
        {names[id(p)]: full(p.grad).clone() for g in o.param_groups
         for p in g["params"] if p.grad is not None}))
    return applied


def _steps(task, state, batches, fsdp=False):
    task.compile_steps(fsdp=fsdp)
    if fsdp:
        state = task.state_fsdp_shardings(state)
    applied = record_applied(state.optimizer, task.model)
    seen = []
    for b in batches:
        state, m = task.train_step(state, local(b))
        seen.append({"metrics": {k: float(v) for k, v in m.items()},
                     "trainable": trainable(task.model), "grads": applied[-1]})
    return state, seen


def check_ddp(inputs, workdir):
    """(i) two DDP steps of the CoOp model, with remat off and on."""
    out = {}
    for remat in (False, True):
        task = clipseg_task(inputs["clipseg"], learning_rate=LR, remat=remat)
        _, out[remat] = _steps(task, task.init(), inputs["batches"])
    return {"plain": out[False], "remat": out[True]}


def check_ddp_unused(inputs, workdir):
    """DDP over CoOp's stock model, whose `residual_ratio` the forward never
    reads (find_unused_parameters): two steps; the ratio keeps its value."""
    from tunevlseg_torch.models.presets import build_clipseg
    model, spec = build_clipseg("coop", config=CLIPSegConfig.tiny(),
                                device="cpu", seed=2)
    task = SegmentationTask(model, spec, learning_rate=LR)
    state = task.init()
    task.compile_steps()
    seen = []
    for b in inputs["batches"]:
        state, m = task.train_step(state, local(b))
        seen.append(float(m["loss"]))
    return {"losses": seen, "trainable": trainable(model),
            "find_unused": task.ddp.find_unused_parameters}


BATCH_DICE = {"batch": True}


def check_batch_dice(inputs, workdir):
    """A dice over the whole batch (`loss_kwargs={"batch": True}`) over the
    two ranks: the eval step's loss sum on a batch with a padded row in each
    rank's half, then two DDP steps, and two FSDP steps, of the CoOp model
    from the same weights."""
    from tunevlseg_torch.ops.metrics import SegMetricState
    task = clipseg_task(inputs["clipseg"], learning_rate=LR,
                        loss_kwargs=BATCH_DICE)
    _, extra = task.eval_step(SegMetricState.zeros(torch.device("cpu")),
                              local(inputs["padded"]))
    out = {"eval": {k: v.clone() for k, v in extra.items()}}
    for fsdp in (False, True):
        task = clipseg_task(inputs["clipseg"], learning_rate=LR,
                            loss_kwargs=BATCH_DICE)
        _, out["fsdp" if fsdp else "ddp"] = _steps(
            task, task.init(), inputs["dice_batches"], fsdp=fsdp)
    return out


def check_accumulate(inputs, workdir):
    """(ii) DDP with accumulate_grad_batches=2 over two micro-batches, the
    gradient the update applies and the weights after it; then the same
    window cut by a checkpoint after its first micro-step and resumed in a
    new model: the weights bit for bit those of the uninterrupted window."""
    micro = inputs["micro"]
    task = clipseg_task(inputs["clipseg"], learning_rate=LR,
                        accumulate_grad_batches=2)
    state = task.init()
    task.compile_steps()
    applied = record_applied(state.optimizer, task.model)
    after_first = None
    for i, b in enumerate(micro):
        state, _ = task.train_step(state, local(b))
        if i == 0:
            after_first = trainable(task.model)
    whole = trainable(task.model)

    cut = clipseg_task(inputs["clipseg"], learning_rate=LR,
                       accumulate_grad_batches=2)
    cut_state = cut.init()
    cut.compile_steps()
    cut_state, _ = cut.train_step(cut_state, local(micro[0]))
    ckpt = CheckpointManager(workdir / "accum_ckpt", cut.model)
    ckpt.save("last", cut_state, {"epoch": 0})
    ckpt.wait()
    resumed = clipseg_task(inputs["clipseg"], learning_rate=LR,
                           accumulate_grad_batches=2)
    resumed_state = resumed.init()
    resumed.compile_steps()
    resumed_state = CheckpointManager(workdir / "accum_ckpt",
                                      resumed.model).restore("last", resumed_state)
    window = resumed_state.optimizer.accumulation_state()
    resumed_state, _ = resumed.train_step(resumed_state, local(micro[1]))
    return {"applied": applied, "after_first": after_first, "after": whole,
            "resumed": trainable(resumed.model),
            "resumed_mini_step": window["mini_step"]}


def check_fsdp(inputs, workdir):
    """(iii) two FSDP steps of the CoOp model (remat off and on), the local
    shards of the parameters and AdamW's moments, then a checkpoint written
    from FSDP and restored into a DDP model of the same weights."""
    out = {}
    for remat in (False, True):
        task = clipseg_task(inputs["clipseg"], learning_rate=LR, remat=remat)
        state, out[remat] = _steps(task, task.init(), inputs["batches"],
                                   fsdp=True)
        if not remat:
            sharded, kept = task, state
    model, opt = sharded.model, kept.optimizer
    params = dict(model.named_parameters())
    shards = {}
    for n, p in params.items():
        if data_parallel.is_dtensor(p):
            moments = opt.optimizer.state.get(p, {})
            shards[n] = {"global": tuple(p.shape),
                         "local": tuple(p.to_local().shape),
                         "trainable": p.requires_grad,
                         "moments": [tuple(moments[k].to_local().shape)
                                     for k in ("exp_avg", "exp_avg_sq")
                                     if k in moments]}
    ckpt = CheckpointManager(workdir / "fsdp_ckpt", model)
    ckpt.save_frozen()
    ckpt.save("last", kept, {"epoch": 0})
    ckpt.wait()
    into = clipseg_task(inputs["clipseg"], learning_rate=LR)
    into_state = into.init()
    into.compile_steps()
    into_state = CheckpointManager(workdir / "fsdp_ckpt", into.model).restore(
        "last", into_state)
    restored = trainable(into.model)
    moments = [{k: v.clone() for k, v in s.items()}
               for s in into_state.optimizer.optimizer.state.values()]
    return {"plain": out[False], "remat": out[True], "shards": shards,
            "into_ddp": restored, "into_ddp_moments": moments,
            "sharded_is_dtensor": all(data_parallel.is_dtensor(p)
                                      for p in params.values())}


def check_cris_e2e(inputs, workdir):
    """(iv) CRIS e2e (train-mode BatchNorm in the FPN and the projector)
    under DDP: two steps, their losses, the weights and the running
    statistics in the state."""
    from tunevlseg_torch.models.presets import build_cris
    hp = inputs["cris_hp"]
    model, spec = build_cris("e2e", config=CRISConfig.tiny(), seed=1,
                             device="cpu")
    model.load_state_dict(inputs["cris"])
    task = SegmentationTask(model, spec, mutable_collections=("batch_stats",),
                            **hp)
    return _bn_steps(task, inputs["cris_batches"])


def _bn_steps(task, batches):
    state = task.init()
    task.compile_steps()
    applied = record_applied(state.optimizer, task.model)
    seen = []
    for b in batches:
        state, m = task.train_step(state, local(b))
        seen.append({"metrics": {k: float(v) for k, v in m.items()},
                     "trainable": trainable(task.model), "grads": applied[-1],
                     "stats": {k: v.clone() for k, v in state.model_state.items()}})
    return seen


def check_denseclip(inputs, workdir):
    """(iv) DenseCLIP `bn_train` under DDP with unequal ignored pixels per
    rank: two steps' losses, accuracies, weights and statistics."""
    from tunevlseg_torch.models.presets import build_denseclip
    from tunevlseg_torch.training.denseclip_task import DenseCLIPTask
    dc = inputs["denseclip"]
    model = build_denseclip(dc["config"], dc["class_ids"], device="cpu",
                            bn_train=True)
    model.load_state_dict(dc["sd"])
    return _bn_steps(DenseCLIPTask(model, **dc["hp"]), dc["batches"])


def check_batch_norm(inputs, workdir):
    """(d) one BatchNorm in train mode on this rank's rows: its output and
    the new running statistics, and the gradient of the global sum of a
    fixed cotangent with respect to its input and its affine weights."""
    from tunevlseg_torch.models.cris.resnet import BatchNorm2d
    bn = BatchNorm2d(3, use_running_average=False)
    with torch.no_grad():
        bn.init_weights(None)
        bn.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
    x = local({"x": inputs["bn_x"]})["x"].requires_grad_(True)
    cot = local({"c": inputs["bn_cot"]})["c"]
    updates = {}
    y = bn(x, updates=updates)
    (y * cot).sum().backward()
    return {"y": y.detach(), "stats": updates[bn], "dx": x.grad,
            "dw": bn.weight.grad}


class _Listed:
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[int(i)]


def check_sigterm(inputs, workdir):
    """(v) `Trainer.fit` on two ranks where rank 1 alone gets SIGTERM while
    it trains its third batch: both ranks stop after that step, and rank 0
    writes the resumable `last`."""
    task = clipseg_task(inputs["clipseg"], learning_rate=LR)
    state = task.init()
    out = workdir / "sigterm"
    loader = DataLoader(_Listed(inputs["samples"]), 2, shuffle=True, seed=3,
                        num_workers=1, num_shards=distributed.world_size(),
                        shard_index=distributed.rank())

    class Signalling:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def set_epoch(self, *a):
            self.inner.set_epoch(*a)

        def __iter__(self):
            for i, b in enumerate(self.inner):
                if i == 2 and distributed.rank() == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                yield b

    trainer = Trainer(task, out, max_epochs=2, log_every_n_steps=1)
    state = trainer.fit(state, Signalling(loader), None)
    return {"step": state.step, "logged": trainer.metrics_log.path is not None}


CHECKS = {"ddp": check_ddp, "ddp_unused": check_ddp_unused,
          "batch_dice": check_batch_dice,
          "accumulate": check_accumulate, "fsdp": check_fsdp,
          "cris_e2e": check_cris_e2e, "denseclip": check_denseclip,
          "batch_norm": check_batch_norm, "sigterm": check_sigterm}

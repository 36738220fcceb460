"""Process groups for data parallel over GPUs: one process per card.

The port's counterpart of `tunevlseg_tpu/parallel/mesh.py`, holding what
`torch.distributed` needs of it. The reference's only parallelism is
Lightning DDP (SURVEY 2.10, 5.8); the JAX package shards the batch over a
`data` mesh. Here every rank is a process with its own device
(`cuda:{local_rank}`, or the CPU), its own shard of the data, and a copy
of the model that `DistributedDataParallel` or `fully_shard` keeps in step
(`training/task.py`).

`initialize_distributed` joins a process group from the trainer config's
`coordinator_address` / `num_processes` / `process_id` (an address
`host:port` becomes `tcp://host:port`; a URL such as `file:///path` is used
as it is), else from torchrun's `RANK` / `WORLD_SIZE` / `LOCAL_RANK` /
`MASTER_ADDR`. The backend follows the device: NCCL on CUDA, gloo on the
CPU, unless the caller names one (gloo over CUDA tensors lets two ranks
share one card). Small host-side decisions (the preemption flag, the
first batch's prompt check, the gathered accumulation windows) go through
a gloo group beside it, so that they never wait on the device.

Without a process group every helper here answers for one process: rank 0
of 1, collectives are the identity.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# the gloo group for host-side collectives (None: the default group is gloo)
_HOST_GROUP: list = [None]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """`LOCAL_RANK` where a launcher sets it, else the global rank modulo
    the visible cards (one process per card on each host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank() % n if n else 0


def rank_device(device) -> torch.device:
    """This rank's device for a run on `device`: `cuda:{local_rank}` for a
    CUDA run (raises without a card, or with fewer cards than the local
    rank needs), the CPU for a CPU run."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: data parallel over GPUs needs one "
                           "card per rank; pass +trainer.device=cpu for "
                           "gloo ranks on the CPU")
    index = device.index if device.index is not None else local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {rank()} wants cuda:{index} but {torch.cuda.device_count()} "
            "card(s) are visible: one card per rank")
    return torch.device("cuda", index)


def init_method_of(trainer_cfg: Optional[dict]) -> tuple[str, int, int]:
    """(init_method, world_size, rank) from the trainer config's
    coordinator keys, else from torchrun's environment; raises a ValueError
    naming the keys when neither is there."""
    t = trainer_cfg or {}
    keys = ("coordinator_address", "num_processes", "process_id")
    given = {k: t.get(k) for k in keys}
    if any(v is not None for v in given.values()):
        missing = [k for k, v in given.items() if v is None]
        if missing:
            raise ValueError(f"trainer.{', trainer.'.join(missing)} missing: a "
                             "multi-process run needs all of "
                             f"trainer.{', trainer.'.join(keys)}")
        address = str(given["coordinator_address"])
        url = address if "://" in address else f"tcp://{address}"
        return url, int(given["num_processes"]), int(given["process_id"])
    env = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
    if all(k in os.environ for k in env):
        return "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    raise ValueError(
        "no process group to join: set trainer.coordinator_address (host:port "
        "of rank 0), trainer.num_processes and trainer.process_id on every "
        "process, or launch through torchrun (RANK, WORLD_SIZE, MASTER_ADDR, "
        "MASTER_PORT)")


def initialize_distributed(trainer_cfg: Optional[dict], device,
                           backend: Optional[str] = None) -> torch.device:
    """Join the process group the trainer config (or torchrun) describes and
    return this rank's device. `device` is the run's ("cuda" or "cpu");
    `backend` defaults to NCCL for CUDA and gloo for the CPU. A process that
    is in a group already only gets its device back."""
    if not is_initialized():
        url, world, r = init_method_of(trainer_cfg)
        kind = torch.device(device).type
        backend = backend or ("nccl" if kind == "cuda" else "gloo")
        if kind == "cuda":
            # NCCL binds a rank to the current device: set it first
            os.environ.setdefault("LOCAL_RANK", str(
                r % max(torch.cuda.device_count(), 1)))
            torch.cuda.set_device(rank_device(device))
        dist.init_process_group(backend, init_method=url, world_size=world,
                                rank=r)
        _HOST_GROUP[0] = (None if backend == "gloo"
                          else dist.new_group(backend="gloo"))
    return rank_device(device)


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP[0] = None


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_HOST_GROUP[0])


def all_reduce_sum(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The sum over ranks of each tensor of `tensors` (one collective for
    all of them, on their device, in f64 where they are floating point); the
    tensors themselves are left as they are."""
    if world_size() == 1 or not tensors:
        return dict(tensors)
    names = list(tensors)
    flat = torch.stack([tensors[k].detach().reshape(()).double()
                        for k in names])
    dist.all_reduce(flat)
    return {k: flat[i].to(tensors[k].dtype) for i, k in enumerate(names)}


def any_flag(flag: bool) -> bool:
    """The OR over ranks of a host-side flag (the preemption watch): a rank
    that stops while another goes on into the next step's collectives would
    hang them both."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP[0])
    return bool(t.item())


def gather_to_rank0(obj: Any) -> Optional[list]:
    """Every rank's `obj` (picklable, say tensors on the CPU) in rank order
    on rank 0, None elsewhere."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0, group=_HOST_GROUP[0])
    return out


# the prompt-dedup keys: the U unique rows every rank must agree on
DEDUP_KEYS = ("input_ids", "attention_mask")


def assert_dedup_keys_agree(batch: dict) -> None:
    """Multi-host guard for the prompt-dedup layout (the JAX
    `mesh.assert_dedup_keys_agree`): the first batch's U x L dedup rows must
    be the same on every rank, or the ranks would train on different
    prompts behind one `text_index`. Gathers those few ints once."""
    if world_size() == 1:
        return
    for key in DEDUP_KEYS:
        if key not in batch:
            continue
        mine = torch.as_tensor(batch[key]).cpu()
        gathered = [torch.empty_like(mine) for _ in range(world_size())]
        dist.all_gather(gathered, mine, group=_HOST_GROUP[0])
        if not all(torch.equal(g, gathered[0]) for g in gathered):
            raise ValueError(
                f"text_dedup keys differ across ranks ({key}): every rank must "
                "select the same prompts (a fixed prompt_index with one "
                "constant prompt), or set data.text_dedup=0")

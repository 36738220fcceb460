"""Captured train steps: k whole train steps as one CUDA graph.

Counterpart of the JAX tasks' `compile_train_multistep`, one XLA executable
that runs k train steps under `lax.scan` and returns the metrics averaged
over them. Here it is one `torch.cuda.CUDAGraph` that holds k whole train
steps, each forward, loss, backward, clip and AdamW (or the micro-step of
an accumulation window), over batches stacked on a leading (k, B, ...)
axis: one host launch a group in the place of every kernel's launch.

How a replay keeps the eager steps' semantics:

  * the batches are copied into static buffers, one set per stacked batch
    signature (keys, shapes, dtypes); a new signature captures a new graph,
    as a new shape makes `jax.jit` retrace. The accumulation window's phase
    at the group's start (`mini_step`) is part of the key, since the
    optimizer's host-side branches depend on it (at most
    `accumulate_grad_batches` graphs);
  * before each capture the group's k steps run eagerly on the capture's
    side stream (the warm-up): it fills the caches built at first call
    (resize matrices, position encodings, normalisation constants), builds
    the kernels and resolves their TMA entry point, and makes AdamW's
    state. It is then undone: the weights, AdamW's moments and step counts,
    the learning rates and the accumulation window are restored from a
    snapshot, so that the captured group starts from the caller's state;
  * the graph updates the weights and AdamW's state in place. The
    BatchNorm statistics of `model_state` and the accumulation window's
    running mean live in static buffers that the graph reads at its start
    and writes at its end; a state that holds other tensors (a restored
    checkpoint, a fresh state) is copied into them before the replay;
  * the gradients are set to None before each backward inside the capture,
    as in the eager step: each backward allocates them from the graph's
    pool, and a trainable leaf that nothing reads gets none, so AdamW
    neither updates it nor gives it state;
  * dropout: k generators on the device, registered with every graph.
    Before each replay generator i is seeded with `step_seed(seed, step0 +
    i, rank)`, so step i draws the masks of the eager step step0 + i;
  * the learning rate is a device tensor (`optim.on_device_lr`) that the
    graph reads; a task with a rate per step (`learning_rates`, DenseCLIP's
    poly schedule) takes step i's rates from row i of a (k, groups) buffer
    filled before each replay;
  * the metrics of the k steps are averaged on the device under the keys
    of the eager steps and handed back as a copy;
  * the steps' spans (`step.forward`, `step.backward`, `step.update`)
    become pairs of timing events inside the graph, and each replay is
    bracketed by two plain events, its begin just before the launch and
    its end after the metrics' copy (`utils/profiling.py`): the device time
    of each phase of a replayed step, of the group, and of the card's wait
    between two groups. The host spans `captured.call` (with `.capture`,
    `.warm_up`, `.load`, `.launch`, `.metrics`) and the counters
    `captured.captures` and `captured.replays` time and count the calls.

The state passed in is consumed, as the JAX program donates its state: the
returned state's `model_state` holds the graph's buffers, which the next
group overwrites. On CUDA a capture or replay that fails raises; nothing
runs the eager steps in its place. The steps stay eager where the caller
chose that: on the CPU, and for a model that `compile_steps` wrapped for
data parallel (the collectives are not captured).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tunevlseg_torch.parallel import data_parallel, distributed
from tunevlseg_torch.utils import profiling
from tunevlseg_torch.utils.logging import get_logger

log = get_logger(__name__)

CAPTURES, REPLAYS = "captured.captures", "captured.replays"


def mean_metrics(per_step: list[dict]) -> dict:
    """Each metric's mean over the steps."""
    return {k: torch.stack([m[k] for m in per_step]).mean() for k in per_step[0]}


def step_batches(batches: dict, num_steps: int) -> list[dict]:
    """The batches of the steps, out of batches stacked on a leading
    (num_steps, B, ...) axis."""
    for name, t in batches.items():
        if t.shape[0] != num_steps:
            raise ValueError(f"batches[{name!r}] has {t.shape[0]} steps on its "
                             f"leading axis, the program runs {num_steps}")
    return [{k: v[i] for k, v in batches.items()} for i in range(num_steps)]


def eager_multistep(task, num_steps: int) -> Callable:
    """`multi(state, batches)`: the k train steps one after another, the
    metrics averaged over them."""
    def multi(state, batches: dict):
        per_step = []
        for batch in step_batches(batches, num_steps):
            state, metrics = task.train_step(state, batch)
            per_step.append(metrics)
        return state, mean_metrics(per_step)
    return multi


def compile_multistep(task, num_steps: int) -> Callable:
    """The program of `compile_train_multistep`: a `CapturedSteps` on a
    CUDA device; the eager steps on the CPU and for a model wrapped for
    data parallel (said once, in the log)."""
    if isinstance(num_steps, bool) or int(num_steps) != num_steps or num_steps < 1:
        raise ValueError(f"num_steps {num_steps!r}: a whole number of steps, at least 1")
    if next(task.model.parameters()).device.type != "cuda":
        return eager_multistep(task, num_steps)
    if task.ddp is not None or data_parallel.is_sharded(task.model):
        log.warning("compile_train_multistep: the model is wrapped for data "
                    "parallel; the %d steps of a group run eagerly (collectives "
                    "are not captured)", num_steps)
        return eager_multistep(task, num_steps)
    return CapturedSteps(task, int(num_steps))


def _copy_into(pairs: list) -> None:
    """Copy each (target, source) pair's source into its target, where the
    two are not one tensor (one foreach copy where they are many)."""
    pairs = [(t, v) for t, v in pairs if t is not v]
    if pairs:
        with torch.no_grad():
            torch._foreach_copy_([t for t, _ in pairs], [v for _, v in pairs])


class _Snapshot:
    """What a train step changes in place, taken before the warm-up and
    put back after it: the weights, AdamW's state (a parameter that had
    none gets its state zeroed, which is what AdamW makes at its first
    update), the learning rates and the accumulation window."""

    def __init__(self, opt):
        self.opt = opt
        self.params = opt.params()
        with torch.no_grad():
            self.weights = [p.detach().clone() for p in self.params]
            self.moments = {p: {n: t.clone() for n, t in opt.optimizer.state[p].items()}
                            for p in self.params if p in opt.optimizer.state}
            self.lrs = [g["lr"].clone() for g in opt.param_groups]
            self.window = {i: t.clone() for i, t in opt.accumulated.items()}
        self.mini_step = opt.mini_step

    def restore(self) -> None:
        opt = self.opt
        with torch.no_grad():
            torch._foreach_copy_([p.detach() for p in self.params], self.weights)
            for p in self.params:
                saved = self.moments.get(p)
                for name, t in opt.optimizer.state.get(p, {}).items():
                    if saved is None:
                        t.zero_()
                    else:
                        t.copy_(saved[name])
            for group, lr in zip(opt.param_groups, self.lrs):
                group["lr"].copy_(lr)
        opt.mini_step = self.mini_step
        opt.accumulated = dict(self.window)


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    batches: dict          # the static (k, B, ...) inputs
    metrics: torch.Tensor  # the k steps' mean metrics, in the order of `keys`
    keys: list
    start_window: list     # indices in the accumulation window at the start
    end_mini_step: int
    end_window: list
    moments: dict          # {parameter: {name: tensor}} of AdamW's state
    lrs: list              # each group's learning-rate tensor
    spans: profiling.DeviceSpans   # the steps' spans, as events in the graph


class CapturedSteps:
    """`multi(state, batches) -> (state, metrics)`: k train steps of `task`
    as one CUDA graph per batch signature and window phase, captured at
    the first call that needs it and replayed after."""

    def __init__(self, task, num_steps: int):
        self.task = task
        self.num_steps = num_steps
        self.device = next(task.model.parameters()).device
        self.stream = torch.cuda.Stream(self.device)
        self.generators = [torch.Generator(device=self.device)
                           for _ in range(num_steps)]
        self.graphs: dict = {}
        self.optimizer = None
        self.inputs: dict = {}        # batch signature -> static batches
        self.model_state: dict = {}   # static BatchNorm statistics
        self.window: dict = {}        # index in params() -> static running mean
        # (k, groups) learning rates of a task with a rate per step
        self.lr_rows = None

    def __call__(self, state, batches: dict):
        index = profiling.counter(REPLAYS)
        profiling.set_group(index)
        with profiling.span("captured.call"):
            opt = state.optimizer
            if opt is not self.optimizer:     # the graphs hold another optimizer's tensors
                self.graphs, self.window, self.lr_rows = {}, {}, None
                self.optimizer = opt
            signature = tuple((k, tuple(v.shape), v.dtype)
                              for k, v in sorted(batches.items()))
            key = (signature, opt.mini_step)
            entry = self.graphs.get(key)
            if entry is None:
                with profiling.span("captured.capture"):
                    entry = self.graphs[key] = self._capture(state, batches, signature)
            with profiling.span("captured.load"):
                self._load(entry, state, batches)
            with profiling.span("captured.launch"):
                profiling.group_begin(index)
                entry.graph.replay()
                profiling.count(REPLAYS)
                profiling.replayed(entry.spans, index)
            opt.mini_step = entry.end_mini_step
            opt.accumulated = {i: self.window[i] for i in entry.end_window}
            with profiling.span("captured.metrics"):
                metrics = entry.metrics.clone()
            profiling.group_end()
        return (dataclasses.replace(state, step=state.step + self.num_steps,
                                    model_state=dict(self.model_state)),
                {k: metrics[j] for j, k in enumerate(entry.keys)})

    # -- capture --------------------------------------------------------------

    def _warm_up(self, state, per_step: list) -> None:
        snapshot = _Snapshot(state.optimizer)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with profiling.span("captured.warm_up"), torch.cuda.stream(self.stream):
            for batch in per_step:
                state, _ = self.task.train_step(state, batch)
        current.wait_stream(self.stream)
        snapshot.restore()

    def _window_buffer(self, i: int, like: torch.Tensor) -> torch.Tensor:
        if i not in self.window:
            self.window[i] = torch.empty_like(like)
        return self.window[i]

    def _adopt_window(self, opt) -> None:
        """The accumulation window's running mean into the static buffers."""
        with torch.no_grad():
            for i, t in list(opt.accumulated.items()):
                buf = self._window_buffer(i, t)
                if t is not buf:
                    buf.copy_(t)
                    opt.accumulated[i] = buf

    def _capture(self, state, batches: dict, signature: tuple) -> _Graph:
        task, opt, k = self.task, state.optimizer, self.num_steps
        if not all(isinstance(g["lr"], torch.Tensor) for g in opt.param_groups):
            raise ValueError("captured train steps read the learning rate from a "
                             "device tensor: the optimizer must be a capturable "
                             "AdamW (optim.on_device_lr)")
        self._warm_up(state, step_batches(batches, k))
        if signature not in self.inputs:
            self.inputs[signature] = {n: torch.empty_like(t) for n, t in batches.items()}
        inputs = self.inputs[signature]
        if not self.graphs:
            self.model_state = {n: t.clone() for n, t in state.model_state.items()}
        self._adopt_window(opt)
        start_mini_step, start_window = opt.mini_step, sorted(opt.accumulated)
        rates = hasattr(task, "learning_rates")
        if rates and self.lr_rows is None:
            self.lr_rows = torch.zeros((k, len(opt.param_groups)), dtype=torch.float32,
                                       device=self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        profiling.count(CAPTURES)
        with profiling.capturing() as spans, torch.cuda.graph(graph, stream=self.stream):
            st = dataclasses.replace(state, model_state=dict(self.model_state))
            per_step = []
            for i, batch in enumerate(step_batches(inputs, k)):
                extra = {"learning_rates": self.lr_rows[i]} if rates else {}
                st, metrics = task.train_step(st, batch, generator=self.generators[i],
                                              **extra)
                per_step.append(metrics)
            keys = list(per_step[0])
            means = mean_metrics(per_step)
            metrics = torch.stack([means[key] for key in keys])
            _copy_into([(buf, st.model_state[name])
                        for name, buf in self.model_state.items()]
                       + [(self._window_buffer(i, t), t)
                          for i, t in opt.accumulated.items()])
        end_mini_step, end_window = opt.mini_step, sorted(opt.accumulated)
        # the capture ran no kernel: the host side goes back to the start
        opt.mini_step = start_mini_step
        opt.accumulated = {i: self.window[i] for i in start_window}
        return _Graph(graph, inputs, metrics, keys, start_window, end_mini_step,
                      end_window,
                      {p: dict(opt.optimizer.state[p]) for p in opt.params()
                       if p in opt.optimizer.state},
                      [g["lr"] for g in opt.param_groups], spans)

    # -- replay ---------------------------------------------------------------

    def _load(self, entry: _Graph, state, batches: dict) -> None:
        """The caller's state and batches into the graph's tensors, where
        they are not those already; the generators' seeds and the rates of
        the group's steps."""
        from tunevlseg_torch.training.task import step_seed

        opt = state.optimizer
        if set(state.model_state) != set(self.model_state):
            raise ValueError("the state's model_state holds other buffers than "
                             "the captured steps'")
        self._adopt_window(opt)
        if sorted(opt.accumulated) != entry.start_window:
            raise ValueError("the accumulation window holds other parameters than "
                             "at the capture of this phase")
        _copy_into([(buf, batches[name]) for name, buf in entry.batches.items()]
                   + [(buf, state.model_state[name])
                      for name, buf in self.model_state.items()])
        with torch.no_grad():
            for p, tensors in entry.moments.items():
                own = opt.optimizer.state[p]
                for name, t in tensors.items():
                    if own.get(name) is not t:
                        if name in own:
                            t.copy_(own[name])
                        else:
                            t.zero_()
                        own[name] = t
            for group, lr in zip(opt.param_groups, entry.lrs):
                if group["lr"] is not lr:
                    lr.fill_(float(group["lr"]))
                    group["lr"] = lr
            if self.lr_rows is not None:
                self.lr_rows.copy_(torch.tensor(
                    [self.task.learning_rates(opt, state.step + i)
                     for i in range(self.num_steps)], dtype=torch.float32))
        rank = distributed.data_rank()
        for i, gen in enumerate(self.generators):
            gen.manual_seed(step_seed(self.task.seed, state.step + i, rank))

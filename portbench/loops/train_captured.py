"""Training through the program's captured groups of steps.

Set-up builds one task (the port's model, its optimizer state), loads the
weights drawn from the seed through `SegmentationTask.init(params=...)`,
draws a pool of `groups_in_pool` groups of `steps_per_group` batches on the
device, and runs the first `checked_groups` groups (`workloads/<cell>.json`)
through `compile_train_multistep(k)`: the first call captures the CUDA
graph (the program's warm-up included), and what these groups leave is
what the correctness check reads. The same task and program then
run the window: the pool's groups in turn, at most two groups in flight,
until `--seconds` have passed on the host's clock; the window ends when the
device has finished the last group. `train_images_per_s` is every image of
every step of the window over the window's wall time.

With `--trace 1` a short traced window (`traced_groups` groups) follows, in
the same loop, under torch.profiler.
"""
from __future__ import annotations

import math
import time

from portbench.harness import check, device as dev, inputs, trace as tr

# the host spans of this loop that label the card's idle gaps
SPANS = ("replay", "sync")


def pool(cell, seed: int, device, groups: int) -> list:
    """The first `groups` groups of the seed's pool, stacked (k, B, ...)."""
    t = cell.traffic
    g = inputs.generator(seed, 1, device)
    return [inputs.stacked([inputs.batch(t, cell.config, g, device)
                            for _ in range(t["steps_per_group"])])
            for _ in range(groups)]


def model_shapes(task) -> dict:
    """{name: shape} of every weight and buffer, in the model's order: the
    order in which the seed's draw is carved."""
    return {n: tuple(v.shape) for n, v in task.model.state_dict().items()}


def run_groups(multi, state, groups: list, first: int, until, spans: bool):
    """Groups of the pool in turn from index `first`, at most two in flight,
    until `until(groups run)` is true. Returns (state, groups run, losses)."""
    markers, losses, n = [], [], 0
    while True:
        with tr.span("replay", spans):
            state, metrics = multi(state, groups[(first + n) % len(groups)])
        losses.append(metrics["loss"])
        markers.append(dev.Marker(groups[0]["image"].device))
        n += 1
        if len(markers) > 2:
            with tr.span("sync", spans):
                markers.pop(0).wait()
        if until(n):
            break
    with tr.span("sync", spans):
        for m in markers:
            m.wait()
    return state, n, losses


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device) -> dict:
    t = cell.traffic
    k, batch = t["steps_per_group"], t["batch"]
    phases = dev.Phases(t0, device)
    task = cell.port().build_task(cell.config, t["recipe"], device)
    phases.mark("build")
    shapes = model_shapes(task)
    weights = inputs.weights(shapes, cell.config["init"], seed, device)
    phases.mark("weights")
    state = task.init(params=weights)
    del weights
    phases.mark("init")
    groups = pool(cell, seed, device, t["groups_in_pool"])
    phases.mark("pool")
    multi = task.compile_train_multistep(k)
    checked = cell.limits["checked_groups"]
    state, reading = check.checked_groups(multi, task, state, groups, checked)
    phases.mark("checked_groups")
    dev.free(device)
    dev.sync(device)
    setup_peak = dev.peak_bytes(device)
    setup_s = time.perf_counter() - t0
    phases.mark("reading")

    dev.reset_peak(device)
    w0 = time.perf_counter()
    state, n, losses = run_groups(multi, state, groups, checked,
                                  lambda i: time.perf_counter() - w0 >= seconds, False)
    window_s = time.perf_counter() - w0
    window_peak = dev.peak_bytes(device, reserved=True)
    out = {"setup_s": setup_s, "phases": phases.seconds, "window_s": window_s,
           "steps": n * k, "images": n * k * batch, "peak_window_bytes": window_peak,
           "memory_peak_bytes": max(setup_peak, window_peak), "attempted": n * k,
           # every step of a group whose mean loss is not finite
           "failed": k * sum(not math.isfinite(float(x)) for x in losses)}

    if trace:
        with tr.Window(SPANS) as w:
            state, _, _ = run_groups(multi, state, groups, checked + n,
                                     lambda i: i >= t["traced_groups"], True)
        out["trace"] = w.summary()
        out["trace"]["steps"] = t["traced_groups"] * k

    del state, multi, task, groups
    dev.free(device)
    r0 = time.perf_counter()
    out["checks"] = reference_check(cell, seed, device, reading, shapes)
    out["phases"]["reference"] = time.perf_counter() - r0
    return out


def reference_check(cell, seed: int, device, reading: dict, shapes: dict) -> dict:
    """The compared numbers of the checked groups against the reference."""
    weights = inputs.weights(shapes, cell.config["init"], seed, device)
    ref = check.run_reference(cell, weights, checked_steps(cell, seed, device), device)
    return check.train_numbers(reading, ref)


def checked_steps(cell, seed: int, device) -> list:
    """The batches of the checked groups' steps, one dict a step."""
    groups = pool(cell, seed, device, cell.limits["checked_groups"])
    return [{n: v[i] for n, v in g.items()} for g in groups
            for i in range(cell.traffic["steps_per_group"])]

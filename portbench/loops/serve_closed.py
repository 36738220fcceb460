"""Serving in a closed loop of one client through `serving.task_predict_fn`.

Set-up builds the task's model, loads the weights drawn from the seed,
draws a pool of `requests_in_pool` requests (uint8 images and their prompt,
in pinned host memory, as a server receives them) and serves each once. The
window then sends the pool's requests in turn, each as soon as the last one
has its answer, until `--seconds` have passed: a request runs from its call
(the copy of its inputs to the card) until its f32 probabilities are in the
host's memory. `serve_p95_ms` is the 95th percentile of every request of the
window, `serve_images_per_s` every image answered over the window's wall
time. The benchmark's own span `predict_call` (the program's call, from its
start to its return, before anything waits for the card) is the host's
dispatch.

The answers of the pool's last round stay in the host buffers; once the
window has closed, `checked_requests` of them, drawn from the seed, are held
against the reference.
"""
from __future__ import annotations

import random
import time

import torch

from portbench.harness import check, device as dev, inputs, trace as tr

# the host spans of this loop that label the card's idle gaps
SPANS = ("to_device", "predict_call", "to_host", "sync")


def request_pool(cell, seed: int, device, pin: bool) -> list:
    t = cell.traffic
    g = inputs.generator(seed, 2, device)
    out = []
    for _ in range(t["requests_in_pool"]):
        req = inputs.batch(t, cell.config, g, device)
        req = {k: v.cpu() for k, v in req.items()}
        out.append({k: v.pin_memory() for k, v in req.items()} if pin else req)
    return out


class Server:
    """The program's predict function and the loop's buffers."""

    def __init__(self, cell, seed: int, device, phases):
        from tunevlseg_torch.serving import task_predict_fn
        t = cell.traffic
        self.device = device
        self.task = cell.port().build_task(cell.config, t["recipe"], device)
        self.task.model.eval()
        phases.mark("build")
        self.shapes = {n: tuple(v.shape) for n, v in self.task.model.state_dict().items()}
        weights = inputs.weights(self.shapes, cell.config["init"], seed, device)
        self.task.init(params=weights)
        del weights
        self.params = dict(self.task.model.state_dict())
        phases.mark("weights")
        self.predict = task_predict_fn(self.task)
        pin = torch.device(device).type == "cuda"
        self.pool = request_pool(cell, seed, device, pin)
        b, size = t["batch"], cell.config["image_size"]
        self.answers = [torch.empty((b, 1, size, size), pin_memory=pin)
                        for _ in self.pool]

    def serve(self, i: int, spans: bool) -> tuple:
        """Request i of the pool's rotation: (latency s, dispatch s)."""
        j = i % len(self.pool)
        t0 = time.perf_counter()
        with tr.span("to_device", spans):
            batch = {k: v.to(self.device, non_blocking=True) for k, v in self.pool[j].items()}
        with tr.span("predict_call", spans):
            t1 = time.perf_counter()
            probs = self.predict(self.params, batch)
            t2 = time.perf_counter()
        with tr.span("to_host", spans):
            self.answers[j].copy_(probs)
        return time.perf_counter() - t0, t2 - t1


def run(cell, seed: int, seconds: float, trace: bool, t0: float, device) -> dict:
    t = cell.traffic
    phases = dev.Phases(t0, device)
    server = Server(cell, seed, device, phases)
    phases.mark("pool")
    for i in range(len(server.pool)):
        server.serve(i, False)
    dev.free(device)
    dev.sync(device)
    phases.mark("warm_up")
    setup_peak = dev.peak_bytes(device)
    setup_s = time.perf_counter() - t0

    dev.reset_peak(device)
    latency, dispatch = [], []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        lat, enq = server.serve(len(latency), False)
        latency.append(lat)
        dispatch.append(enq)
    window_s = time.perf_counter() - w0
    window_peak = dev.peak_bytes(device, reserved=True)
    n = len(latency)
    out = {"setup_s": setup_s, "phases": phases.seconds, "window_s": window_s,
           "requests": n,
           "images": n * t["batch"], "latency_s": latency, "dispatch_s": dispatch,
           "peak_window_bytes": window_peak,
           "memory_peak_bytes": max(setup_peak, window_peak),
           "attempted": n, "failed": 0}
    # answers of the pool's last round, sampled from the seed
    last = sorted((n - 1 - m) % len(server.pool) for m in range(min(n, len(server.pool))))
    picks = random.Random(seed).sample(last, min(len(last), cell.limits["checked_requests"]))
    answers = [server.answers[j].clone() for j in picks]

    if trace:
        with tr.Window(SPANS) as w:
            for i in range(t["traced_requests"]):
                server.serve(n + i, True)
            with tr.span("sync", True):
                dev.sync(device)
        out["trace"] = w.summary()
        out["trace"]["requests"] = t["traced_requests"]

    inputs_ = [server.pool[j] for j in picks]
    shapes = server.shapes
    del server
    dev.free(device)
    r0 = time.perf_counter()
    weights = inputs.weights(shapes, cell.config["init"], seed, device)
    want = check.reference_probabilities(
        cell, weights, [{k: v.to(device) for k, v in r.items()} for r in inputs_], device)
    out["checks"] = check.serve_numbers(answers, want)
    out["phases"]["reference"] = time.perf_counter() - r0
    return out

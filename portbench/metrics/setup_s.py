"""Set-up: from the process's start to the first timed step or request
(building, weights, warm-up, capture, kernels built at first use)."""


def read(run: dict, cell) -> float:
    return run["setup_s"]

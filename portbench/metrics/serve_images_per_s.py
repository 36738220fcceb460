"""Every image whose probabilities reached the host in the window over the
window's wall time."""


def read(run: dict, cell) -> float:
    return run["images"] / run["window_s"]

"""Every image of every step of the window over the window's wall time."""


def read(run: dict, cell) -> float:
    return run["images"] / run["window_s"]

"""The device memory the window's steps hold at their peak:
`torch.cuda.max_memory_allocated()` after `reset_peak_memory_stats()` at
the window's start."""


def read(run: dict, cell) -> float:
    return run["peak_window_bytes"] / 2 ** 30

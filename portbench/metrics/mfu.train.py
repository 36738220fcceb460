"""The whole train step's share of the card's bf16 peak: the operations a
step needs (`portbench/work/`) times the window's steps, over the window's
wall time and 989 TFLOP/s."""
from portbench.harness.peaks import BF16_FLOPS_PER_S


def read(run: dict, cell) -> float:
    flops = cell.work().train_work(cell)["flops"]
    return 100.0 * flops * run["steps"] / run["window_s"] / BF16_FLOPS_PER_S

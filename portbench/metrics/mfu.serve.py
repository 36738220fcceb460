"""The whole request's share of the card's bf16 peak: the operations of a
forward (`portbench/work/`) times the window's requests, over the window's
wall time and 989 TFLOP/s."""
from portbench.harness.peaks import BF16_FLOPS_PER_S


def read(run: dict, cell) -> float:
    flops = cell.work().serve_work(cell)["flops"]
    return 100.0 * flops * run["requests"] / run["window_s"] / BF16_FLOPS_PER_S

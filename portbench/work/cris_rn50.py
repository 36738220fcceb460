"""The work of a CRIS RN50 step or request, at the cell's shapes: the
operations of the plain reference's pass and the bounds of its K1 and K2
launches (`work/common.py`)."""
from portbench.work import common


def train_work(cell) -> dict:
    return common.cell_work(cell, train=True)


def serve_work(cell) -> dict:
    return common.cell_work(cell, train=False)

"""The card between two captured groups, in ms: the median over every
replay of the run (set-up, the measured window and the traced one) of the
program's `captured.gap`, from the previous group's end event to this
group's begin event, just before its launch (`tunevlseg_torch/utils/
profiling.py`). None where the program has no such registry or record."""
import statistics


def read(run: dict, cell):
    try:
        from tunevlseg_torch.utils import profiling
    except ImportError:
        return None
    gaps = [r["ms"] for r in profiling.snapshot().get("records", [])
            if r["name"] == "captured.gap"]
    return statistics.median(gaps) if gaps else None

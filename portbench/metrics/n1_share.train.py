"""N1's share of the train step's LayerNorm calls, in %: the program's
counters `n1.launches` over `n1.launches` + `n1.plain`
(`tunevlseg_torch/utils/profiling.py`; counted as the steps are warmed up
and captured: a replayed graph counts nothing). None where the program has
no such counters."""


def read(run: dict, cell):
    try:
        from tunevlseg_torch.utils import profiling
    except ImportError:
        return None
    counters = profiling.snapshot().get("counters", {})
    n1, plain = counters.get("n1.launches", 0), counters.get("n1.plain", 0)
    if n1 + plain == 0:
        return None
    return 100.0 * n1 / (n1 + plain)

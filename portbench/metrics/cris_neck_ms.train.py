"""CRIS's neck stage in a captured train step on the card, in ms: the FPN that
gates C5 by the text state. The mean over the k steps of one replayed group
of the program's `cris.neck` span, a pair of timing events inside the CUDA
graph (`tunevlseg_torch/models/cris/model.py`, `utils/profiling.py`), from
the latest group that ran with no profiler recording, read as
`forward_ms.train` reads `step.forward`. None where the program has no such
registry, group or span."""


def read(run: dict, cell):
    try:
        from tunevlseg_torch.utils import profiling
    except ImportError:
        return None
    spans = profiling.snapshot().get("unprofiled", {}).get("spans", {})
    ms = spans.get("cris.neck")
    return sum(ms) / len(ms) if ms else None

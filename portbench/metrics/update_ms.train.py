"""A captured train step's update on the card, in ms: the clip, AdamW, the
accumulation window and the step's metrics.
The mean over the k steps of one replayed group of the program's
`step.update` span, a pair of timing events inside the CUDA graph
(`tunevlseg_torch/utils/profiling.py`): the latest group that ran with no
profiler recording (in a `--trace 1` run the measured window's last group,
read as the traced window opens). None where the program has no such
registry, group or span."""


def read(run: dict, cell):
    try:
        from tunevlseg_torch.utils import profiling
    except ImportError:
        return None
    snap = profiling.snapshot()
    spans = snap.get("unprofiled", {}).get("spans", {})
    ms = spans.get("step.update")
    return sum(ms) / len(ms) if ms else None

"""The share of the traced window in which nothing ran on the card:
1 - (union of the device records' intervals) / the window's wall."""


def read(run: dict, cell) -> float:
    t = run.get("trace")
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""The 95th percentile of the latencies of every request of the window,
from the call to the answer in the host's memory."""
import statistics


def read(run: dict, cell) -> float:
    lat = run["latency_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3

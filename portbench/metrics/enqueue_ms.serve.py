"""The host's dispatch of a request: the median over the window's requests
of the benchmark's span around the program's call (`predict_call`), from
its start to its return, before anything waits for the card."""
import statistics


def read(run: dict, cell) -> float:
    return statistics.median(run["dispatch_s"]) * 1e3

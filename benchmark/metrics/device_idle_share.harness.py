"""The share of the measured window in which no kernel, copy or memset ran
on the card, %: from the profiler's trace of the window
(benchmark/core/trace.py)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

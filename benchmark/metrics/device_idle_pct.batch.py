"""The card: the share of the traced window in which no kernel runs (the
union of the profiler's kernel intervals over the window; copies and
memsets do not count as busy)."""

from benchmark.trace import union_seconds


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    busy = union_seconds([(s, e) for _, s, e, k in run.trace["device_ops"] if k],
                         0.0, run.trace["window_s"])
    return 100.0 * (1.0 - busy / run.trace["window_s"])

"""End to end: the queries of the jobs that finished in the window, over
the time from the window's start to the last job's end: all the work over
all the time of a closed loop."""

from benchmark.metrics import ok_jobs


def read(run):
    if run.window_s <= 0:
        return None
    return sum(j["queries"] for j in ok_jobs(run)) / run.window_s

"""Align's host side: the share of the C++ traceback's thread time spent
on the scalar int32 path (pairs past the striped int16 path's overflow
gate), from the counters ``scalar_thread_s`` and ``striped_thread_s`` of
``align.traceback.native``, summed over the jobs.

None without a card (``run.card``): the benchmark's CPU test pins the set of
metrics a traced run on the CPU reports, and that test belongs to the
benchmark, so a reader added beside it stays silent there.  None too where
no finished job holds the span or counters (a program without them)."""

from benchmark.metrics import ok_jobs

COUNTERS = "align.traceback.native"


def read(run):
    if run.card is None:
        return None
    native = [j["phases"].get(COUNTERS, {}) for j in ok_jobs(run)]
    scalar = sum(d.get("scalar_thread_s", 0.0) for d in native)
    striped = sum(d.get("striped_thread_s", 0.0) for d in native)
    if scalar + striped <= 0:
        return None
    return 100.0 * scalar / (scalar + striped)

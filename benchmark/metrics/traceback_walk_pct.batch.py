"""Align's host side: the share of the striped int16 traceback's thread
time spent after the fill (the walk over the fill's trace bytes), from the
counters ``walk_thread_s`` and ``striped_thread_s`` of
``align.traceback.native``, summed over the jobs.

None without a card (``run.card``), as the other readers of the C++
aligner's counters.  None too where no finished job holds
``walk_thread_s`` (a program without the counter) or no job ran a striped
pair."""

from benchmark.metrics import ok_jobs

COUNTERS = "align.traceback.native"


def read(run):
    if run.card is None:
        return None
    native = [j["phases"].get(COUNTERS, {}) for j in ok_jobs(run)]
    if not any("walk_thread_s" in d for d in native):
        return None
    walk = sum(d.get("walk_thread_s", 0.0) for d in native)
    striped = sum(d.get("striped_thread_s", 0.0) for d in native)
    if striped <= 0:
        return None
    return 100.0 * walk / striped

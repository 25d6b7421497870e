"""Align's host side: the C++ traceback (native/aligner.cpp
``sift4g_align_batch``), the program's ``align.traceback.native`` span in
align/host.py, over the jobs' queries.

None without a card (``run.card``): the benchmark's CPU test pins the set of
metrics a traced run on the CPU reports, and that test belongs to the
benchmark, so a reader added beside it stays silent there.  None too where
no finished job holds the span or counters (a program without them)."""

from benchmark.metrics import ok_jobs, per_query_ms, phase_s

SPAN = "align.traceback.native"


def read(run):
    if run.card is None or not any(SPAN in j["phases"] for j in ok_jobs(run)):
        return None
    return per_query_ms(run, lambda j: phase_s(j, SPAN))

"""Align's host side (align/host.py): tracebacks of the kept alignments
over the jobs' queries.  The two-phase schedule counts them in
``align.traceback``; the overlapped one times nothing else in its ``align``
phase (E-values, the cap and ``align_pairs_batch``), so that phase stands
in where ``search`` says ``overlapped``."""

from benchmark.metrics import per_query_ms, phase_s


def _traceback_s(job):
    if job["phases"].get("search", {}).get("overlapped"):
        return phase_s(job, "align")
    return phase_s(job, "align.traceback")


def read(run):
    return per_query_ms(run, _traceback_s)

"""The search layer (prefilter/search.py, native/search.cpp): the ``search``
phase over the jobs' queries.  Under the overlapped schedule it holds the
provisional scoring dispatches too, as pipeline._run_overlapped nests them."""

from benchmark.metrics import per_query_ms, phase_s


def read(run):
    return per_query_ms(run, lambda j: phase_s(j, "search"))

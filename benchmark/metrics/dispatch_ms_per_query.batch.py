"""Align's host side (align/batch.py): the ``align.dispatch`` counter,
packing and enqueueing the scorer's launches, over the jobs' queries."""

from benchmark.metrics import per_query_ms, phase_s


def read(run):
    return per_query_ms(run, lambda j: phase_s(j, "align.dispatch"))

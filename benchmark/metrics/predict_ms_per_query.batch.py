"""The predict layer (pipeline.finish_pipeline, sift/*, io/writers.py): the
``predict`` phase over the jobs' queries."""

from benchmark.metrics import per_query_ms, phase_s


def read(run):
    return per_query_ms(run, lambda j: phase_s(j, "predict"))

"""The CLI and job layer (cli.py): each job's latency less its top-level
phases (search, align, select, predict), over the jobs' queries: reading
and checking the query and .subst files, the run manifest, everything
cli.main does outside the pipeline's phases."""

from benchmark.metrics import TOP_PHASES, per_query_ms, phase_s


def read(run):
    return per_query_ms(run, lambda j: j["latency_s"] - sum(phase_s(j, p) for p in TOP_PHASES))

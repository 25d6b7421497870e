"""Device predict's waits on the card (``sift/predict_batch.py``: each
wait on a chunk's ``done`` event, its scores back in pinned memory): the program's ``predict.fetch``
span over the jobs' queries.

None where no finished job holds the span: a job on host predict (the
spare ``swissprot-subst.proteome`` of the benchmark's CPU tests), or a
program without it."""

from benchmark.metrics import ok_jobs, per_query_ms, phase_s

SPAN = "predict.fetch"


def read(run):
    if not any(SPAN in j["phases"] for j in ok_jobs(run)):
        return None
    return per_query_ms(run, lambda j: phase_s(j, SPAN))

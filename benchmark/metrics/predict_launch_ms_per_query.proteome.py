"""Device predict's launches (``sift/predict_batch.py``: each chunk's
fill of its pinned buffer, its upload and the SIFT math enqueued on the
side stream): the program's ``predict.pack``
span over the jobs' queries.

None where no finished job holds the span: a job on host predict (the
spare ``swissprot-subst.proteome`` of the benchmark's CPU tests), or a
program without it."""

from benchmark.metrics import ok_jobs, per_query_ms, phase_s

SPAN = "predict.pack"


def read(run):
    if not any(SPAN in j["phases"] for j in ok_jobs(run)):
        return None
    return per_query_ms(run, lambda j: phase_s(j, SPAN))

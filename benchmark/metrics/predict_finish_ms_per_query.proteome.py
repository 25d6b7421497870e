"""Device predict's finish (``sift/predict_batch.py``,
``pipeline._predict_on_device``): the job's wait, after the last
fetch, on the writers and the subst finishers (the float64 re-derivation
of ``sift/predict_subst.py`` and the files): the program's ``predict.finish``
span over the jobs' queries.

None where no finished job holds the span: a job on host predict (the
spare ``swissprot-subst.proteome`` of the benchmark's CPU tests), or a
program without it."""

from benchmark.metrics import ok_jobs, per_query_ms, phase_s

SPAN = "predict.finish"


def read(run):
    if not any(SPAN in j["phases"] for j in ok_jobs(run)):
        return None
    return per_query_ms(run, lambda j: phase_s(j, SPAN))

"""Device predict's float64 share in subst mode: of the subst queries'
positions (``positions``), those the finishers re-derived in float64
(``exact_positions``, ``sift/predict_subst.sparse_exact_scores``) and those
of the queries that fell back whole to the float64 oracle
(``fallback_positions``), from the program's ``predict.finish`` counters
of the jobs.

None where no finished job holds the counters: a job on host predict, or a
program without them."""

from benchmark.metrics import ok_jobs

SPAN = "predict.finish"


def read(run):
    fin = [j["phases"].get(SPAN, {}) for j in ok_jobs(run)]
    positions = sum(d.get("positions", 0.0) for d in fin)
    if positions <= 0:
        return None
    exact = sum(d.get("exact_positions", 0.0) + d.get("fallback_positions", 0.0) for d in fin)
    return 100.0 * exact / positions

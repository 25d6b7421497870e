"""Device predict's subst finishers in the process pool: of the subst
queries' positions (``positions``), those of the queries whose finisher
ran in a worker of the process's spawn pool (``pooled_positions``,
``sift/predict_subst.JobFinishers``) and not on a writer thread, from the
program's ``predict.finish`` counters of the jobs.

None without a card (``run.card``): the benchmark's CPU test pins the set
of metrics a CPU traced run reports.  None too where no finished job holds
``pooled_positions`` (a job on host predict, or a program without the
counter)."""

from benchmark.metrics import ok_jobs

SPAN = "predict.finish"


def read(run):
    if run.card is None:
        return None
    fin = [j["phases"].get(SPAN, {}) for j in ok_jobs(run)]
    if not any("pooled_positions" in d for d in fin):
        return None
    positions = sum(d.get("positions", 0.0) for d in fin)
    if positions <= 0:
        return None
    return 100.0 * sum(d.get("pooled_positions", 0.0) for d in fin) / positions

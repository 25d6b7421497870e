"""The SW kernels' evicted work: under the overlapped schedule the share
of the cells scored provisionally (``align.provisional`` ``cells``,
pipeline._run_overlapped) whose candidates the search evicted later, so
that they are not among the final candidate sets' cells (``align``
``cells``), summed over the jobs.

None without a card (``run.card``): the benchmark's CPU test pins the set of
metrics a traced run on the CPU reports, and that test belongs to the
benchmark, so a reader added beside it stays silent there.  None too where
no finished job holds the span or counters (a program without them)."""

from benchmark.metrics import ok_jobs


def read(run):
    if run.card is None:
        return None
    # the overlapped jobs: a two-phase job scores no candidate it evicts
    jobs = [j for j in ok_jobs(run) if j["phases"].get("align.provisional", {}).get("cells")]
    if not jobs:
        return None
    provisional = sum(j["phases"]["align.provisional"]["cells"] for j in jobs)
    final = sum(j["phases"].get("align", {}).get("cells", 0.0) for j in jobs)
    return 100.0 * (1.0 - final / provisional)

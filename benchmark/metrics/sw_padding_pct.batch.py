"""The SW kernels' padding: the share of the cells the launches' grids
cover (``launched_cells``: padded query rows, every batch slot, the
rung's columns) that are no pair's cells (``cells``), summed over the
program's ``align.launch.k1``, ``.k2`` and ``.k3`` counters
(align/batch.py) of the jobs.

None without a card (``run.card``): the benchmark's CPU test pins the set of
metrics a traced run on the CPU reports, and that test belongs to the
benchmark, so a reader added beside it stays silent there.  None too where
no finished job holds the span or counters (a program without them)."""

from benchmark.metrics import ok_jobs

SPANS = ("align.launch.k1", "align.launch.k2", "align.launch.k3")


def read(run):
    if run.card is None:
        return None
    launches = [j["phases"].get(s, {}) for j in ok_jobs(run) for s in SPANS]
    launched = sum(d.get("launched_cells", 0.0) for d in launches)
    if launched <= 0:
        return None
    return 100.0 * (1.0 - sum(d.get("cells", 0.0) for d in launches) / launched)

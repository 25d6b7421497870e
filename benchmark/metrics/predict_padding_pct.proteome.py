"""Device predict's padding: the share of the cells its chunks cover
(``launched_cells``: ``Qc x n_pad x L_pad`` a chunk, lengths padded to 128
and rows to 64, ``sift/predict_batch.py``) that are no query's (``cells``:
each query's prepared rows times its length), summed over the program's
``predict.pack`` counters of the jobs.

None where no finished job holds the counters: a job on host predict, or a
program without them."""

from benchmark.metrics import ok_jobs

SPAN = "predict.pack"


def read(run):
    packs = [j["phases"].get(SPAN, {}) for j in ok_jobs(run)]
    launched = sum(d.get("launched_cells", 0.0) for d in packs)
    if launched <= 0:
        return None
    return 100.0 * (1.0 - sum(d.get("cells", 0.0) for d in packs) / launched)

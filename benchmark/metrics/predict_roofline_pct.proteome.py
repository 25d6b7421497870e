"""Device predict's SIFT math on the card: the least time the window's
device-predicted work needs at the card's bound (``benchmark/predict_bounds.py``:
the largest of its bytes, float32 and special-function terms, counted from
the plain reference's formulas) over the summed time of the device kernels
that start inside the jobs' ``phase:predict`` ranges.

The work is the program's ``predict.pack`` counters: ``cells``, each
device-predicted query's prepared rows times its length, and
``positions``, their lengths.  None without a card or a trace, or where no
finished job holds the counters (a job on host predict, or a program
without them)."""

from benchmark import predict_bounds
from benchmark.metrics import ok_jobs

SPAN = "predict.pack"


def read(run):
    if run.trace is None or run.card is None:
        return None
    packs = [j["phases"].get(SPAN, {}) for j in ok_jobs(run)]
    cells = sum(d.get("cells", 0.0) for d in packs)
    positions = sum(d.get("positions", 0.0) for d in packs)
    if cells <= 0 or positions <= 0:
        return None
    t = predict_bounds.kernel_seconds_in(run.trace, "predict")
    if t <= 0:
        return None
    return 100.0 * predict_bounds.least_seconds(cells, positions, run.card)["least"] / t

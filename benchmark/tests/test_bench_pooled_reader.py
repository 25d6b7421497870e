"""The reader of ``predict_pooled_pct.proteome`` on the CPU: the positions
of the subst queries finished in a pool worker over every subst query's
positions, summed over the finished jobs, and silent where no job holds
``pooled_positions`` (a program without the counter, a job on host
predict), where no job finished, and without a card."""

import pytest

from benchmark.metrics import load
from benchmark.tests import tiny

METRICS_DIR = tiny.ROOT + "/benchmark/metrics"
CARD = {"sw_cells_per_s": 3717.12e9}


class _Run:
    def __init__(self, jobs, card=CARD):
        self.jobs, self.card, self.trace, self.ref_cells = list(jobs), card, None, None


def _job(status=0, **finish):
    return {"queries": 250, "latency_s": 1.0, "status": status,
            "phases": {"predict.finish": dict(seconds=0.1, **finish)}}


def test_share_of_the_positions_finished_in_the_pool():
    read = load("predict_pooled_pct.proteome", METRICS_DIR)
    jobs = [_job(positions=1000.0, exact_positions=40.0, pooled_positions=0.0),   # inline
            _job(positions=3000.0, exact_positions=90.0, pooled_positions=2500.0),
            _job(status=-1, positions=9000.0, pooled_positions=9000.0)]  # failed: not counted
    assert read(_Run(jobs)) == pytest.approx(100.0 * 2500.0 / 4000.0)
    assert read(_Run(jobs[:1])) == 0.0


@pytest.mark.parametrize("jobs, card", [
    ([_job(positions=1000.0, exact_positions=40.0)], CARD),   # the counter's parent
    ([{"queries": 250, "latency_s": 1.0, "status": 0, "phases": {}}], CARD),   # host predict
    ([], CARD),
    ([_job(positions=1000.0, pooled_positions=1000.0)], None),   # no card
], ids=["no-counter", "host-predict", "no-job", "no-card"])
def test_silent_where_there_is_nothing_to_read(jobs, card):
    assert load("predict_pooled_pct.proteome", METRICS_DIR)(_Run(jobs, card)) is None

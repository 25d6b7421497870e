"""The reader of ``traceback_walk_pct.batch`` on the CPU: the striped
traceback's seconds after the fill over its seconds, summed over the
finished jobs, and silent where no job holds ``walk_thread_s`` (a program
without the counter), where no job ran a striped pair, and without a
card."""

import pytest

from benchmark.metrics import load
from benchmark.tests import tiny

METRICS_DIR = tiny.ROOT + "/benchmark/metrics"
CARD = {"sw_cells_per_s": 3717.12e9}


class _Run:
    def __init__(self, jobs, card=CARD):
        self.jobs, self.card, self.trace, self.ref_cells = list(jobs), card, None, None


def _job(status=0, **native):
    return {"queries": 20, "latency_s": 1.0, "status": status,
            "phases": {"align.traceback.native": dict(seconds=1.0, **native)}}


def test_share_of_the_striped_seconds_after_the_fill():
    read = load("traceback_walk_pct.batch", METRICS_DIR)
    jobs = [_job(striped_thread_s=4.0, scalar_thread_s=1.0, walk_thread_s=0.1),
            _job(striped_thread_s=6.0, walk_thread_s=0.3),
            _job(status=-1, striped_thread_s=9.0, walk_thread_s=9.0)]  # failed: not counted
    assert read(_Run(jobs)) == pytest.approx(100.0 * 0.4 / 10.0)


@pytest.mark.parametrize("jobs, card", [
    ([_job(striped_thread_s=4.0, scalar_thread_s=1.0)], CARD),   # the counter's parent
    ([_job(scalar_thread_s=3.0, walk_thread_s=0.0)], CARD),      # no striped pair
    ([], CARD),
    ([_job(striped_thread_s=4.0, walk_thread_s=0.1)], None),     # no card
], ids=["no-counter", "no-striped-pair", "no-job", "no-card"])
def test_silent_where_there_is_nothing_to_read(jobs, card):
    assert load("traceback_walk_pct.batch", METRICS_DIR)(_Run(jobs, card)) is None

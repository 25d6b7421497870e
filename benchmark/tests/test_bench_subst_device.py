"""The subst-mode cell with device predict (``swissprot-subst.proteome-dev-predict``):
small runs on the CPU, where ``--backend native`` runs the device branch's
float32 math on the host, the readers of its per-layer metrics, and the
control of ``correct`` (``benchmark/control_screen.py``) as a fault."""

import pytest

from benchmark import predict_bounds
from benchmark.metrics import load
from benchmark.tests import tiny

CELL = "swissprot-subst.proteome-dev-predict"
SPAN_METRICS = ("predict_prep_ms_per_query.proteome", "predict_launch_ms_per_query.proteome",
                "predict_fetch_ms_per_query.proteome", "predict_finish_ms_per_query.proteome")
COUNTER_METRICS = ("predict_padding_pct.proteome", "predict_exact_pct.proteome")
ROOFLINE = "predict_roofline_pct.proteome"
# the accepted per-layer metrics that list the cell too and read on the CPU
# (the search, align, predict and job layers it shares with the other cells)
CPU_BATCH_METRICS = ("search_ms_per_query.batch", "dispatch_ms_per_query.batch",
                     "traceback_ms_per_query.batch", "predict_ms_per_query.batch",
                     "outside_phases_ms_per_query.batch", "device_idle_pct.batch")
METRICS_DIR = tiny.ROOT + "/benchmark/metrics"


def test_small_run_of_the_device_predict_cell_matches_the_reference():
    out = tiny.run(CELL, seed=2**31 + 17)
    res = out["result"]
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    assert res["metrics"]["queries_per_s"]["value"] == pytest.approx(
        res["attempted"] / out["info"]["window_s"])
    assert out["info"]["checked_job_queries"] == 6


def test_small_traced_run_reports_the_device_predict_metrics():
    out = tiny.run(CELL, seed=2**31 + 18, trace=True)
    res = out["result"]
    assert res["correct"] is True, res["check"]
    # no card: the roofline and the accepted readers of the card or its
    # trace find nothing; the rest is the program's spans and counters
    assert set(res["metrics"]) == set(SPAN_METRICS + COUNTER_METRICS + CPU_BATCH_METRICS)
    for name in SPAN_METRICS:
        assert res["metrics"][name]["value"] >= 0
    assert 0 < res["metrics"]["predict_padding_pct.proteome"]["value"] < 100
    assert 0 < res["metrics"]["predict_exact_pct.proteome"]["value"] <= 100
    # the idle window is laid to the new spans
    labels = {name for name, _ in res["breakdown"]["idle_gaps"]}
    assert labels & {"predict.prep", "predict.pack", "predict.fetch", "predict.finish"}


def test_finishers_that_print_the_float32_screen_are_caught():
    """The fault: the finishers skip the float64 re-derivation and write
    the float32 screen scaled by 0.999.  Jobs of 12 queries cut the small
    pool into the warm-up and one window job, so the job checked is the
    same however many jobs the window runs, and holds twelve files."""
    from benchmark.control_screen import control

    def one_window_job(tr):
        tr["job_queries"] = 12

    out = control(tiny.ROOT, CELL, 2**31 + 19, scale=0.999, require_cuda=False,
                  config_edit=tiny.config, traffic_edit=one_window_job,
                  program_flags=tiny.CPU_FLAGS)
    assert out["control_correct"] is False
    assert out["checked_queries"] == 12
    assert out["files_mismatched"] > 0 and out["files_missing"] == 0


class _Run:
    def __init__(self, jobs, trace=None, card=None):
        self.jobs, self.trace, self.card, self.ref_cells = jobs, trace, card, None


def _job(queries, status=0, **phases):
    return {"queries": queries, "latency_s": 1.0, "status": status,
            "phases": {k.replace("__", "."): v for k, v in phases.items()}}


def test_predict_roofline_from_fixed_card():
    card = {"sms": 132, "max_sm_mhz": 1980.0}
    cells, positions = 4e9, 2e6
    terms = predict_bounds.least_seconds(cells, positions, card)
    clock = 132 * 1980e6
    assert terms["bytes"] == pytest.approx((cells + 104 * positions) / 3.35e12)
    assert terms["fp32"] == pytest.approx((5 * cells + 1676 * positions) / (128 * clock))
    assert terms["sfu"] == pytest.approx((cells + 393 * positions) / (16 * clock))
    assert terms["least"] == max(terms["bytes"], terms["fp32"], terms["sfu"])
    jobs = [_job(250, predict__pack={"cells": cells / 2, "positions": positions / 2}),
            _job(250, predict__pack={"cells": cells / 2, "positions": positions / 2}),
            _job(250, status=-1, predict__pack={"cells": 9e12, "positions": 9e9})]
    # kernels that start inside a predict range count once, whichever of
    # the nested ranges (program's, harness's) holds them; the SW kernel,
    # the copy and the kernel outside predict do not count
    trace = {"window_s": 10.0,
             "ranges": [("phase:predict", 1.0, 3.0), ("phase:predict", 1.0, 3.0),
                        ("phase:predict.pack", 1.1, 1.2), ("phase:predict", 6.0, 8.0)],
             "device_ops": [("sum_kernel", 1.2, 1.3, True), ("lgamma_kernel", 6.5, 6.6, True),
                            ("Memcpy HtoD", 1.1, 2.0, False),
                            ("sw_tiled_kernel", 0.0, 0.9, True), ("exp_kernel", 4.0, 5.0, True)]}
    read = load(ROOFLINE, METRICS_DIR)
    got = read(_Run(jobs, trace, card))
    assert got == pytest.approx(100.0 * terms["least"] / 0.2)
    assert read(_Run(jobs, None, card)) is None
    assert read(_Run(jobs, trace, None)) is None
    # a job on host predict holds no counters
    assert read(_Run([_job(250, predict={"seconds": 3.0})], trace, card)) is None


@pytest.mark.parametrize("name, want", [
    ("predict_prep_ms_per_query.proteome", 1e3 * 3.0 / 40),
    ("predict_launch_ms_per_query.proteome", 1e3 * 0.6 / 40),
    ("predict_fetch_ms_per_query.proteome", 1e3 * 0.9 / 40),
    ("predict_finish_ms_per_query.proteome", 1e3 * 4.5 / 40),
    ("predict_padding_pct.proteome", 100.0 * (1 - 700.0 / 1000.0)),
    ("predict_exact_pct.proteome", 100.0 * (10.0 + 30.0 + 20.0) / 300.0),
])
def test_reader_of_each_device_predict_metric(name, want):
    jobs = [_job(10, predict__prep={"seconds": 1.0}, predict__fetch={"seconds": 0.4},
                 predict__pack={"seconds": 0.2, "cells": 300.0, "launched_cells": 600.0},
                 predict__finish={"seconds": 2.0, "positions": 100.0, "exact_positions": 10.0,
                                  "fallback_positions": 0.0}),
            _job(30, predict__prep={"seconds": 2.0}, predict__fetch={"seconds": 0.5},
                 predict__pack={"seconds": 0.4, "cells": 400.0, "launched_cells": 400.0},
                 predict__finish={"seconds": 2.5, "positions": 200.0, "exact_positions": 30.0,
                                  "fallback_positions": 20.0}),
            _job(50, status=-1, predict__prep={"seconds": 9.0},
                 predict__pack={"cells": 0.0, "launched_cells": 9e9},
                 predict__finish={"positions": 9.0, "exact_positions": 9.0})]
    read = load(name, METRICS_DIR)
    assert read(_Run(jobs)) == pytest.approx(want)
    # jobs on host predict (the spare .proteome cell) hold none of them
    assert read(_Run([_job(10, predict={"seconds": 1.0})])) is None
    assert read(_Run([])) is None


def test_sift_math_control_lowers_the_sift_math_alone():
    """``benchmark.control_sift_math`` runs the reference control with the
    selection at its stated float32: inside the block a lowered selection
    keeps the rows the stated one keeps, and the block restores it."""
    import numpy as np
    import torch

    from benchmark.control_sift_math import control, selection_as_stated
    from benchmark.reference import sift

    real = sift.alignments_select
    rows = np.random.default_rng(3).integers(0, 20, size=(40, 30)).astype(np.uint8)
    with selection_as_stated():
        assert sift.alignments_select(rows, 2.75, True) == real(rows, 2.75, False)
    assert sift.alignments_select is real
    out = control(tiny.ROOT, CELL, 2**31 + 20, torch.device("cpu"), config_edit=tiny.config,
                  traffic_edit=tiny.traffic)
    assert out["lowered"] == "sift_math" and out["files"] > 0
    assert 0 <= out["files_mismatched"] <= out["files"]
    assert sift.alignments_select is real

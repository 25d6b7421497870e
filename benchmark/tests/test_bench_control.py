"""On a card: the control of ``correct`` at a size a test run holds.

The cells' own control (``python3 -m benchmark.control``) runs at each
cell's size on three seeds or more; PERF.md keeps its readings.  Here the
same comparison at the small size of the CPU tests: the reference's SIFT
math in float32 against float64 must differ in matrix mode, and the
program on the card must match the float64 reference in both cells."""

import numpy as np
import pytest

from benchmark.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_float32_control_fails_matrix_mode(card, seed):
    from benchmark.control import control

    def bigger(tr):
        tr["job_queries"] = 6

    out = control(tiny.ROOT, "swbench-matrix.long", seed, card, config_edit=tiny.config,
                  traffic_edit=bigger)
    assert out["files"] > 0
    assert out["control_correct"] is False


@pytest.mark.gpu
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_program_on_the_card_matches_the_reference(card, workload):
    from benchmark.run import run_cell

    out = run_cell(tiny.root_for(workload), workload, 2**31 + 9, 1.0, True,
                   config_edit=tiny.config, traffic_edit=tiny.traffic)
    res = out["result"]
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["sw_roofline_pct.batch"]["value"])

"""A run with the timed path broken underneath must come out not correct.

Each test drives a small run of a cell without a card (the native
backend) with one fault planted in the program, and sees ``correct``
false.  The faults a SIFT4G job can have: an answer altered where it is
produced (the SIFT scores), half of a job's queries left out, and the
scorer returning without scoring (every score 0).  A one-card cell has no
exchange between chips to leave out."""

import numpy as np
import pytest

from benchmark.tests import tiny


def _run_with(monkeypatch, workload, target, replacement):
    monkeypatch.setattr(target[0], target[1], replacement)
    return tiny.run(workload)["result"]


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_an_altered_answer_is_caught(monkeypatch, workload):
    from sift4g_tpu_torch.sift import predict

    real = predict.calc_sift_scores

    def altered(rows, raw):
        sift, w, nd = real(rows, raw)
        return sift * 0.98, w, nd

    res = _run_with(monkeypatch, workload, (predict, "calc_sift_scores"), altered)
    assert res["correct"] is False
    assert res["check"]["files_mismatched"]["value"] > 0


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_half_of_a_job_left_out_is_caught(monkeypatch, workload):
    from sift4g_tpu_torch import pipeline

    real = pipeline.check_data

    def half(queries, subst_dir, log=None):
        kept = real(queries, subst_dir, log=log)
        return kept[: len(kept) // 2]

    res = _run_with(monkeypatch, workload, (pipeline, "check_data"), half)
    assert res["correct"] is False
    assert res["check"]["files_missing"]["value"] > 0


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_a_scorer_that_does_not_score_is_caught(monkeypatch, workload):
    from sift4g_tpu_torch.align.batch import BatchAligner

    def unscored(self, items, screen=None):
        return lambda: [np.zeros(len(t), dtype=np.int64) for _, t in items]

    res = _run_with(monkeypatch, workload, (BatchAligner, "scores_many_async"), unscored)
    assert res["correct"] is False

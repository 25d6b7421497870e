"""The port's C++ traceback (``native/aligner.cpp``, through
``align.host.align_pairs_batch``) in SW mode: every pair runs the striped
int16 fill first and is rerun on the scalar int32 path only when that
fill's own best reaches 30,000.  Held byte for byte (score, ends, moves),
on pairs past the length bound ``min(qlen, n) * 11 >= 30000`` that used to
send them to the scalar path and on pairs either side of 30,000, to two
witnesses: the JAX package's own C++ aligner
(``sift4g_tpu.align.batch.align_pairs_batch``), which still gates on the
length bound and so aligns these pairs on its scalar int32 path, and the
port's scalar path itself, ``SIFT4G_TPU_NO_SIMD=1``."""

import numpy as np
import pytest

from benchmark.gen.synth import STD, mutate_many
from sift4g_tpu import native as jax_native
from sift4g_tpu.align.batch import align_pairs_batch as jax_align_pairs_batch
from sift4g_tpu.core.scorers import create_scorer as jax_create_scorer
from sift4g_tpu_torch import native
from sift4g_tpu_torch.align.host import align_pairs_batch
from sift4g_tpu_torch.align.records import MOVE_LEFT, MOVE_UP
from sift4g_tpu_torch.core.scorers import create_scorer
from sift4g_tpu_torch.utils import PhaseMetrics

pytestmark = pytest.mark.skipif(native.load() is None or jax_native.load() is None,
                                reason="native engines unavailable")

SCORER = create_scorer("BLOSUM_62", 10, 1)
JAX_SCORER = jax_create_scorer("BLOSUM_62", 10, 1)
MATMAX = 11  # BLOSUM62's largest |score|, W against W


def _align(monkeypatch, q, targets, scalar):
    """The records and the C++ counters of one SW call, on the striped
    path's gate or, with ``scalar``, on the scalar path alone."""
    if scalar:
        monkeypatch.setenv("SIFT4G_TPU_NO_SIMD", "1")
    else:
        monkeypatch.delenv("SIFT4G_TPU_NO_SIMD", raising=False)
    m = PhaseMetrics(enabled=False)
    recs = align_pairs_batch(q, targets, SCORER, "SW", threads=2, metrics=m)
    return recs, m.phases["align.traceback.native"]


def _assert_same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert (g.score, g.query_start, g.query_end, g.target_start, g.target_end) == \
            (w.score, w.query_start, w.query_end, w.target_start, w.target_end), k
        np.testing.assert_array_equal(g.moves, w.moves, err_msg=str(k))


def _check(monkeypatch, q, targets):
    """The port's records against both witnesses; returns the scalar
    witness's records and the counters of the port's call and of it."""
    got, d = _align(monkeypatch, q, targets, scalar=False)
    want, w = _align(monkeypatch, q, targets, scalar=True)
    monkeypatch.delenv("SIFT4G_TPU_NO_SIMD", raising=False)
    _assert_same(got, jax_align_pairs_batch(q, targets, JAX_SCORER, "SW", threads=2))
    _assert_same(got, want)
    return want, d, w


@pytest.mark.parametrize("qlen, seed", [(2800, 1), (3300, 2), (3600, 3)])
def test_homologs_past_the_length_bound_stay_striped_and_exact(monkeypatch, qlen, seed):
    """Homologs as the benchmark's generator makes them (substitutions at
    10-50 %, 6 % single-residue indels) of a query past the length bound."""
    assert qlen * MATMAX >= 30000
    rng = np.random.default_rng(seed)
    q = rng.choice(STD, size=qlen).astype(np.uint8)
    rates = np.array([0.1, 0.2, 0.35, 0.5])
    src = np.tile(q, rates.size)
    src_of = np.repeat(np.arange(rates.size), qlen)
    codes, lens = mutate_many(rng, src, src_of, rates.size, rates, 0.06)
    offs = np.concatenate(([0], np.cumsum(lens)))
    targets = [codes[offs[i]:offs[i + 1]].astype(np.uint8) for i in range(rates.size)]
    want, d, w = _check(monkeypatch, q, targets)
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0
    assert w["striped_cells"] == 0 and w["saturated_pairs"] == 0
    assert 0 < max(r.score for r in want) < 30000


def test_tie_heavy_pair_past_the_length_bound_is_exact(monkeypatch):
    """A tiny alphabet (A, B, C) makes many equal H values, where a wrong
    cell or tie order would diverge first."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 3, 3000).astype(np.uint8)
    homolog = q.copy()
    homolog[::5] = rng.integers(0, 3, homolog[::5].size)
    targets = [rng.integers(0, 3, 2900).astype(np.uint8), homolog]
    _, d, _ = _check(monkeypatch, q, targets)
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0


def test_long_gaps_past_the_length_bound_are_exact(monkeypatch):
    """A homolog with a 40-residue deletion and a 25-residue insertion: the
    walk follows long runs of E and F, where a wrong gap rebuild or gap
    tie would diverge."""
    rng = np.random.default_rng(11)
    q = rng.choice(STD, size=3200).astype(np.uint8)
    homolog = np.concatenate([q[:800], q[840:2000], rng.choice(STD, size=25), q[2000:]])
    sub = rng.random(homolog.size) < 0.15
    homolog[sub] = rng.choice(STD, size=int(sub.sum()))
    targets = [homolog.astype(np.uint8), rng.choice(STD, size=3100).astype(np.uint8)]
    want, d, _ = _check(monkeypatch, q, targets)
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0
    assert {MOVE_LEFT, MOVE_UP} <= set(np.unique(want[0].moves).tolist())


def _code(letter):
    return ord(letter) - ord("A")


@pytest.mark.parametrize("tail, best, path", [
    ("CA", 29999, "striped"),    # 2,726 x W-W 11 + C-C 9 + A-A 4
    ("HG", 30000, "scalar"),     # + H-H 8 + G-G 6: the fill reaches the limit
], ids=["under", "at"])
def test_either_side_of_the_int16_limit(monkeypatch, tail, best, path):
    """A run of W and a short tail against itself: its best is the diagonal
    sum.  Under 30,000 the striped result stands; at it the pair is rerun on
    the scalar path.  (A pair whose int16 fill clips, past 32,767, is
    ``test_torch_tracing.py::test_traceback_counts_the_cells_of_each_path``'s
    saturated case.)"""
    q = np.array([_code("W")] * 2726 + [_code(c) for c in tail], dtype=np.uint8)
    rng = np.random.default_rng(best)
    targets = [q.copy(), rng.choice(STD, size=500).astype(np.uint8)]
    want, d, _ = _check(monkeypatch, q, targets)
    assert want[0].score == best
    pair = float(q.size) * q.size
    assert d["saturated_pairs"] == (1 if path == "scalar" else 0)
    assert d["scalar_cells"] == (pair if path == "scalar" else 0)
    assert d["striped_cells"] == d["cells"] - d["scalar_cells"]

"""The port's C++ traceback (``native/aligner.cpp``, through
``align.host.align_pairs_batch``) in SW mode: every pair runs the striped
int16 fill first, which writes a trace byte a cell and finds the endpoint,
and the walk reads the bytes; a pair is rerun on the scalar int32 path only
when that fill's own best reaches 30,000.  Held byte for byte (score, ends,
moves), on pairs past the length bound ``min(qlen, n) * 11 >= 30000`` that
used to send them to the scalar path, on pairs either side of 30,000, and
on the trace's edges (short queries and pad lanes, vertical gaps across the
segment wrap, a vertical gap met at once by a horizontal one, tied best
cells, no positive cell), to two witnesses: the JAX package's own C++
aligner (``sift4g_tpu.align.batch.align_pairs_batch``), which rebuilds E
and F from stored H, and the port's scalar path itself,
``SIFT4G_TPU_NO_SIMD=1``."""

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


def _seg_len(qlen):
    return (qlen + 15) // 16


def _runs(moves, move):
    """The lengths of the runs of ``move`` in a path."""
    out, n = [], 0
    for m in list(moves) + [-1]:
        if m == move:
            n += 1
        elif n:
            out.append(n)
            n = 0
    return out


@pytest.mark.parametrize("qlen", [1, 2, 5, 15, 16, 17, 23, 31, 32, 33, 40])
def test_short_queries_at_the_segment_edges(monkeypatch, qlen):
    """Queries of 1-40 residues: one segment or a few, lanes past the query
    padded, lengths on and off multiples of 16."""
    rng = np.random.default_rng(100 + qlen)
    q = rng.choice(STD, size=qlen).astype(np.uint8)
    homolog = q.copy()
    homolog[::4] = rng.choice(STD, size=homolog[::4].size)
    targets = [homolog, q[::-1].copy(), rng.choice(STD, size=1).astype(np.uint8),
               rng.choice(STD, size=qlen + 9).astype(np.uint8),
               np.concatenate([rng.choice(STD, size=7), q, rng.choice(STD, size=5)]).astype(np.uint8)]
    want, d, _ = _check(monkeypatch, q, targets)
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0
    assert want[4].score > 0


@pytest.mark.parametrize("qlen, gap", [(64, 9), (64, 36), (120, 30), (160, 88), (333, 25),
                                       (1000, 200)])
def test_vertical_gaps_across_the_segment_wrap(monkeypatch, qlen, gap):
    """A homolog missing ``gap`` query residues, more than a segment's rows:
    the walk's F run crosses lanes, where F is carried across the wrap (over
    eight lanes and more at 64 and 160 residues)."""
    assert gap > _seg_len(qlen)
    rng = np.random.default_rng(qlen + gap)
    q = rng.choice(STD, size=qlen).astype(np.uint8)
    a = (qlen - gap) // 2
    homolog = np.concatenate([q[:a], q[a + gap:]])
    sub = rng.random(homolog.size) < 0.1
    homolog[sub] = rng.choice(STD, size=int(sub.sum()))
    want, d, _ = _check(monkeypatch, q, [homolog.astype(np.uint8)])
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0
    assert max(_runs(want[0].moves, MOVE_UP)) > _seg_len(qlen)


@pytest.mark.parametrize("gaps", [(10, 1), (1, 1)], ids=["10-1", "1-1"])
def test_vertical_gap_met_at_once_by_a_horizontal_one(monkeypatch, gaps):
    """20 query residues of W deleted where 8 of D are inserted: W against D
    scores -4, so the path leaves the run of UP moves straight into LEFT
    moves, the corner where the E tests need E from the final H."""
    scorer, jax_scorer = create_scorer("BLOSUM_62", *gaps), jax_create_scorer("BLOSUM_62", *gaps)
    rng = np.random.default_rng(sum(gaps))
    q = rng.choice(STD, size=120).astype(np.uint8)
    q[50:70] = _code("W")
    targets = [np.concatenate([q[:50], np.full(8, _code("D"), np.uint8), q[70:]]),
               np.concatenate([q[:40], np.full(30, _code("D"), np.uint8), q[50:]])]
    monkeypatch.delenv("SIFT4G_TPU_NO_SIMD", raising=False)
    m = PhaseMetrics(enabled=False)
    got = align_pairs_batch(q, targets, scorer, "SW", threads=2, metrics=m)
    assert m.phases["align.traceback.native"]["scalar_cells"] == 0
    monkeypatch.setenv("SIFT4G_TPU_NO_SIMD", "1")
    want = align_pairs_batch(q, targets, scorer, "SW", threads=2)
    monkeypatch.delenv("SIFT4G_TPU_NO_SIMD")
    _assert_same(got, jax_align_pairs_batch(q, targets, jax_scorer, "SW", threads=2))
    _assert_same(got, want)
    moves = want[0].moves.tolist()
    assert any((moves[k], moves[k + 1]) == (MOVE_UP, MOVE_LEFT) for k in range(len(moves) - 1))


@pytest.mark.parametrize("case", ["target-repeats", "query-repeats", "both", "tie-heavy"])
def test_tied_best_cells_take_the_first_in_row_major_order(monkeypatch, case):
    """Repeats put the best score in several cells: in one row (a motif
    against three copies of it), in one column (three copies against the
    motif), in both (two copies against two, 400 residues apart in the
    target, so that no alignment spans them), or anywhere (a three-letter
    alphabet); the endpoint is the first of them row by row."""
    rng = np.random.default_rng(len(case))
    motif = rng.choice(STD, size=37).astype(np.uint8)
    spacer = rng.choice(STD, size=11).astype(np.uint8)
    thrice = np.concatenate([motif, spacer, motif, spacer, motif])
    if case == "tie-heavy":
        q = rng.integers(0, 3, 90).astype(np.uint8)
        targets = [rng.integers(0, 3, 70).astype(np.uint8) for _ in range(4)]
    elif case == "both":
        q = np.concatenate([motif, spacer, motif])
        targets = [np.concatenate([motif, rng.choice(STD, size=400), motif]).astype(np.uint8)]
    else:
        q, t = (motif, thrice) if case == "target-repeats" else (thrice, motif)
        targets = [t.copy(), np.concatenate([spacer, t])]
    want, d, _ = _check(monkeypatch, q, targets)
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0
    if case in ("target-repeats", "query-repeats"):
        # the motif against itself, in every copy alike: the first copy
        r = want[0]
        assert (r.query_start, r.query_end, r.target_start, r.target_end) == \
            (0, motif.size - 1, 0, motif.size - 1)


@pytest.mark.parametrize("q, t", [("W", "G"), ("W" * 50, "D" * 70), ("WWW", "P")],
                         ids=["1x1", "50x70", "3x1"])
def test_a_pair_with_no_positive_cell(monkeypatch, q, t):
    """W against D, G or P scores below 0 everywhere: no cell is positive,
    the score is 0 and the path is empty."""
    q = np.array([_code(c) for c in q], dtype=np.uint8)
    t = np.array([_code(c) for c in t], dtype=np.uint8)
    want, d, _ = _check(monkeypatch, q, [t])
    assert d["scalar_cells"] == 0 and d["saturated_pairs"] == 0
    assert want[0].score == 0 and want[0].moves.size == 0

"""The port's plain PyTorch scorer (align/scan.py) against the JAX package.

The twin must equal the Pallas kernel it stands beside (run in interpret
mode, as tests/test_pallas_grouped.py runs it), the XLA scan and the NumPy
oracle.  Tolerance: exact int32 equality, the repo's invariant for every
scoring backend (CLAUDE.md "Invariants to preserve")."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.experimental.pallas import tpu as pltpu

from sift4g_tpu.align.dp_numpy import score_pair
from sift4g_tpu.align.xla import (
    _extend_matrix,
    align_scores_grouped as xla_grouped,
    screen_topk_words as xla_screen,
)
from sift4g_tpu.core.scorers import create_scorer
from sift4g_tpu_torch.align import scan, sw_grouped

# the suite runs several worker processes at once: torch's OpenMP threads
# on top of them oversubscribe the cores and slow every test many times
torch.set_num_threads(1)

MODES = ["SW", "NW", "HW", "OV"]


def _case(seed, G=4, B=12, N=128, qlens=(51, 17, 0, 64), zero_rows=True):
    """Ragged grouped inputs: odd and even query lengths, a zero-length
    group, zero-length rows and random int8 garbage past every length."""
    rng = np.random.default_rng(seed)
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 5, scan.PAD_CODE, dtype=np.int32)
    for g in range(G):
        q_all[offs[g] : offs[g] + qlens[g]] = rng.integers(0, 26, qlens[g])
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(1, N + 1, size=(G, B)).astype(np.int32)
    if zero_rows:
        lens[:, -1] = 0
    lens[0, 0] = N
    lens[0, 1] = 1
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return q_all, offs, qlens, targets, lens


def _twin(q_all, offs, qlens, targets, lens, m32, mode, go=10, ge=1):
    out = sw_grouped.sw_scores_grouped(
        torch.from_numpy(q_all), torch.from_numpy(offs), torch.from_numpy(qlens),
        torch.from_numpy(targets), torch.from_numpy(lens), torch.from_numpy(m32),
        mode=mode, gap_open=go, gap_extend=ge,
    )
    assert out.dtype == torch.int32 and out.shape == lens.shape
    return out.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_pallas_grouped_interpret(mode):
    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped

    args = _case(3)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = _extend_matrix(scorer.matrix)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sw_scores_pallas_grouped(*args, m32, mode=mode, unroll=1))
    np.testing.assert_array_equal(_twin(*args, m32, mode), ref)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gaps", [(10, 1), (5, 2)])
def test_twin_matches_xla_and_numpy(mode, gaps):
    go, ge = gaps
    q_all, offs, qlens, targets, lens = _case(7 + go)
    scorer = create_scorer("BLOSUM_45", go, ge)
    m32 = _extend_matrix(scorer.matrix)
    got = _twin(q_all, offs, qlens, targets, lens, m32, mode, go, ge)
    ref = np.asarray(xla_grouped(
        q_all, offs, qlens, targets.astype(np.int32), lens, m32,
        mode=mode, gap_open=go, gap_extend=ge,
    ))
    # the XLA scan scores an empty target H[qlen, 0] under NW/HW where the
    # Pallas kernel (and the twin) give NEG; every other cell must agree
    has = lens > 0
    np.testing.assert_array_equal(got[has], ref[has])
    if mode in ("NW", "HW"):
        assert (got[~has] == scan.NEG).all()
    else:
        np.testing.assert_array_equal(got[~has], ref[~has])
    for g in (0, 1):
        q = q_all[offs[g] : offs[g] + qlens[g]].astype(np.uint8)
        for b in range(4):
            t = targets[g, b, : lens[g, b]].astype(np.uint8)
            assert got[g, b] == score_pair(q, t, scorer, mode), (g, b)


@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_pallas_long_interpret(mode):
    """The long-target route (K2) is served by the grouped scorer in the
    port; hold the twin to K2 at tests/test_pallas_long.py's shapes."""
    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped_long

    rng = np.random.default_rng(29)
    G, B, N, n_chunk, m_pad = 2, 8, 512, 128, 64
    qlens = np.array([49, 33], dtype=np.int32)
    q_all = np.full(G * m_pad, scan.PAD_CODE, dtype=np.int32)
    offs = (np.arange(G) * m_pad).astype(np.int32)
    for g in range(G):
        q_all[g * m_pad : g * m_pad + qlens[g]] = rng.integers(0, 26, qlens[g])
    targets = np.full((G, B, N), scan.PAD_CODE, dtype=np.int8)
    lens = rng.integers(1, N + 1, size=(G, B)).astype(np.int32)
    lens[0, 0], lens[0, 1], lens[0, 2] = N, n_chunk, 1
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    m32 = _extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sw_scores_pallas_grouped_long(
            q_all, offs, qlens, targets, lens, m32,
            mode=mode, n_chunk=n_chunk, m_cap=m_pad,
        ))
    np.testing.assert_array_equal(_twin(q_all, offs, qlens, targets, lens, m32, mode), ref)


def test_align_scores_single_query():
    q_all, offs, qlens, targets, lens = _case(5)
    m32 = _extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix)
    grouped = _twin(q_all, offs, qlens, targets, lens, m32, "SW")
    one = scan.align_scores(
        torch.from_numpy(q_all[offs[1] :]), int(qlens[1]),
        torch.from_numpy(targets[1]), torch.from_numpy(lens[1]),
        torch.from_numpy(m32),
    )
    np.testing.assert_array_equal(one.numpy(), grouped[1])


def _brute_topk(scores, smin, k):
    surv = [(int(s), r) for r, s in enumerate(scores) if s >= smin]
    surv.sort(key=lambda t: (-t[0], t[1]))
    return surv[:k]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_screen_words_match_jax(seed):
    rng = np.random.default_rng(seed)
    G, B, k = 5, 64, 7
    scores = rng.integers(-50, 300, (G, B)).astype(np.int32)
    scores[0, :] = 100           # ties across the k boundary
    scores[1, ::2] = 55
    smin = np.array([60, 55, 1, 200, 1000], dtype=np.int32)
    got = scan.screen_topk_words(torch.from_numpy(scores), torch.from_numpy(smin), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(xla_screen(scores, smin, k)))
    for g in range(G):
        rows, sc = scan.decode_screen_words(got[g], B)
        assert list(zip(sc.tolist(), rows.tolist())) == _brute_topk(scores[g], smin[g], k)


def test_screen_rejects_wide_batch():
    with pytest.raises(ValueError, match="row field"):
        scan.screen_topk_words(
            torch.zeros((1, 4097), dtype=torch.int32), torch.ones(1, dtype=torch.int32), 3
        )


@pytest.mark.parametrize("name", ["BLOSUM_62", "BLOSUM_250"])
def test_matrix32_matches_extend_matrix(name):
    scorer = create_scorer(name, 10, 1)
    got = scan.matrix32_from_scorer(scorer, torch.device("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _extend_matrix(scorer.matrix))


def test_matrix32_refuses_out_of_int8_range():
    scorer = create_scorer("BLOSUM_62", 10, 1)
    big = scorer.__class__(
        name="BIG", matrix=scorer.matrix * 20, gap_open=10, gap_extend=1
    )
    with pytest.raises(ValueError, match="int8"):
        scan.matrix32_from_scorer(big, torch.device("cpu"))


def test_wrapper_uses_twin_on_cpu_only():
    """CPU tensors run the twin without touching the kernel counters; a
    device the scorer does not support is refused."""
    sw_grouped.reset_counters()
    args = _case(1)
    m32 = _extend_matrix(create_scorer("BLOSUM_62", 10, 1).matrix)
    _twin(*args, m32, "SW")
    assert sw_grouped.kernel_launches == 0 and sw_grouped.twin_calls_on_cuda == 0
    meta = torch.zeros((1, 1, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sw_grouped.sw_scores_grouped(
            meta, meta, meta, meta, meta, meta,
        )


"""K2, the long-target scorer (``sw_scores_grouped_long``), on the CPU.

* The wrapper's CPU dispatch (the plain version) against the JAX
  package's column-chunked Pallas kernel in interpret mode.
* A transcription of the CUDA kernel's block schedule
  (``csrc/sw_grouped_long.cu``: strips over warps, strips in turn over
  row tiles, the rings between warps with their waits, the corner H),
  at narrow strips so that several strips, tiles and ring wraps happen
  at small N, held to serial Gotoh and to the port's ``dp_numpy``.
* The aligner's route: a launch at a rung of ``LONG_RUNG`` or more goes
  to K2, resident database or not, unless it holds more cells than K1's
  longest chain is worth; scores and pipeline files equal the JAX
  package's.
* The wrapper's argument checks.

Tolerance: exact integer equality throughout."""

import filecmp
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.experimental.pallas import tpu as pltpu

from sift4g_tpu.align.batch import BatchAligner as JaxAligner
from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped_long
from sift4g_tpu.core.scorers import create_scorer as jax_create_scorer
from sift4g_tpu_torch.align import dp_numpy, resident as tres, scan, sw_grouped
from sift4g_tpu_torch.align.batch import LONG_RUNG, BatchAligner
from sift4g_tpu_torch.core.scorers import create_scorer

# the suite runs several worker processes at once: torch's OpenMP threads
# on top of them oversubscribe the cores and slow every test many times
torch.set_num_threads(1)

MODES = ("SW", "NW", "HW", "OV")
NEG = scan.NEG


def _matrix(rng, lo=-4, hi=12):
    m = rng.integers(lo, hi, (26, 26))
    m32 = np.full((32, 32), NEG, np.int32)
    m32[:26, :26] = np.triu(m) + np.triu(m, 1).T
    return m32


def _slab(rng, G, B, N, lens, qlens, m_pad):
    """(q_all, q_off, q_len, targets, lens): int8 garbage past every length."""
    q_all = np.full(G * m_pad, scan.PAD_CODE, np.int32)
    for g in range(G):
        q_all[g * m_pad : g * m_pad + qlens[g]] = rng.integers(0, 26, qlens[g])
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = np.asarray(lens, np.int32).reshape(G, B)
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return (q_all, (np.arange(G) * m_pad).astype(np.int32), np.asarray(qlens, np.int32),
            targets, lens)


def _k2(args, m32, mode, go, ge, **kw):
    t = [torch.from_numpy(a) for a in (*args, m32)]
    return sw_grouped.sw_scores_grouped_long(*t, mode=mode, gap_open=go, gap_extend=ge,
                                             **kw).numpy()


# ----------------------------------------------- (a) the plain dispatch vs Pallas


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("gaps", [(10, 1), (11, 2)], ids=["10-1", "11-2"])
def test_cpu_dispatch_matches_pallas_long_interpret(mode, gaps):
    """Ragged lengths with 0, 1, n_chunk and N among them, two groups of
    different query lengths, garbage past every length."""
    go, ge = gaps
    rng = np.random.default_rng(40 + go)
    G, B, N, n_chunk, m_pad = 2, 8, 32, 16, 24
    lens = rng.integers(1, N + 1, (G, B))
    lens[0, :4] = (0, 1, n_chunk, N)
    lens[1, :2] = (n_chunk + 1, N - 1)
    args = _slab(rng, G, B, N, lens, (21, 9), m_pad)
    m32 = _matrix(rng)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sw_scores_pallas_grouped_long(
            *args, m32, mode=mode, gap_open=go, gap_extend=ge, n_chunk=n_chunk, m_cap=m_pad))
    got = _k2(args, m32, mode, go, ge, n_chunk=n_chunk, m_cap=m_pad)
    assert sw_grouped.long_launches == 0    # the CPU runs the plain version only
    np.testing.assert_array_equal(got, want)


# ------------------------------------------ (b) the kernel's schedule, transcribed


def _gotoh(q, t, m32, mode, go, ge):
    """Serial Gotoh, cell by cell, with the kernels' edge conventions (the
    matrix clamped to int8; an empty target scores NEG under NW/HW)."""
    m, n = len(q), len(t)
    if n == 0:
        return NEG if mode in ("NW", "HW") else 0
    free_top, free_left = mode != "NW", mode in ("SW", "OV")
    H = [[0] * (n + 1) for _ in range(m + 1)]
    for j in range(1, n + 1):
        H[0][j] = 0 if free_top else -(go + (j - 1) * ge)
    F = [NEG] * (n + 1)
    best, last_col = 0, []
    for i in range(1, m + 1):
        H[i][0] = 0 if free_left else -(go + (i - 1) * ge)
        e = H[i][0] - go
        for j in range(1, n + 1):
            s = int(np.clip(m32[q[i - 1]][t[j - 1]], -128, 127))
            F[j] = max(H[i - 1][j] - go, F[j] - ge)
            g = max(H[i - 1][j - 1] + s, F[j])
            if mode == "SW":
                g = max(g, 0)
            H[i][j] = max(g, e)
            e = max(e - ge, g - go)
            best = max(best, H[i][j])
        last_col.append(H[i][n])
    if mode == "SW":
        return best
    if mode == "NW":
        return H[m][n]
    row = max(H[m][1:])
    return row if mode == "HW" else max(row, max(last_col, default=NEG), 0)


def _shfl_up(v):
    """__shfl_up_sync(v, 1): lane t takes lane t - 1's value, lane 0 its own."""
    return np.concatenate((v[:1], v[:-1]))


def _long_model(q, t, tlen, m32, mode, go, ge, *, lanes, cols, warps, ring, row_tile,
                publish=4, release=8, corner_shift=0):
    """The score of the query ``q`` against ``t[:tlen]`` (``t`` the
    target's slab row, N = len(t)) as one block of the CUDA kernel
    computes it: ``warps`` warps of ``lanes`` lanes, ``cols`` columns a
    lane (strips of W = lanes x cols columns; the kernel runs 32 and 16),
    rings of ``ring`` rows between warps and of 2 x ``row_tile`` rows into
    warp 0 (the kernel's 64 and 1024), a producer publishing its row count
    every ``publish`` rows and a consumer its count every ``release`` rows
    (and both at a strip's last row; the kernel's 4 and 8: deadlock-free
    while ``ring >= publish + release - 1``).  Each warp is a generator that
    yields before each of its steps and at every wait of the kernel (a
    predicate on the rings' row counts); a scheduler advances every warp
    whose wait holds, one yield a tick, and fails on a tick where none
    can move (a deadlock).  ``corner_shift`` takes the corner H from a row
    that many rows too early (a deliberate fault)."""
    N, W, M = len(t), lanes * cols, len(q)
    L = min(max(tlen, 0), N)
    free_top, free_left = mode != "NW", mode in ("SW", "OV")
    if L == 0 or M == 0:
        if mode == "NW":
            return -(go + (L - 1) * ge) if L > 0 else NEG
        if mode == "HW":
            return 0 if L > 0 else NEG
        return 0
    m8 = np.clip(m32.astype(np.int64), -128, 127)
    strips_max = -(-N // W)
    wide = strips_max > warps
    S = -(-L // W)
    tile = row_tile if S > warps else M
    R = -(-M // tile)
    caps = [2 * row_tile if wide else 0] + [ring] * (warps - 1)
    bufs = [[None] * c for c in caps]
    prod, cons = [0] * warps, [0] * warps
    scratch, corners, result = {}, {}, {}
    lane = np.arange(lanes)
    k_idx = np.arange(cols)

    def warp_prog(w):
        nxt = (w + 1) % warps
        cseq = pseq = 0
        best, acc = 0, NEG
        for r in range(R):
            r0, rows = r * tile, min(tile, M - r * tile)
            for s in range(w, S, warps):
                left, right = s > 0, s + 1 < S
                col = s * W + lane[:, None] * cols + k_idx[None, :]        # (lanes, cols)
                # the profile: column codes' low five bits, -128 past the target
                codes = t[np.minimum(col, N - 1)].astype(np.int64) & 31
                prof = np.where(col[None] < L, m8[:, codes], -128)        # (32, lanes, cols)
                kl = np.where((L - 1 >= col[:, 0]) & (L - 1 < col[:, 0] + cols),
                              L - 1 - col[:, 0], -1)
                if r == 0:
                    h = np.zeros((lanes, cols), np.int64) if free_top else -(go + col * ge)
                    f = np.full((lanes, cols), NEG, np.int64)
                else:
                    h, f = (x.copy() for x in scratch[s])
                corner = [0]

                def left_edge(i):
                    nonlocal cseq
                    if not left:
                        b0 = 0 if free_left else -(go + (r0 + i) * ge)
                        return b0 - go, b0
                    n = cseq + i
                    yield lambda: prod[w] >= n + 1
                    e_in, h_in = bufs[w][n % caps[w]]
                    if (i + 1) % release == 0 or i == rows - 1:
                        cons[w] = n + 1
                    if i == rows - 1 - corner_shift:
                        corner[0] = h_in
                    return e_in, h_in

                diag = np.zeros(lanes, np.int64)
                if not left:
                    diag[0] = 0 if (r0 == 0 or free_left) else -(go + (r0 - 1) * ge)
                elif r0 == 0:
                    diag[0] = 0 if free_top else -(go + (col[0, 0] - 1) * ge)
                else:
                    diag[0] = corners[s]
                e = np.zeros(lanes, np.int64)
                hl = _shfl_up(h[:, -1].copy())
                e[0], hl[0] = yield from left_edge(0)
                for st in range(rows + lanes - 1):
                    yield None
                    # lane 0's next left edge, fetched before the cells
                    if st + 1 < rows:
                        e0, h0 = yield from left_edge(st + 1)
                    i = st - lane
                    act = (i >= 0) & (i < rows)
                    if right and act[-1]:
                        n = pseq + i[-1]
                        yield lambda n=n: n - cons[nxt] < caps[nxt]
                    qc = q[r0 + np.clip(i, 0, rows - 1)] & 31
                    d, ee, gl = diag.copy(), e.copy(), np.zeros(lanes, np.int64)
                    for k in range(cols):
                        if k > 0:
                            ee = np.maximum(ee - ge, gl - go)
                        sc = prof[qc, lane, k]
                        fk = np.maximum(h[:, k] - go, f[:, k] - ge)
                        g = np.maximum(d + sc, fk)
                        if mode == "SW":
                            g = np.maximum(g, 0)
                        hk = np.maximum(g, ee)
                        d = h[:, k].copy()
                        h[:, k] = np.where(act, hk, h[:, k])
                        f[:, k] = np.where(act, fk, f[:, k])
                        gl = g
                        if mode == "SW" and act.any():
                            best = max(best, int(hk[act].max()))
                    eo = np.where(act, np.maximum(ee - ge, gl - go), 0)
                    if mode == "OV":
                        for ln in np.flatnonzero(act & (kl >= 0)):
                            acc = max(acc, int(h[ln, kl[ln]]))
                    if right and act[-1]:
                        bufs[nxt][n % caps[nxt]] = (int(eo[-1]), int(h[-1, -1]))
                        if (i[-1] + 1) % publish == 0 or i[-1] == rows - 1:
                            prod[nxt] = n + 1
                    diag = hl.copy()
                    e = _shfl_up(eo)
                    hl = _shfl_up(h[:, -1].copy())
                    if st + 1 < rows:
                        e[0], hl[0] = e0, h0
                if left:
                    cseq += rows
                if right:
                    pseq += rows
                if r < R - 1:
                    scratch[s] = (h.copy(), f.copy())
                    if left:
                        corners[s] = corner[0]
                elif mode == "NW":
                    for ln in np.flatnonzero(kl >= 0):
                        result["NW"] = int(h[ln, kl[ln]])
                elif mode in ("HW", "OV"):
                    acc = max(acc, int(np.where(col < L, h, NEG).max()))
        result[w] = best if mode == "SW" else acc

    progs = [warp_prog(w) for w in range(warps)]
    waits = [None] * warps
    live = set(range(warps))
    while live:
        moved = False
        for w in sorted(live):
            if waits[w] is not None and not waits[w]():
                continue
            try:
                waits[w] = next(progs[w])
            except StopIteration:
                live.discard(w)
            moved = True
        if not moved:
            raise RuntimeError("deadlock: every warp waits")
    if mode == "NW":
        return result["NW"]
    v = max(result[w] for w in range(warps))
    return max(v, 0) if mode == "OV" else v


# (N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lengths):
# strips that fit the block (one tile) and strips in turn (tiles, the wrap
# ring), a last strip cut by N, rings at their smallest deadlock-free size,
# counts published every row and in batches, lengths on lane, strip and N
# edges
SCHEDULE_CASES = [
    (64, 4, 2, 8, 3, 2, 2, 5, 13, (64, 1, 0, 7, 8, 9, 33, 57)),
    (64, 4, 2, 3, 4, 2, 3, 5, 13, (64, 63, 8, 16, 17, 24, 25, 41)),
    (60, 4, 2, 2, 1, 1, 1, 4, 11, (60, 59, 2, 9, 31, 32, 47, 48)),
    (48, 4, 2, 1, 2, 1, 2, 3, 10, (48, 17, 1, 8, 24, 40, 0, 39)),
    (40, 2, 4, 4, 2, 2, 1, 6, 1, (40, 3, 8, 9, 16, 17, 25, 39)),
    (56, 4, 2, 3, 11, 4, 8, 7, 32, (56, 15, 16, 23, 24, 49, 50, 8)),
]


def _schedule_inputs(case, seed):
    N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lens = case
    rng = np.random.default_rng(seed)
    m32 = _matrix(rng)
    q = rng.integers(0, 26, qlen)
    t = rng.integers(-128, 128, (len(lens), N)).astype(np.int8)
    for b, ln in enumerate(lens):
        t[b, :ln] = rng.integers(0, 26, ln)
    return q, t, lens, m32


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", SCHEDULE_CASES,
                         ids=[f"N{c[0]}-W{c[1] * c[2]}-w{c[3]}-ring{c[4]}-tile{c[7]}"
                              for c in SCHEDULE_CASES])
def test_schedule_transcription_matches_serial_gotoh(mode, case):
    N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lens = case
    q, t, lens, m32 = _schedule_inputs(case, SCHEDULE_CASES.index(case))
    gaps = (11, 2) if SCHEDULE_CASES.index(case) % 2 else (10, 1)
    scorer = SimpleNamespace(matrix=np.clip(m32[:26, :26], -128, 127), gap_open=gaps[0],
                             gap_extend=gaps[1])
    for b, ln in enumerate(lens):
        got = _long_model(q, t[b], ln, m32, mode, *gaps, lanes=lanes, cols=cols,
                          warps=warps, ring=ring, row_tile=row_tile, publish=publish,
                          release=release)
        tb = t[b, :ln].astype(np.int64)
        assert got == _gotoh(q, tb, m32, mode, *gaps), (b, ln)
        if ln and mode != "HW":   # dp_numpy's HW row includes the boundary column
            assert got == dp_numpy.score_pair(q, tb, scorer, mode), (b, ln)


def test_schedule_transcription_matches_plain_and_pallas():
    """The transcription at strips in turn, the plain version and the
    Pallas kernel on one launch's targets, gaps with go < ge."""
    N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lens = SCHEDULE_CASES[1]
    q, t, lens, m32 = _schedule_inputs(SCHEDULE_CASES[1], 99)
    args = (q.astype(np.int32), np.zeros(1, np.int32), np.array([qlen], np.int32), t[None],
            np.asarray(lens, np.int32)[None])
    for mode in MODES:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(sw_scores_pallas_grouped_long(
                *args, m32, mode=mode, gap_open=1, gap_extend=3, n_chunk=32, m_cap=qlen))[0]
        plain = _k2(args, m32, mode, 1, 3, n_chunk=32, m_cap=qlen)[0]
        got = [_long_model(q, t[b], ln, m32, mode, 1, 3, lanes=lanes, cols=cols, warps=warps,
                           ring=ring, row_tile=row_tile, publish=publish, release=release)
               for b, ln in enumerate(lens)]
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(got, want)


def test_schedule_transcription_fails_with_the_corner_of_the_wrong_row():
    """The corner H (above-left of a strip's first column on a tile's first
    row) is the left strip's H of the tile's last row; one row earlier
    changes these scores, so the cases above hold it."""
    N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lens = SCHEDULE_CASES[1]
    q, t, lens, m32 = _schedule_inputs(SCHEDULE_CASES[1], 1)
    wrong = 0
    for mode in MODES:
        for b, ln in enumerate(lens):
            kw = dict(lanes=lanes, cols=cols, warps=warps, ring=ring, row_tile=row_tile,
                      publish=publish, release=release)
            want = _gotoh(q, t[b, :ln].astype(np.int64), m32, mode, 10, 1)
            assert _long_model(q, t[b], ln, m32, mode, 10, 1, **kw) == want
            wrong += _long_model(q, t[b], ln, m32, mode, 10, 1, corner_shift=1, **kw) != want
    assert wrong > 0


@pytest.mark.parametrize("G,B,N,warps,want", [
    (1, 256, 8192, None, (16, 16, 256)), (1, 32, 35008, None, (69, 16, 32)),
    (1, 4096, 3072, None, (6, 6, 4096)), (2, 3, 100, None, (1, 1, 6)),
    (1, 32, 35008, 3, (69, 3, 32)), (2, 3, 100, 16, (1, 16, 6)),
])
def test_long_geometry(G, B, N, warps, want):
    """One warp a strip of 512 columns, at most 16; more strips than
    warps run in turn; one block a target."""
    assert sw_grouped.long_geometry(G, B, N, warps) == want


# ---------------------------------------------------- (c) the aligner's route


SCORER = create_scorer("BLOSUM_62", 10, 1)
JAX_SCORER = jax_create_scorer("BLOSUM_62", 10, 1)


def _spy_scorers(monkeypatch):
    """Record the rung of every K1, K2 and K3 call the aligner makes."""
    calls = {"K1": [], "K2": [], "K3": []}
    for name, key, width in (("sw_scores_grouped", "K1", lambda a: a[3].shape[2]),
                             ("sw_scores_grouped_long", "K2", lambda a: a[3].shape[2]),
                             ("sw_scores_grouped_resident", "K3", lambda a: a[7])):
        real = getattr(sw_grouped, name)

        def spy(*a, _real=real, _key=key, _width=width, **k):
            calls[_key].append(int(_width(a)))
            return _real(*a, **k)

        monkeypatch.setattr(sw_grouped, name, spy)
    return calls


def _long_items(rng):
    """Three queries; targets across the rungs, five of them past 2,048
    residues (rungs 3,072 and 4,096)."""
    items = []
    for qlen, lens in ((60, (2500, 3100, 140, 700)), (33, (2049, 90)), (45, (3072, 3073, 400))):
        q = rng.integers(0, 26, qlen).astype(np.uint8)
        items.append((q, [rng.integers(0, 26, n).astype(np.uint8) for n in lens]))
    return items


@pytest.mark.parametrize("mode", ["SW", "OV"])
def test_aligner_sends_long_rungs_to_k2(mode, monkeypatch):
    rng = np.random.default_rng(5)
    items = _long_items(rng)
    calls = _spy_scorers(monkeypatch)
    al = BatchAligner(SCORER, mode=mode, backend="torch", b_cap=8, tail_coalesce=False)
    got = al.scores_many(items)
    assert calls["K2"] and all(n >= LONG_RUNG for n in calls["K2"])
    assert calls["K1"] and all(n < LONG_RUNG for n in calls["K1"])
    assert len(calls["K1"]) + len(calls["K2"]) == al.launches
    want = JaxAligner(JAX_SCORER, mode=mode, backend="numpy").scores_many(items)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_split_launches_run_k2_only_at_long_rungs(monkeypatch):
    """One query over two devices: every launch is split on the batch axis
    (``make_grouped_long_sharded``), K2 scoring its shares at rungs of
    ``LONG_RUNG`` or more and K1 below, as on one device."""
    rng = np.random.default_rng(4)
    items = _long_items(rng)[:1]
    calls = _spy_scorers(monkeypatch)
    cpu = torch.device("cpu")
    al = BatchAligner(SCORER, backend="torch", b_cap=8, tail_coalesce=False,
                      devices=[cpu, cpu])
    got = al.scores_many(items)
    assert calls["K2"] and all(n >= LONG_RUNG for n in calls["K2"])
    assert calls["K1"] and all(n < LONG_RUNG for n in calls["K1"])
    assert len(calls["K1"]) + len(calls["K2"]) == 2 * al.launches
    want = JaxAligner(JAX_SCORER, backend="numpy").scores_many(items)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("qlen,n_targets,tlen,k2", [
    (360, 64, 3072, True), (360, 256, 3072, True), (360, 1024, 3072, False),
    (360, 4096, 3072, False), (360, 256, 8192, True), (360, 1024, 8192, False),
    (1500, 256, 8192, True), (100, 2048, 4096, True),
])
def test_long_route_weighs_cells_against_k1s_chain(qlen, n_targets, tlen, k2):
    """K2 while a launch's cells stay under ``LONG_CELLS_PER_COLUMN`` a
    column and pass of K1's longest chain: one query against full targets,
    on both sides of the crossover that phase 3b of ``chip_smoke.py``
    measured at 360 rows (K2 won at 64 and 256 targets, K1 at 1,024 and
    4,096, at every rung from 3,072 to 8,192)."""
    from sift4g_tpu_torch.align.batch import _long_route

    assert _long_route([(qlen, np.full(n_targets, tlen))]) is k2


def test_aligner_sends_a_wide_long_launch_to_k1(monkeypatch):
    """One query with 1,000 candidates at the 3,072 rung: a launch with
    more cells than K1's chain is worth runs K1, not K2 (the scorers are
    stubs here: the route is under test, not the scores)."""
    calls = {"K1": [], "K2": []}
    for name, key in (("sw_scores_grouped", "K1"), ("sw_scores_grouped_long", "K2")):
        def stub(*a, _key=key, **k):
            calls[_key].append(a[3].shape[2])
            return torch.zeros(a[4].shape, dtype=torch.int32)

        monkeypatch.setattr(sw_grouped, name, stub)
    q = np.zeros(360, np.uint8)
    wide = [(q, [np.zeros(2900, np.uint8)] * 1000)]
    BatchAligner(SCORER, backend="torch").scores_many(wide)
    assert calls == {"K1": [3072], "K2": []}
    BatchAligner(SCORER, backend="torch").scores_many([(q, wide[0][1][:200])])
    assert calls == {"K1": [3072], "K2": [3072]}


def test_aligner_packs_long_rungs_under_a_resident_database(monkeypatch):
    """With a resident database the long rungs still pack a slab for K2;
    the rest run K3; the screen keeps the JAX package's survivors."""
    rng = np.random.default_rng(6)
    items = _long_items(rng)
    seqs = [t for _, ts in items for t in ts]
    offsets = np.concatenate(([0], np.cumsum([len(t) for t in seqs]))).astype(np.int64)
    rdb = tres.ResidentDB(np.concatenate(seqs), offsets, "cpu")
    lens = np.diff(offsets).astype(np.int32)
    packed, pos = [], 0
    for q, ts in items:
        ids = np.arange(pos, pos + len(ts))
        packed.append((q, rdb.packed_targets(ids, lens[ids])))
        pos += len(ts)
    calls = _spy_scorers(monkeypatch)
    al = BatchAligner(SCORER, backend="torch", b_cap=8, resident=rdb, tail_coalesce=False)
    got = al.scores_many(packed)
    assert calls["K2"] and all(n >= LONG_RUNG for n in calls["K2"])
    assert calls["K3"] and all(n < LONG_RUNG for n in calls["K3"]) and not calls["K1"]
    ref = JaxAligner(JAX_SCORER, backend="numpy").scores_many(items)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)
    smins = [max(1, int(np.median(r))) for r in ref]
    k = 3
    screened = al.scores_many_async(packed, screen=(smins, k))()
    for g, r, s in zip(screened, ref, smins):
        keep = sorted(np.flatnonzero(r >= s).tolist(), key=lambda i: (-int(r[i]), i))[:k]
        np.testing.assert_array_equal(g[keep], r[keep])


def test_pipeline_with_long_targets_matches_jax(tmp_path, monkeypatch):
    """``run_pipeline`` on a database with long sequences (mutated copies
    of query segments inside random flanks, 2,100-3,200 residues): the
    port's files (its CPU scorers, K2's plain version on the long rungs)
    byte-identical to the JAX package's."""
    from sift4g_tpu.pipeline import PipelineConfig as JaxConfig
    from sift4g_tpu.pipeline import run_pipeline as jax_run_pipeline
    from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from sift4g_tpu_torch.synthetic import main as make_db

    monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(tmp_path / "cache"))
    d = tmp_path / "db"
    make_db([str(d), "--n-db", "40", "--n-q", "2", "--mean-len", "90", "--subst-per-query", "4",
             "--seed", "3"])
    rng = np.random.default_rng(8)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    queries = [line.strip() for line in open(d / "queries.fa") if not line.startswith(">")]
    with open(d / "db.fa", "a") as fh:
        for i in range(3):
            seg = np.array(list(queries[i % 2]))
            seg[rng.random(len(seg)) < 0.15] = rng.choice(letters)
            n = int(rng.integers(2100, 3200))
            flank = rng.choice(letters, n - len(seg))
            at = int(rng.integers(0, len(flank)))
            fh.write(f">LONG_{i}\n{''.join(flank[:at]) + ''.join(seg) + ''.join(flank[at:])}\n")
    calls = _spy_scorers(monkeypatch)
    outs = {}
    for name in ("jax", "torch"):
        outs[name] = tmp_path / name
        outs[name].mkdir()
        kw = dict(query_path=str(d / "queries.fa"), database_path=str(d / "db.fa"),
                  subst_path=str(d), out_path=str(outs[name]), log=open(os.devnull, "w"))
        if name == "jax":
            jax_run_pipeline(JaxConfig(align_backend="native", **kw))
        else:
            run_pipeline(PipelineConfig(align_backend="torch", overlap="off", **kw))
    assert calls["K2"] and all(n >= LONG_RUNG for n in calls["K2"])
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["torch"]))
    assert any(n.endswith(".SIFTprediction") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(outs["jax"], outs["torch"], names, shallow=False)
    assert not mismatch and not errors


def test_factories_score_with_k2(monkeypatch):
    """``make_grouped_long_sharded`` and ``make_grouped_sharded(scorer="long")``
    reach K2's wrapper (its plain version on CPU tensors);
    ``make_grouped_long_sharded(scorer="grouped")`` reaches K1's."""
    from sift4g_tpu_torch.parallel import sharded

    rng = np.random.default_rng(9)
    args = _slab(rng, 2, 4, 512, rng.integers(0, 513, (2, 4)), (30, 12), 32)
    m32 = _matrix(rng)
    calls = _spy_scorers(monkeypatch)
    want = _k2(args, m32, "SW", 10, 1, n_chunk=128, m_cap=32)
    t = [torch.from_numpy(a) for a in (*args, m32)]
    mesh = [torch.device("cpu")] * 2
    by_batch = sharded.make_grouped_long_sharded(mesh, n_chunk=128, m_cap=32)(*t)
    np.testing.assert_array_equal(sharded.to_host(by_batch, dim=1).numpy(), want)
    by_group = sharded.make_grouped_sharded(mesh, scorer="long")(*t)
    np.testing.assert_array_equal(sharded.to_host(by_group).numpy(), want)
    assert len(calls["K2"]) == 5 and not calls["K1"]
    by_k1 = sharded.make_grouped_long_sharded(mesh, scorer="grouped")(*t)
    np.testing.assert_array_equal(sharded.to_host(by_k1, dim=1).numpy(), want)
    assert len(calls["K2"]) == 5 and len(calls["K1"]) == 2
    with pytest.raises(ValueError):
        sharded.make_grouped_long_sharded(mesh, scorer="resident")


# ------------------------------------------------------ (d) argument checks


@pytest.mark.parametrize("bad", ["m_cap", "n_chunk", "mode", "warps"])
def test_wrapper_refuses_before_any_work(bad, monkeypatch):
    rng = np.random.default_rng(10)
    args = _slab(rng, 1, 2, 128, (128, 5), (40,), 48)
    m32 = _matrix(rng)

    def no_work(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(scan, "align_scores_grouped", no_work)
    kw = dict(mode="SW", n_chunk=64, m_cap=48)
    kw.update({"m_cap": dict(m_cap=39), "n_chunk": dict(n_chunk=96),
               "mode": dict(mode="XW"), "warps": dict(warps_per_target=17)}[bad])
    mode = kw.pop("mode")
    with pytest.raises(ValueError):
        _k2(args, m32, mode, 10, 1, **kw)


def test_wrapper_without_a_bound_checks_no_query_length():
    """``m_cap=None``, the port's callers: a query of any length runs."""
    rng = np.random.default_rng(12)
    args = _slab(rng, 1, 2, 128, (128, 5), (40,), 48)
    m32 = _matrix(rng)
    np.testing.assert_array_equal(_k2(args, m32, "SW", 10, 1, n_chunk=64, m_cap=None),
                                  _k2(args, m32, "SW", 10, 1, n_chunk=64, m_cap=48))

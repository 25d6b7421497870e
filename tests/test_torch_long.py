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
                publish=2, release=4, remote=(16, 16), cluster=1, corner_shift=0,
                edge_shift=0):
    """The score of the query ``q`` against ``t[:tlen]`` (``t`` the
    target's slab row, N = len(t)) as one cluster of the CUDA kernel
    computes it: ``cluster`` blocks of ``warps`` warps (P positions,
    position rank x warps + warp) of ``lanes`` lanes, ``cols`` columns a
    lane (strips of W = lanes x cols columns; the kernel runs 32 and 16).
    Rings of ``ring`` rows between positions and of two tiles of rows into
    position 0 (the kernel's 64 and 1024) live in the consumer's block,
    with its filled count; the freed count lives in the producer's block: a
    write into another block's ring or count stands for a store through
    distributed shared memory.  A producer publishes its row count every
    ``publish`` rows, a consumer its count every ``release`` rows (and both
    at a tile's last row; the kernel's 2 and 4), every ``remote`` =
    (publish, release) rows on a ring between two blocks (the kernel's 16
    and 16); deadlock-free while ``ring`` is at least publish + release - 1
    for both.  A row's query code is read two steps
    ahead and its scores one step ahead, as in the kernel.  Each warp is a
    generator that yields before each of its steps and at every wait of
    the kernel (a predicate on the counts: the rings' and the cluster
    barriers' at the start and the end, the block barrier before the
    block's maximum goes to rank 0); a scheduler advances every warp whose
    wait holds, one yield a tick, and fails on a tick where none can move
    (a deadlock).  Rank 0 takes the cluster's maximum after the last
    barrier.  Faults, for the tests that show the cases catch them:
    ``corner_shift`` takes the corner H from a row that many rows too
    early; ``edge_shift`` makes a warp whose producer is in another block
    read each row's edge from the row before."""
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
    P = cluster * warps
    strips_max = -(-N // W)
    wide = strips_max > P
    S = -(-L // W)
    tile = row_tile if S > P else M
    R = -(-M // tile)
    ring0 = 2 * row_tile if wide else ring
    smem = [dict(ring=[[None] * (ring0 if w == 0 else ring) for w in range(warps)],
                 filled=[0] * warps, freed=[0] * warps, red=[None] * warps,
                 cred=[None] * cluster) for _ in range(cluster)]
    scratch, corners, result = {}, {}, {}
    barrier = {"start": 0, "end": 0, "block": [0] * cluster}
    lane = np.arange(lanes)
    k_idx = np.arange(cols)

    def warp_prog(rank, w):
        pos = rank * warps + w
        p_rank, p_warp = (rank, w - 1) if w > 0 else ((rank - 1) % cluster, warps - 1)
        c_rank, c_warp = (rank, w + 1) if w + 1 < warps else ((rank + 1) % cluster, 0)
        me, dst = smem[rank], smem[c_rank]
        in_ring, out_ring = me["ring"][w], dst["ring"][c_warp]
        in_cap, out_cap = len(in_ring), len(out_ring)
        shifted = edge_shift and p_rank != rank
        pub = remote[0] if c_rank != rank else publish
        rel = remote[1] if p_rank != rank else release
        cseq = pseq = avail = room = 0
        best, acc = 0, NEG
        barrier["start"] += 1
        yield lambda: barrier["start"] == P
        for r in range(R):
            r0, rows = r * tile, min(tile, M - r * tile)
            for s in range(pos, S, P):
                left, right = s > 0, s + 1 < S
                col = s * W + lane[:, None] * cols + k_idx[None, :]        # (lanes, cols)
                # the profile: column codes' low five bits, -128 past the target
                tcodes = t[np.minimum(col, N - 1)].astype(np.int64) & 31
                prof = np.where(col[None] < L, m8[:, tcodes], -128)       # (32, lanes, cols)
                kl = np.where((L - 1 >= col[:, 0]) & (L - 1 < col[:, 0] + cols),
                              L - 1 - col[:, 0], -1)
                if r == 0:
                    h = np.zeros((lanes, cols), np.int64) if free_top else -(go + col * ge)
                    f = np.full((lanes, cols), NEG, np.int64)
                else:
                    h, f = (x.copy() for x in scratch[s])
                edge_h = {}

                def left_edge(i):
                    nonlocal avail
                    if not left:
                        b0 = 0 if free_left else -(go + (r0 + i) * ge)
                        return b0 - go, b0
                    n = cseq + i
                    if n >= avail:
                        yield lambda: me["filled"][w] >= n + 1
                        avail = me["filled"][w]
                    v = in_ring[n % in_cap]
                    if shifted:
                        v = in_ring[(n - 1) % in_cap] if i > 0 else v
                    if (i + 1) % rel == 0 or i == rows - 1:
                        smem[p_rank]["freed"][p_warp] = n + 1
                    edge_h[i] = v[1]
                    return v

                def code(i):
                    return q[r0 + np.clip(i, 0, rows - 1)] & 31

                diag = _shfl_up(h[:, -1].copy())
                hl, e = diag.copy(), np.zeros(lanes, np.int64)
                le = yield from left_edge(0)
                if not left:
                    diag[0] = 0 if (r0 == 0 or free_left) else -(go + (r0 - 1) * ge)
                elif r0 == 0:
                    diag[0] = 0 if free_top else -(go + (col[0, 0] - 1) * ge)
                else:
                    diag[0] = corners[s]
                e[0], hl[0] = le
                sw = prof[code(-lane), lane]
                qn = code(1 - lane)
                for st in range(rows + lanes - 1):
                    yield None
                    i = st - lane
                    if st + 1 < rows:
                        le = yield from left_edge(st + 1)
                    # the next row's scores, and the code of the row after it
                    sw_next = prof[qn, lane]
                    qn = code(i + 2)
                    act = (i >= 0) & (i < rows)
                    d, ee, gl = diag.copy(), e.copy(), np.zeros(lanes, np.int64)
                    for k in range(cols):
                        if k > 0:
                            ee = np.maximum(ee - ge, gl - go)
                        fk = np.maximum(h[:, k] - go, f[:, k] - ge)
                        g = np.maximum(d + sw[:, k], fk)
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
                    # the last lane's row st - (lanes - 1) to the next strip
                    io = st - (lanes - 1)
                    if right and 0 <= io < rows:
                        n = pseq + io
                        if n - room >= out_cap:
                            yield lambda n=n: me["freed"][w] >= n - out_cap + 1
                            room = me["freed"][w]
                        out_ring[n % out_cap] = (int(eo[-1]), int(h[-1, -1]))
                        if (io + 1) % pub == 0 or io == rows - 1:
                            dst["filled"][c_warp] = n + 1
                    diag = hl.copy()
                    e = _shfl_up(eo)
                    hl = _shfl_up(h[:, -1].copy())
                    if st + 1 < rows:
                        e[0], hl[0] = le
                    sw = sw_next
                if left:
                    cseq += rows
                if right:
                    pseq += rows
                if r < R - 1:
                    scratch[s] = (h.copy(), f.copy())
                    if left:
                        corners[s] = edge_h[rows - 1 - corner_shift]
                elif mode == "NW":
                    for ln in np.flatnonzero(kl >= 0):
                        result["out"] = int(h[ln, kl[ln]])
                elif mode in ("HW", "OV"):
                    acc = max(acc, int(np.where(col < L, h, NEG).max()))
        if mode != "NW":
            me["red"][w] = best if mode == "SW" else acc
            barrier["block"][rank] += 1
            yield lambda: barrier["block"][rank] == warps
            if w == 0:
                smem[0]["cred"][rank] = max(me["red"])
        barrier["end"] += 1
        yield lambda: barrier["end"] == P
        if mode != "NW" and rank == 0 and w == 0:
            v = max(smem[0]["cred"])
            result["out"] = max(v, 0) if mode == "OV" else v

    progs = [warp_prog(r, w) for r in range(cluster) for w in range(warps)]
    waits = [None] * len(progs)
    live = set(range(len(progs)))
    while live:
        moved = False
        for i in sorted(live):
            if waits[i] is not None and not waits[i]():
                continue
            try:
                waits[i] = next(progs[i])
            except StopIteration:
                live.discard(i)
            moved = True
        if not moved:
            raise RuntimeError("deadlock: every warp waits")
    return result["out"]


# (N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lengths,
# cluster, remote publish and release): strips that fit the cluster (one
# tile) and strips in turn (tiles, the wrap ring), a last strip cut by N,
# rings of one row and at their smallest deadlock-free size, counts
# published every row and in batches (other batches between blocks),
# clusters of one to four blocks (every ring between blocks at one warp a
# block, idle blocks past a short target), queries of 0, 1, odd and even
# lengths, target lengths on lane, strip and N edges
SCHEDULE_CASES = [
    (64, 4, 2, 8, 3, 2, 2, 5, 13, (64, 1, 0, 7, 8, 9, 33, 57), 1, (2, 2)),
    (64, 4, 2, 3, 4, 2, 3, 5, 13, (64, 63, 8, 16, 17, 24, 25, 41), 1, (2, 3)),
    (60, 4, 2, 2, 1, 1, 1, 4, 11, (60, 59, 2, 9, 31, 32, 47, 48), 1, (1, 1)),
    (48, 4, 2, 1, 2, 1, 2, 3, 10, (48, 17, 1, 8, 24, 40, 0, 39), 1, (1, 2)),
    (40, 2, 4, 4, 2, 2, 1, 6, 1, (40, 3, 8, 9, 16, 17, 25, 39), 1, (2, 1)),
    (56, 4, 2, 3, 11, 4, 8, 7, 32, (56, 15, 16, 23, 24, 49, 50, 8), 1, (4, 8)),
    (64, 4, 2, 2, 3, 2, 2, 6, 13, (64, 1, 0, 7, 8, 9, 33, 57), 2, (2, 2)),
    (64, 4, 2, 4, 1, 1, 1, 4, 14, (64, 63, 8, 16, 17, 24, 25, 41), 4, (1, 1)),
    (60, 4, 2, 1, 5, 1, 1, 4, 11, (60, 59, 2, 9, 31, 32, 47, 48), 3, (2, 4)),
    (48, 4, 2, 2, 2, 1, 2, 4, 1, (48, 17, 1, 8, 24, 40, 0, 39), 2, (2, 1)),
    (40, 2, 4, 3, 2, 2, 1, 6, 0, (40, 3, 8, 9, 16, 17, 25, 39), 2, (1, 2)),
    (56, 4, 2, 3, 11, 4, 8, 8, 32, (56, 15, 16, 23, 24, 49, 50, 8), 4, (8, 4)),
    (72, 4, 2, 1, 12, 2, 1, 5, 23, (72, 71, 65, 64, 33, 7, 40, 57), 4, (8, 4)),
]
GAPS = ((10, 1), (11, 2), (1, 3))


def _case_id(c):
    """N, strip width, warps (and blocks past one), ring, row tile."""
    shape = f"w{c[3]}" if c[10] == 1 else f"c{c[10]}w{c[3]}"
    return f"N{c[0]}-W{c[1] * c[2]}-{shape}-ring{c[4]}-tile{c[7]}"


def _model_kw(case):
    N, lanes, cols, warps, ring, publish, release, row_tile, qlen, lens, cluster, remote = case
    return dict(lanes=lanes, cols=cols, warps=warps, ring=ring, row_tile=row_tile,
                publish=publish, release=release, remote=remote, cluster=cluster)


def _schedule_inputs(case, seed):
    N, lens, qlen = case[0], case[9], case[8]
    rng = np.random.default_rng(seed)
    m32 = _matrix(rng)
    q = rng.integers(0, 26, qlen)
    t = rng.integers(-128, 128, (len(lens), N)).astype(np.int8)
    for b, ln in enumerate(lens):
        t[b, :ln] = rng.integers(0, 26, ln)
    return q, t, lens, m32


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=[_case_id(c) for c in SCHEDULE_CASES])
def test_schedule_transcription_matches_serial_gotoh(mode, case):
    idx = SCHEDULE_CASES.index(case)
    q, t, lens, m32 = _schedule_inputs(case, idx)
    gaps = GAPS[idx % len(GAPS)]
    scorer = SimpleNamespace(matrix=np.clip(m32[:26, :26], -128, 127), gap_open=gaps[0],
                             gap_extend=gaps[1])
    for b, ln in enumerate(lens):
        got = _long_model(q, t[b], ln, m32, mode, *gaps, **_model_kw(case))
        tb = t[b, :ln].astype(np.int64)
        assert got == _gotoh(q, tb, m32, mode, *gaps), (b, ln)
        if ln and len(q) and mode != "HW":   # dp_numpy's HW row includes the boundary column
            assert got == dp_numpy.score_pair(q, tb, scorer, mode), (b, ln)


@pytest.mark.parametrize("idx", [1, 6, 12], ids=["one-block", "c2-in-turn", "c4-in-turn"])
def test_schedule_transcription_matches_plain_and_pallas(idx):
    """The transcription at strips in turn (in one block, over a cluster of
    two and of four one-warp blocks), the plain version and the Pallas
    kernel on one launch's targets, gaps with go < ge."""
    case = SCHEDULE_CASES[idx]
    N, qlen = case[0], case[8]
    q, t, lens, m32 = _schedule_inputs(case, 99 + idx)
    args = (q.astype(np.int32), np.zeros(1, np.int32), np.array([qlen], np.int32), t[None],
            np.asarray(lens, np.int32)[None])
    n_chunk = 8 if N % 32 else 32
    for mode in MODES:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(sw_scores_pallas_grouped_long(
                *args, m32, mode=mode, gap_open=1, gap_extend=3, n_chunk=n_chunk,
                m_cap=qlen))[0]
        plain = _k2(args, m32, mode, 1, 3, n_chunk=n_chunk, m_cap=qlen)[0]
        got = [_long_model(q, t[b], ln, m32, mode, 1, 3, **_model_kw(case))
               for b, ln in enumerate(lens)]
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(got, want)


def test_schedule_transcription_fails_with_the_corner_of_the_wrong_row():
    """The corner H (above-left of a strip's first column on a tile's first
    row) is the left strip's H of the tile's last row; one row earlier
    changes these scores, so the cases above hold it."""
    case = SCHEDULE_CASES[1]
    q, t, lens, m32 = _schedule_inputs(case, 1)
    wrong = 0
    for mode in MODES:
        for b, ln in enumerate(lens):
            want = _gotoh(q, t[b, :ln].astype(np.int64), m32, mode, 10, 1)
            assert _long_model(q, t[b], ln, m32, mode, 10, 1, **_model_kw(case)) == want
            wrong += _long_model(q, t[b], ln, m32, mode, 10, 1, corner_shift=1,
                                 **_model_kw(case)) != want
    assert wrong > 0


def test_schedule_transcription_fails_with_a_remote_edge_one_row_early():
    """A block that reads its neighbour block's edge (E and H of the left
    strip's last column, through distributed shared memory) one row early
    gets other scores, so the cluster cases hold the ring's row order
    between blocks."""
    case = SCHEDULE_CASES[8]
    q, t, lens, m32 = _schedule_inputs(case, 2)
    wrong = 0
    for mode in MODES:
        for b, ln in enumerate(lens):
            want = _gotoh(q, t[b, :ln].astype(np.int64), m32, mode, 11, 2)
            assert _long_model(q, t[b], ln, m32, mode, 11, 2, **_model_kw(case)) == want
            wrong += _long_model(q, t[b], ln, m32, mode, 11, 2, edge_shift=1,
                                 **_model_kw(case)) != want
    assert wrong > 0


@pytest.mark.parametrize("G,B,N,warps,cluster,rows,want", [
    # fewer targets than SMs, wider than 16 strips, a query of
    # LONG_CLUSTER_ROWS or more: a cluster of 3/4 of each target's SMs, at
    # most 8 warps a block, past that strips in balanced turns (69 strips
    # on 8 blocks: two turns of 40 and 29, 5 warps a block); 16 strips or
    # fewer: one block, one warp a strip
    (1, 32, 35008, None, None, 1500, (69, 8, 3, 96)),
    (1, 32, 8192, None, None, 1500, (16, 16, 1, 32)),
    (1, 4, 35008, None, None, 1500, (69, 5, 8, 32)),
    (1, 32, 16384, None, None, 360, (32, 6, 3, 96)),
    (1, 16, 16384, None, None, 360, (32, 6, 6, 96)),
    (1, 64, 3072, None, None, 1500, (6, 6, 1, 64)),
    (1, 64, 8192, None, None, 1500, (16, 16, 1, 64)), (2, 3, 100, None, None, 1500, (1, 1, 1, 6)),
    # a shorter query, or none known: one block a target
    *((1, 32, 35008, None, None, rows, (69, 16, 1, 32))
      for rows in (None, 0, 1, 256, sw_grouped.LONG_CLUSTER_ROWS - 1)),
    *((1, 32, 35008, None, None, rows, (69, 8, 3, 96))
      for rows in (sw_grouped.LONG_CLUSTER_ROWS, 360, 2048)),
    (1, 4, 35008, None, None, None, (69, 16, 1, 4)),
    # more targets: one block a target, one warp a strip, and from 6
    # targets an SM 4 warps in balanced turns
    (1, 256, 3072, None, None, 1500, (6, 6, 1, 256)),
    (1, 256, 8192, None, None, 1500, (16, 16, 1, 256)),
    (1, 768, 8192, None, None, 360, (16, 16, 1, 768)),
    (1, 1024, 8192, None, None, 360, (16, 4, 1, 1024)),
    (1, 4096, 3072, None, None, 360, (6, 3, 1, 4096)),
    (1, 4096, 8192, None, None, 360, (16, 4, 1, 4096)),
    (11, 256, 24576, None, None, 330, (48, 4, 1, 2816)),
    # forced
    (1, 32, 35008, 3, None, 1500, (69, 3, 3, 96)), (2, 3, 100, 16, None, None, (1, 16, 1, 6)),
    (1, 32, 35008, None, 4, 360, (69, 6, 4, 128)), (1, 256, 8192, 2, 8, None, (16, 2, 8, 2048)),
])
def test_long_geometry(G, B, N, warps, cluster, rows, want):
    """One warp a strip of 512 columns; the cluster and the warps a block
    from the launch's targets, strips and longest query on a card of 132
    SMs (an H100)."""
    assert sw_grouped.long_geometry(G, B, N, 132, warps, cluster, rows=rows) == want


@pytest.mark.parametrize("targets,want", [
    (None, (24, 4, 1, 1280)), (1280, (24, 4, 1, 1280)), (387, (24, 16, 1, 1280)),
    (42, (24, 6, 2, 2560)), (800, (24, 4, 1, 1280)), (700, (24, 16, 1, 1280)),
])
def test_long_geometry_counts_the_rows_that_hold_a_target(targets, want):
    """A launch of 5 groups of 256 rows, of which ``targets`` hold a
    target (the long-tail run's launches are mostly empty rows), against
    a query of 1,500 rows: the geometry follows the targets, not the
    rows."""
    assert sw_grouped.long_geometry(5, 256, 12288, 132, targets=targets, rows=1500) == want


def test_aligner_tells_k2_how_many_rows_hold_a_target(monkeypatch):
    """The aligner passes K2 each launch's count of rows of length > 0
    and its longest query, which it holds on the host."""
    rng = np.random.default_rng(7)
    items = _long_items(rng)
    seen = []
    real = sw_grouped.sw_scores_grouped_long

    def spy(*a, **k):
        seen.append((k.get("live_targets"), int((a[4] > 0).sum()),
                     k.get("longest_query"), int(a[2].max())))
        return real(*a, **k)

    monkeypatch.setattr(sw_grouped, "sw_scores_grouped_long", spy)
    al = BatchAligner(SCORER, backend="torch", b_cap=8, tail_coalesce=False)
    al.scores_many(items)
    assert seen and all(live == rows and longest == qmax for live, rows, longest, qmax in seen)


@pytest.mark.parametrize("bad", [dict(warps_per_block=0), dict(warps_per_block=17),
                                 dict(cluster=0), dict(cluster=9), dict(cluster=17),
                                 dict(cluster=True)])
def test_long_geometry_refuses_a_split_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        sw_grouped.long_geometry(1, 32, 35008, 132, **bad)


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
    (360, 64, 3072, True), (360, 256, 3072, True), (360, 1024, 3072, True),
    (360, 4096, 3072, False), (360, 256, 8192, True), (360, 1024, 8192, True),
    (360, 1088, 4096, True), (360, 1120, 4096, False), (1500, 256, 8192, True),
    (1500, 768, 8192, True), (1500, 800, 8192, False), (1500, 1024, 8192, False),
    (100, 2048, 4096, True), (100, 4096, 4096, False),
])
def test_long_route_weighs_cells_against_k1s_chain(qlen, n_targets, tlen, k2):
    """K2 while a launch's cells stay under ``LONG_CELLS_PER_COLUMN`` a
    column and pass of K1's longest chain: one query against full targets,
    on both sides of the crossover (1,092 full targets at 360 rows, 786 at
    1,500 rows, where K1 takes three passes), which the constant puts
    between the grid points of ``chip_smoke.py`` phase 3b: K2 won at 64
    and 256 targets, K1 at 4,096, and at 1,024 the two were within a few
    per cent of each other (K2 ahead at 360 rows)."""
    from sift4g_tpu_torch.align.batch import _long_route

    assert _long_route([(qlen, np.full(n_targets, tlen))]) is k2


def test_aligner_sends_a_wide_long_launch_to_k1(monkeypatch):
    """One query with 1,200 candidates at the 3,072 rung: a launch with
    more cells than K1's chain is worth runs K1, not K2 (the scorers are
    stubs here: the route is under test, not the scores)."""
    calls = {"K1": [], "K2": []}
    for name, key in (("sw_scores_grouped", "K1"), ("sw_scores_grouped_long", "K2")):
        def stub(*a, _key=key, **k):
            calls[_key].append(a[3].shape[2])
            return torch.zeros(a[4].shape, dtype=torch.int32)

        monkeypatch.setattr(sw_grouped, name, stub)
    q = np.zeros(360, np.uint8)
    wide = [(q, [np.zeros(2900, np.uint8)] * 1200)]
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


@pytest.mark.parametrize("bad", ["m_cap", "n_chunk", "mode", "warps", "cluster"])
def test_wrapper_refuses_before_any_work(bad, monkeypatch):
    rng = np.random.default_rng(10)
    args = _slab(rng, 1, 2, 128, (128, 5), (40,), 48)
    m32 = _matrix(rng)

    def no_work(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(scan, "align_scores_grouped", no_work)
    kw = dict(mode="SW", n_chunk=64, m_cap=48)
    kw.update({"m_cap": dict(m_cap=39), "n_chunk": dict(n_chunk=96),
               "mode": dict(mode="XW"), "warps": dict(warps_per_block=17),
               "cluster": dict(cluster=9)}[bad])
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

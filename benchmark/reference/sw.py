"""The plain reference's Smith-Waterman scores and tracebacks, in PyTorch.

The recurrence and the traceback of ``sift4g_tpu_torch/align/dp_numpy.py``
(commit eca6a4da), SW mode, with affine gaps: a gap of L residues costs
open + (L - 1) extend.  Row by row over the query, vectorised over every
column of many targets laid end to end, each target behind a boundary
column (j = 0).  The in-row gap E uses the decayed prefix maximum
E[i, j] = max_{k < j}(G[i, k] + k ge) - go - (j - 1) ge of dp_numpy, with a
per-target offset so one cumulative maximum serves all targets.

:func:`scores` gives each target's best score.  :func:`align` keeps, for
each cell, which of the recurrence's terms H equals, and walks back from
the first best cell in row-major order with dp_numpy's preference:
diagonal, then E (left), then F (up).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

NEG = -(1 << 30)
PAD = 31  # query row beyond a query's end: scores NEG_S against anything
NEG_S = -(1 << 20)
MOVE_DIAG, MOVE_LEFT, MOVE_UP = 0, 1, 2


def _matrix32(matrix: np.ndarray, device) -> torch.Tensor:
    """The scores on codes 0..31; the PAD query row and the PAD target
    column (a boundary column) score NEG_S."""
    m = np.full((32, 32), NEG_S, dtype=np.int32)
    m[:26, :26] = matrix
    m[:26, 26:PAD] = 0
    return torch.as_tensor(m.ravel(), device=device)


def packed(targets: Sequence[np.ndarray]):
    """(codes end to end, lengths) of a list of code arrays."""
    lens = np.array([t.shape[0] for t in targets], dtype=np.int64)
    cat = np.concatenate([np.asarray(t, dtype=np.uint8) for t in targets]) if targets else np.zeros(0, np.uint8)
    return cat, lens


class _Layout:
    """Targets end to end, each behind a boundary column; ``targets`` is
    (codes end to end, lengths)."""

    def __init__(self, targets, owner: Sequence[int], device):
        cat, lens = targets
        width = lens + 1
        self.n = lens.shape[0]
        self.base = np.cumsum(width) - width           # boundary column of each target
        n_cols = int(width.sum())
        seg = np.repeat(np.arange(self.n), width)
        kpos = np.arange(n_cols) - self.base[seg]
        code = np.full(n_cols, PAD, dtype=np.int64)
        code[kpos > 0] = cat
        self.n_cols = n_cols
        self.seg = torch.as_tensor(seg, device=device)
        self.kpos = torch.as_tensor(kpos, device=device, dtype=torch.int32)
        self.code = torch.as_tensor(code, device=device)
        self.owner = torch.as_tensor(np.asarray(owner, dtype=np.int64)[seg], device=device)
        self.boundary = self.kpos == 0
        # keeps the prefix maximum inside a target: each target's values
        # sit in their own band of width 2**40
        self.band = self.seg.to(torch.int64) << 40


SCAN_CHUNK = 1024


def _rows(lay: _Layout, qrows: torch.Tensor, mat: torch.Tensor, go: int, ge: int, on_row):
    """Run the recurrence over ``qrows`` ((rows, n_owners) codes, PAD past a
    query's end); ``on_row(i, H, E, F, diag, Fprev)`` sees each row.

    A boundary column scores NEG_S against every letter, so its G is 0 and,
    its E masked to NEG, its H is 0: the j = 0 column of each target.  The
    in-row running maximum runs in two levels: inside chunks of SCAN_CHUNK
    columns (one scan a row, the rows in parallel), then each chunk takes
    the carry of the chunks before it; each target's band keeps the
    maximum inside the target."""
    dev = lay.seg.device
    C = lay.n_cols
    rows = -(-C // SCAN_CHUNK)
    neg = torch.full((C,), NEG, dtype=torch.int32, device=dev)
    H = torch.zeros(C, dtype=torch.int32, device=dev)
    F = neg.clone()
    kge = lay.kpos * ge
    # E[c] = P[c - 1] - band[c] - go - (kpos[c] - 1) ge
    e_off = lay.band + ((lay.kpos - 1) * ge + go).to(torch.int64)
    X = torch.full((rows * SCAN_CHUNK,), torch.iinfo(torch.int64).min, dtype=torch.int64, device=dev)
    E64 = torch.empty(C, dtype=torch.int64, device=dev)
    E64[0] = NEG
    at = lay.owner * 32 + lay.code          # (query of the column, target letter)
    mat2 = mat.view(32, 32)
    for i in range(qrows.shape[0]):
        s = mat2[qrows[i]].view(-1)[at]     # each query's profile row i
        diag = torch.roll(H, 1) + s
        Fn = torch.maximum(H - go, F - ge)
        G = torch.clamp_min(torch.maximum(diag, Fn), 0)
        torch.add(lay.band, G + kge, out=X[:C])
        P = torch.cummax(X.view(rows, SCAN_CHUNK), 1).values
        carry = torch.cummax(P[:, -1], 0).values
        torch.maximum(P[1:], carry[:-1, None], out=P[1:])
        P = P.view(-1)
        torch.sub(P[: C - 1], e_off[1:], out=E64[1:])
        E = torch.where(lay.boundary, neg, E64.to(torch.int32))
        Hn = torch.maximum(G, E)
        on_row(i, Hn, E, Fn, diag, F)
        H, F = Hn, Fn


def _query_rows(queries: Sequence[np.ndarray], device) -> torch.Tensor:
    m = max((q.shape[0] for q in queries), default=0)
    rows = np.full((m, len(queries)), PAD, dtype=np.int64)
    for k, q in enumerate(queries):
        rows[: q.shape[0], k] = q
    return torch.as_tensor(rows, device=device)


def scores(queries: Sequence[np.ndarray], targets, owner: Sequence[int],
           matrix: np.ndarray, go: int, ge: int, device) -> np.ndarray:
    """Best local score of each target against its query ``queries[owner[t]]``;
    ``targets`` as :func:`packed` gives them."""
    lay = _Layout(targets, owner, device)
    if lay.n == 0:
        return np.zeros(0, dtype=np.int64)
    best = torch.zeros(lay.n_cols, dtype=torch.int32, device=device)

    def on_row(i, H, E, F, diag, Fprev):
        torch.maximum(best, H, out=best)

    _rows(lay, _query_rows(queries, device), _matrix32(matrix, device), go, ge, on_row)
    out = torch.zeros(lay.n, dtype=torch.int32, device=device)
    out.scatter_reduce_(0, lay.seg, best, reduce="amax")
    return out.cpu().numpy().astype(np.int64)


def align(queries: Sequence[np.ndarray], targets, owner: Sequence[int], matrix: np.ndarray,
          go: int, ge: int, device) -> List[Tuple[int, int, int, np.ndarray]]:
    """(score, query_start, target_start, moves) of each target's local
    alignment against its query ``queries[owner[t]]`` (``targets`` as
    :func:`packed` gives them); moves run forward from the starts."""
    lay = _Layout(targets, owner, device)
    if lay.n == 0:
        return []
    qrows = _query_rows(queries, device)
    C = lay.n_cols
    flags = torch.zeros((qrows.shape[0], C), dtype=torch.uint8, device=device)
    best = torch.zeros(C, dtype=torch.int32, device=device)
    best_row = torch.zeros(C, dtype=torch.int32, device=device)

    def on_row(i, H, E, F, diag, Fprev):
        Eprev_col = torch.empty_like(E)
        Eprev_col[0] = NEG
        Eprev_col[1:] = E[:-1]
        f = ((H == diag).to(torch.uint8)
             | ((H == E).to(torch.uint8) << 1)
             | ((H == F).to(torch.uint8) << 2)
             | ((E == Eprev_col - ge).to(torch.uint8) << 3)
             | ((F == Fprev - ge).to(torch.uint8) << 4)
             | ((H == 0).to(torch.uint8) << 5))
        flags[i] = f
        best_row.masked_fill_(H > best, i + 1)
        torch.maximum(best, H, out=best)

    _rows(lay, qrows, _matrix32(matrix, device), go, ge, on_row)
    n = lay.n
    score = torch.zeros(n, dtype=torch.int32, device=device).scatter_reduce_(0, lay.seg, best, reduce="amax")
    at_best = best == score[lay.seg]
    big = torch.iinfo(torch.int32).max
    row = torch.full((n,), big, dtype=torch.int32, device=device).scatter_reduce_(
        0, lay.seg, torch.where(at_best, best_row, torch.full_like(best_row, big)), reduce="amin")
    first = at_best & (best_row == row[lay.seg])
    col = torch.full((n,), big, dtype=torch.int32, device=device).scatter_reduce_(
        0, lay.seg, torch.where(first, lay.kpos, torch.full_like(lay.kpos, big)), reduce="amin")
    score, row, col = (t.cpu().numpy().astype(np.int64) for t in (score, row, col))
    row = np.where(score > 0, row, 0)
    col = np.where(score > 0, col, 0)
    return _walk(flags.cpu().numpy(), lay.base, score, row, col)


def _walk(flags: np.ndarray, base: np.ndarray, score, ei, ej):
    """dp_numpy's three-state traceback of every target at once."""
    n = score.shape[0]
    i, j = ei.copy(), ej.copy()
    st = np.zeros(n, dtype=np.int8)          # 0 H, 1 E, 2 F
    alive = np.ones(n, dtype=bool)
    cap = int((ei + ej).max()) + 1 if n else 1
    moves = np.zeros((n, cap), dtype=np.uint8)
    nmoves = np.zeros(n, dtype=np.int64)
    ar = np.arange(n)

    def flag(ii, jj, sel):
        return flags[ii[sel] - 1, base[sel] + jj[sel]]

    while alive.any():
        h = alive & (st == 0)
        stop = h & ((i == 0) | (j == 0))
        alive &= ~stop
        h &= ~stop
        if h.any():
            f = np.zeros(n, dtype=np.uint8)
            f[h] = flag(i, j, h)
            stop = h & ((f & 32) != 0)
            d = h & ~stop & ((f & 1) != 0)
            to_e = h & ~stop & ~d & ((f & 2) != 0)
            to_f = h & ~stop & ~d & ~to_e & ((f & 4) != 0)
            stop |= h & ~d & ~to_e & ~to_f
            alive &= ~stop
            moves[ar[d], nmoves[d]] = MOVE_DIAG
            nmoves[d] += 1
            i[d] -= 1
            j[d] -= 1
            st[to_e] = 1
            st[to_f] = 2
        e = alive & (st == 1)
        if e.any():
            f = np.zeros(n, dtype=np.uint8)
            f[e] = flag(i, j, e)
            moves[ar[e], nmoves[e]] = MOVE_LEFT
            nmoves[e] += 1
            j[e] -= 1
            st[e & ~((j > 0) & ((f & 8) != 0))] = 0
        fu = alive & (st == 2)
        if fu.any():
            f = np.zeros(n, dtype=np.uint8)
            f[fu] = flag(i, j, fu)
            moves[ar[fu], nmoves[fu]] = MOVE_UP
            nmoves[fu] += 1
            i[fu] -= 1
            st[fu & ~((i > 0) & ((f & 16) != 0))] = 0
    return [(int(score[p]), int(i[p]), int(j[p]), moves[p, : nmoves[p]][::-1].copy()) for p in range(n)]

"""Host affine-gap DP with traceback — the semantic oracle.

Implements the four aligner modes the reference exposes (SW/NW/HW/OV,
main.cpp:51-56 and help text :322-328), with SW#-style affine gaps: a gap
of length L costs ``gap_open + (L-1) * gap_extend``.

Mode boundary conditions:
* SW — local: zero floor, best cell anywhere.
* NW — global: penalized boundaries, endpoint (m-1, n-1).
* HW — semiglobal: full query inside target; free target end gaps;
  endpoint = best of last row.
* OV — overlap (dovetail): free end gaps on both; endpoint = best of last
  row or last column.

The row recurrence uses the decayed-prefix-max identity
``E[i,j] = max_{k<j}(H[i,k] + k*ge) - go - (j-1)*ge`` which removes the
serial in-row dependency (NumPy ``maximum.accumulate``); the same identity
drives the on-device scan in align/xla.py.

Traceback is the conventional three-state (H/E/F) walk with deterministic
tie preference DIAG > LEFT(E) > UP(F).  The absent swsharp submodule means
its exact tie order is unknowable from this snapshot; this choice is fixed
and documented here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.scorers import Scorer
from .records import MOVE_DIAG, MOVE_LEFT, MOVE_UP, AlignmentRecord

NEG = -(1 << 30)

MODES = ("SW", "NW", "HW", "OV")


def _dp_matrices(
    q: np.ndarray, t: np.ndarray, scorer: Scorer, mode: str
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full (m+1, n+1) H, E, F int64 matrices (1-based DP indexing)."""
    m, n = q.shape[0], t.shape[0]
    go, ge = scorer.gap_open, scorer.gap_extend
    S = scorer.matrix[np.ix_(q, t)].astype(np.int64)  # (m, n)

    H = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # gap in query (left)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # gap in target (up)

    js = np.arange(1, n + 1, dtype=np.int64)
    is_ = np.arange(1, m + 1, dtype=np.int64)
    H[0, 0] = 0
    if mode == "NW":
        H[0, 1:] = -(go + (js - 1) * ge)
        H[1:, 0] = -(go + (is_ - 1) * ge)
        E[0, 1:] = H[0, 1:]
        F[1:, 0] = H[1:, 0]
    elif mode == "HW":
        H[0, 1:] = 0
        H[1:, 0] = -(go + (is_ - 1) * ge)
        F[1:, 0] = H[1:, 0]
    elif mode == "OV":
        H[0, 1:] = 0
        H[1:, 0] = 0
    else:  # SW
        H[0, 1:] = 0
        H[1:, 0] = 0

    local = mode == "SW"
    for i in range(1, m + 1):
        F[i, 1:] = np.maximum(H[i - 1, 1:] - go, F[i - 1, 1:] - ge)
        diag = H[i - 1, :-1] + S[i - 1]
        G = np.maximum(diag, F[i, 1:])
        if local:
            G = np.maximum(G, 0)
        # E via decayed prefix max over candidates that can open/continue a
        # row gap: both H[i, 0] (boundary) and in-row values participate.
        X = np.empty(n + 1, dtype=np.int64)
        X[0] = H[i, 0]
        X[1:] = G
        P = np.maximum.accumulate(X + np.arange(n + 1) * ge)
        E[i, 1:] = P[:-1] - go - (js - 1) * ge
        H[i, 1:] = np.maximum(G, E[i, 1:])
    return H, E, F


def _find_end(H: np.ndarray, mode: str) -> Tuple[int, int, int]:
    m, n = H.shape[0] - 1, H.shape[1] - 1
    if mode == "NW":
        return int(H[m, n]), m, n
    if mode == "SW":
        flat = int(np.argmax(H))
        i, j = divmod(flat, H.shape[1])
        return int(H[i, j]), i, j
    if mode == "HW":
        j = int(np.argmax(H[m, :]))
        return int(H[m, j]), m, j
    # OV: best of last row / last column
    j = int(np.argmax(H[m, :]))
    i = int(np.argmax(H[:, n]))
    if H[m, j] >= H[i, n]:
        return int(H[m, j]), m, j
    return int(H[i, n]), i, n


def score_pair(q: np.ndarray, t: np.ndarray, scorer: Scorer, mode: str = "SW") -> int:
    """Alignment score only."""
    H, _, _ = _dp_matrices(q, t, scorer, mode)
    return _find_end(H, mode)[0]


def align_pair(
    q: np.ndarray, t: np.ndarray, scorer: Scorer, mode: str = "SW"
) -> AlignmentRecord:
    """Score + full traceback."""
    H, E, F = _dp_matrices(q, t, scorer, mode)
    score, ei, ej = _find_end(H, mode)
    go, ge = scorer.gap_open, scorer.gap_extend
    S = scorer.matrix
    moves = []
    i, j = ei, ej
    state = "H"
    local = mode == "SW"
    while True:
        if state == "H":
            if i == 0 or j == 0:
                break
            if local and H[i, j] == 0:
                break
            diag = H[i - 1, j - 1] + int(S[q[i - 1], t[j - 1]])
            if H[i, j] == diag:
                moves.append(MOVE_DIAG)
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                state = "E"
            elif H[i, j] == F[i, j]:
                state = "F"
            else:  # boundary-derived value (free end gaps) — stop
                break
        elif state == "E":
            moves.append(MOVE_LEFT)
            j -= 1
            if j > 0 and E[i, j + 1] == E[i, j] - ge:
                state = "E"
            else:
                state = "H"
        else:  # F
            moves.append(MOVE_UP)
            i -= 1
            if i > 0 and F[i + 1, j] == F[i, j] - ge:
                state = "F"
            else:
                state = "H"
    moves.reverse()
    # For NW/HW/OV the walk can stop on a penalized/free boundary with
    # residues remaining; extend with boundary gap moves.
    if mode == "NW":
        while i > 0:
            moves.insert(0, MOVE_UP)
            i -= 1
        while j > 0:
            moves.insert(0, MOVE_LEFT)
            j -= 1
    elif mode == "HW":
        while i > 0:
            moves.insert(0, MOVE_UP)
            i -= 1
    qs, ts = i, j
    return AlignmentRecord(
        score=score,
        query_start=qs,
        query_end=ei - 1,
        target_start=ts,
        target_end=ej - 1,
        moves=np.asarray(moves, dtype=np.uint8),
        query_codes=q,
        target_codes=t,
    )

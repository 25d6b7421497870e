"""Alignment-string extraction and median-entropy selection.

Mirrors select_alignments.cpp:

* :func:`extract_alignment_strings` — alignmentsExtract (:127-181) + the
  MOVE replay of aligmentStr (:244-300): each alignment becomes a
  query-length row of letter codes where positions outside the aligned
  region and target-gap (MOVE_UP) positions are 'X', and target insertions
  (MOVE_LEFT) are dropped (quirk Q6).
* :func:`alignments_select` — alignmentsSelect (:183-242): grow the prefix
  of best-first alignments until the median over positions of per-position
  column entropy (+ log2 20) drops to <= threshold.  Float32 accumulation
  (quirk Q9) and the get_median len-1 sort quirk (Q1) are reproduced.
  Returns the number of selected rows (>= 1 when any rows exist unless the
  loop exhausts, quirk Q8).

The port's copy drops the "stale .so" ``hasattr`` guards around the native
helpers (the port builds its library from the sources it binds).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..align.records import MOVE_DIAG, MOVE_LEFT, MOVE_UP, AlignmentRecord
from ..constants import LOG_2_20, get_median
from ..core.chain import Chain

X_CODE = ord("X") - ord("A")  # 23

# f32(num/den * log2(num/den)) for all (num, den) count pairs: the entropy
# terms take only O(n^2) distinct values per query (counts <= n rows), so
# a table gather replaces the log2/div/mul flops that dominate selection
# at missense scale (measured ~120 ms/query at n=400 near-identical rows).
# Row 0 / col 0 are zero: a cum==0 lookup IS the reference's count>0 skip.
# Values are bit-identical to the direct computation (same f32 op chain).
_XLOGX = {"entry": (0, None, None)}  # (size, table, transpose), atomic publish


def _xlogx_table(cap: int) -> np.ndarray:
    """Table covering count values 0..cap.  Thread-safe under the query
    fan-out: the caller always receives the table IT validated/built (a
    racing thread's publish can never hand out a smaller table), and a
    smaller build never replaces a larger published one."""
    size, tab, _ = _XLOGX["entry"]
    if size > cap:
        return tab
    return _xlogx_build(cap)[0]


def _xlogx_table_t(cap: int) -> np.ndarray:
    """Denominator-major transpose of the same table (bit-identical
    values) — the native select's layout: a position's whole entropy sum
    (fixed denominator, small numerators) reads one contiguous row."""
    size, _, tab_t = _XLOGX["entry"]
    if size > cap:
        return tab_t
    return _xlogx_build(cap)[1]


def _xlogx_build(cap: int):
    size = 1
    while size <= cap:
        size *= 2
    v = np.arange(size, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = v[:, None] / v[None, :]
        tab = (t * np.log2(t)).astype(np.float32)
    tab[0, :] = np.float32(0.0)
    tab[:, 0] = np.float32(0.0)
    tab_t = np.ascontiguousarray(tab.T)
    if size > _XLOGX["entry"][0]:
        _XLOGX["entry"] = (size, tab, tab_t)
    return tab, tab_t


def _native_select(rows: np.ndarray, n: int, L: int, threshold) -> "int | None":
    """native/select.cpp: the bit-exact C++ twin (it consumes the SAME
    Python-built xlogx table, so no libm ulp drift is possible); ~50x the
    blocked numpy path at missense scale.  None -> fall through."""
    from .. import native

    lib = native.load()
    if lib is None:
        return None
    import ctypes

    tab_t = _xlogx_table_t(n)
    r = np.ascontiguousarray(rows, dtype=np.uint8)
    return int(lib.sift4g_select(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, L,
        tab_t.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tab_t.shape[0],
        ctypes.c_float(float(threshold)),
        ctypes.c_double(LOG_2_20),
    ))


def _native_extract(records, rows, moves, mlens, tlens, tcodes) -> bool:
    """native/select.cpp sift4g_extract: one scalar pass over the
    concatenated move streams (the numpy replay below is memory-traffic-
    bound at missense scale).  False -> caller falls through to numpy."""
    from .. import native

    lib = native.load()
    if lib is None:
        return False
    import ctypes

    n = len(records)
    moff = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mlens, out=moff[1:])
    toff = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(tlens, out=toff[1:])
    q0 = np.fromiter((r.query_start for r in records), dtype=np.int64, count=n)
    t0 = np.fromiter((r.target_start for r in records), dtype=np.int64, count=n)
    moves = np.ascontiguousarray(moves, dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    args = (
        moves.ctypes.data_as(u8p), moff.ctypes.data_as(i64p),
        q0.ctypes.data_as(i64p), t0.ctypes.data_as(i64p),
        tcodes.ctypes.data_as(u8p), toff.ctypes.data_as(i64p),
        n, rows.shape[1], rows.ctypes.data_as(u8p),
    )
    bad = int(lib.sift4g_extract_checked(*args))
    if bad >= 0:
        # same failure mode as the numpy replay (advisor r4: the
        # silent native truncation masked upstream move-stream bugs)
        raise IndexError(
            f"corrupt alignment move stream: record {bad} runs a "
            f"MOVE_DIAG past its query/target bounds"
        )
    return True


def extract_alignment_strings(
    query: Chain, records: List[AlignmentRecord]
) -> Tuple[List[str], np.ndarray]:
    """Returns (target names, rows (n, L) uint8 letter codes).

    The MOVE replay (aligmentStr, select_alignments.cpp:244-300) is
    vectorized ACROSS records: all move arrays concatenate into one
    stream with per-record cumsum resets, so a 400-record query costs
    ~15 numpy dispatches total instead of ~8 per record (the "Python
    record plumbing" half of the select phase at missense scale).
    Semantics: MOVE_LEFT (target insertion) advances only the target
    cursor and emits nothing; MOVE_UP leaves 'X' (the row default);
    MOVE_DIAG copies the target letter at its cursor (quirk Q6)."""
    L = len(query)
    n = len(records)
    rows = np.full((n, L), X_CODE, dtype=np.uint8)
    names = [rec.target_name for rec in records]
    if n == 0:
        return names, rows
    mlens = np.fromiter(
        (rec.moves.shape[0] for rec in records), dtype=np.int64, count=n
    )
    total = int(mlens.sum())
    if total == 0:
        return names, rows
    moves = np.concatenate([rec.moves for rec in records])
    tcodes = np.concatenate(
        [np.asarray(rec.target_codes, dtype=np.uint8) for rec in records]
    )
    tlens = np.fromiter(
        (len(rec.target_codes) for rec in records), dtype=np.int64, count=n
    )
    if _native_extract(records, rows, moves, mlens, tlens, tcodes):
        return names, rows
    # clip: an empty record's start can equal `total` (its cq0/ct0 values
    # are never consumed — rec_of skips zero-length records)
    rec_starts = np.minimum(
        np.concatenate(([0], np.cumsum(mlens)[:-1])), total - 1
    )
    rec_of = np.repeat(np.arange(n, dtype=np.int64), mlens)
    q0 = np.fromiter((rec.query_start for rec in records), dtype=np.int64, count=n)
    t0 = np.fromiter((rec.target_start for rec in records), dtype=np.int64, count=n)
    t_base = np.cumsum(tlens) - tlens  # record offsets into tcodes

    adv_q = moves != MOVE_LEFT
    adv_t = moves != MOVE_UP
    cq = np.cumsum(adv_q)
    ct = np.cumsum(adv_t)
    # cumsum value just BEFORE each record's first move, broadcast back
    cq0 = (cq[rec_starts] - adv_q[rec_starts])[rec_of]
    ct0 = (ct[rec_starts] - adv_t[rec_starts])[rec_of]
    qpos = q0[rec_of] + (cq - cq0) - adv_q
    tpos = t0[rec_of] + (ct - ct0) - adv_t
    diag = moves == MOVE_DIAG
    rows[rec_of[diag], qpos[diag]] = tcodes[(t_base[rec_of] + tpos)[diag]]
    return names, rows


def alignments_select(rows: np.ndarray, threshold: float) -> int:
    """Number of leading rows selected (alignmentsSelect, :183-242).

    Prefixes are evaluated in geometrically growing BLOCKS with the
    per-prefix entropy vectorized over the block: the scalar loop cost
    ~130 numpy dispatches per prefix and homolog-heavy (missense)
    queries evaluate all ~400 prefixes (the median never drops for
    near-identical rows), measured at ~124 ms/query — the blocked form
    computes identical float32 values (same division, same sequential
    amino-acid accumulation order, quirk Q9) in ~40 dispatches per
    block."""
    n, L = rows.shape
    if n == 0:
        return 0
    threshold = np.float32(threshold)
    if np.float32(LOG_2_20) <= threshold:
        return 0  # the loop guard fails before the first prefix (Q8)
    if n < 4096:
        sel = _native_select(rows, n, L, threshold)
        if sel is not None:
            return sel
    counts = np.zeros((L, 26), dtype=np.int32)
    i = 1
    blk = 4
    blk_cap = max(1, min(64, 4_000_000 // (max(L, 1) * 26)))
    while i <= n:
        b = min(blk, n - i + 1)
        seg = rows[i - 1 : i - 1 + b]
        onehot = np.zeros((b, L, 26), dtype=np.int32)
        bi, li = np.nonzero(seg != X_CODE)
        onehot[bi, li, seg[bi, li]] = 1
        # counts for every prefix in the block: (b, L, 26)
        cum = counts[None] + np.cumsum(onehot, axis=0)
        valid = cum.sum(axis=2)
        if n < 4096:
            tab = _xlogx_table(n)
            term = tab[cum, np.broadcast_to(valid[:, :, None], cum.shape)]
        else:  # huge --max-aligns: direct computation (same f32 chain)
            with np.errstate(divide="ignore", invalid="ignore"):
                t = cum.astype(np.float32) / valid.astype(np.float32)[:, :, None]
                term = np.where(
                    cum > 0, t * np.log2(t), np.float32(0.0)
                ).astype(np.float32)
        pos_freq = np.zeros((b, L), dtype=np.float32)
        for aa in range(26):  # sequential f32 accumulation order (Q9)
            pos_freq = (pos_freq + term[:, :, aa]).astype(np.float32)
        # the reference adds the double constant kLog_2_20 to a float
        # lvalue: compute in f64, truncate to f32
        pf = (pos_freq.astype(np.float64) + LOG_2_20).astype(np.float32)
        for k in range(b):
            if get_median(pf[k], L) <= threshold:
                return i + k  # first prefix whose median passes (Q8)
        counts = cum[-1]
        i += b
        blk = min(blk * 2, blk_cap)
    return n

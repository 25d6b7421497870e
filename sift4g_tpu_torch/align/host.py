"""Host helpers of the aligner, copied from ``sift4g_tpu/align/batch.py``.

``PackedTargets`` (candidates as one codes base plus starts and lengths),
the padded-length rung ladder, and the native score-only and traceback
batch calls.  None of it touches a device.  The copy drops the "stale .so"
``hasattr`` guard in ``score_pairs_batch`` (the port builds its native
library from the sources it binds).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.scorers import Scorer
from ..utils import PhaseMetrics

PAD_CODE = 31

_MODE_IDS = {"SW": 0, "NW": 1, "HW": 2, "OV": 3}
# the C++ aligner's counters, in the order of its out_stats array (enum
# AlignStat of native/aligner.cpp)
ALIGN_STATS = ("striped_cells", "scalar_cells", "striped_thread_s", "scalar_thread_s", "threads",
               "saturated_pairs", "walk_thread_s")


class PackedTargets:
    """Candidate targets as (codes_base, starts, lens) arrays.

    Per-target Python objects dominate dispatch at high query counts; this
    form lets the grouped Pallas path bucket and pack with pure array math
    and pointer arithmetic.  Indexing/iteration materialize zero-copy views
    so every other backend consumes it like a list of arrays.
    """

    __slots__ = ("codes", "starts", "lens")

    def __init__(self, codes: np.ndarray, starts: np.ndarray, lens: np.ndarray):
        self.codes = codes
        self.starts = np.asarray(starts, dtype=np.int64)
        self.lens = np.asarray(lens, dtype=np.int32)

    def __len__(self) -> int:
        return int(self.lens.shape[0])

    def __getitem__(self, i: int) -> np.ndarray:
        s = self.starts[i]
        return self.codes[s : s + self.lens[i]]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def total_len(self) -> int:
        return int(self.lens.sum())


def _targets_total_len(targets) -> int:
    if isinstance(targets, PackedTargets):
        return targets.total_len()
    return sum(t.shape[0] for t in targets)


def _length_rungs_vec(lens: np.ndarray, base: int) -> np.ndarray:
    """Vectorized _length_rung over an int array (exact next-pow2 via
    frexp: no float-log rounding hazards)."""
    k = -(-np.maximum(lens, 1) // base)
    m, e = np.frexp(k.astype(np.float64))
    p = np.where(m == 0.5, np.left_shift(1, e - 1), np.left_shift(1, e))
    p34 = (p // 4) * 3
    p = np.where((p >= 4) & (p34 >= k), p34, p)
    return (p * base).astype(np.int64)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _length_rung(n: int, base: int) -> int:
    """Padded-length ladder base * {1, 2, 3, 4, 6, 8, 12, 16, ...}: bounds
    the number of compiled kernel shapes (each distinct shape pays a full
    Mosaic compile) with <= 1.5x padding waste."""
    k = -(-max(n, 1) // base)          # ceil multiple of base
    p = 1
    while p < k:
        p *= 2
    if p >= 4 and 3 * p // 4 >= k:     # 3 * 2^a rung between powers of two
        p = 3 * p // 4
    return base * p


def align_pairs_batch(
    query_codes: np.ndarray,
    targets: Sequence[np.ndarray],
    scorer: Scorer,
    mode: str = "SW",
    threads: int = 0,
    metrics=None,
):
    """Score + traceback for one query vs many targets.

    Uses the threaded native aligner (native/aligner.cpp) when available,
    else the NumPy oracle per pair.  ``threads`` mirrors the reference's
    -t (main.cpp:188 feeds its pool size everywhere); 0 = hardware
    concurrency.  Returns a list of AlignmentRecord.

    ``metrics`` (a ``PhaseMetrics``) times the native path's spans
    ``align.traceback.pack`` (the targets' concatenation),
    ``align.traceback.native`` (the C++ call) and
    ``align.traceback.records``, and counts on ``align.traceback.native``
    its ``calls``, ``pairs`` and ``cells`` and the C++ aligner's
    ``ALIGN_STATS``: which path took each pair's cells, the seconds the
    worker threads spent in each, the threads used, the SW pairs whose
    striped int16 fill saturated and were rerun on the scalar path, and the
    striped seconds spent after the fill (the walk).  Without
    ``metrics`` the C++ aligner gets no stats array and reads no clock.
    """
    from ..native import load as _load_native
    from .dp_numpy import align_pair
    from .records import AlignmentRecord

    if not targets:
        return []
    lib = _load_native()
    if lib is None:
        return [align_pair(query_codes, t, scorer, mode) for t in targets]

    import ctypes

    stats = None
    if metrics is None:
        metrics = PhaseMetrics(enabled=False)
    else:
        stats = np.zeros(len(ALIGN_STATS), dtype=np.float64)
    n = len(targets)
    with metrics.phase("align.traceback.pack"):
        q = np.ascontiguousarray(query_codes, dtype=np.uint8)
        offsets = np.zeros(n + 1, dtype=np.int64)
        for i, t in enumerate(targets):
            offsets[i + 1] = offsets[i] + t.shape[0]
        concat = np.empty(int(offsets[-1]), dtype=np.uint8)
        for i, t in enumerate(targets):
            concat[offsets[i] : offsets[i + 1]] = t
        matrix26 = np.ascontiguousarray(scorer.matrix, dtype=np.int32)

        score = np.empty(n, dtype=np.int32)
        qs = np.empty(n, dtype=np.int32)
        qe = np.empty(n, dtype=np.int32)
        ts = np.empty(n, dtype=np.int32)
        te = np.empty(n, dtype=np.int32)
        cap = int(offsets[-1]) + n * (q.shape[0] + 1)
        moves_buf = np.empty(cap, dtype=np.uint8)
        moves_off = np.empty(n + 1, dtype=np.int64)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    with metrics.phase("align.traceback.native"):
        rc = lib.sift4g_align_batch(
            q.ctypes.data_as(u8p), q.shape[0],
            concat.ctypes.data_as(u8p), offsets.ctypes.data_as(i64p), n,
            matrix26.ctypes.data_as(i32p),
            scorer.gap_open, scorer.gap_extend, _MODE_IDS[mode],
            max(int(threads), 0),
            score.ctypes.data_as(i32p), qs.ctypes.data_as(i32p),
            qe.ctypes.data_as(i32p), ts.ctypes.data_as(i32p),
            te.ctypes.data_as(i32p),
            moves_buf.ctypes.data_as(u8p), cap,
            moves_off.ctypes.data_as(i64p),
            None if stats is None else stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    if stats is not None:
        metrics.add("align.traceback.native", calls=1.0, pairs=float(n),
                    cells=float(q.shape[0]) * float(offsets[-1]),
                    **{k: float(v) for k, v in zip(ALIGN_STATS, stats)})
    if rc != 0:  # moves overflow cannot happen with cap = sum(n_i) + n*(m+1)
        return [align_pair(query_codes, t, scorer, mode) for t in targets]

    with metrics.phase("align.traceback.records"):
        out = []
        for i, t in enumerate(targets):
            out.append(
                AlignmentRecord(
                    score=int(score[i]),
                    query_start=int(qs[i]),
                    query_end=int(qe[i]),
                    target_start=int(ts[i]),
                    target_end=int(te[i]),
                    moves=moves_buf[moves_off[i] : moves_off[i + 1]].copy(),
                    query_codes=query_codes,
                    target_codes=t,
                )
            )
    return out


def score_pairs_batch(
    query_codes: np.ndarray,
    targets,
    scorer: Scorer,
    mode: str = "SW",
    threads: int = 0,
) -> np.ndarray:
    """Scores only (int64 array) for one query vs many targets.

    Threaded linear-memory C++ DP (native/aligner.cpp sift4g_score_batch)
    — the CPU scoring backend ``native``: no traceback matrices, ~4x
    align_pairs_batch.  PackedTargets passes its (codes, starts, lens)
    arrays zero-copy.  Falls back to the NumPy oracle when the native
    library is turned off.
    """
    from ..native import load as _load_native
    from .dp_numpy import score_pair

    n = len(targets)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    lib = _load_native()
    if lib is None:
        return np.array(
            [score_pair(query_codes, t, scorer, mode) for t in targets],
            dtype=np.int64,
        )

    import ctypes

    q = np.ascontiguousarray(query_codes, dtype=np.uint8)
    if isinstance(targets, PackedTargets):
        base = np.ascontiguousarray(targets.codes, dtype=np.uint8)
        starts = np.ascontiguousarray(targets.starts, dtype=np.int64)
        lens = np.ascontiguousarray(targets.lens, dtype=np.int32)
    else:
        lens = np.fromiter(
            (t.shape[0] for t in targets), dtype=np.int32, count=n
        )
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        base = np.empty(int(starts[-1]) + int(lens[-1]), dtype=np.uint8)
        for i, t in enumerate(targets):
            base[starts[i] : starts[i] + lens[i]] = t
    matrix26 = np.ascontiguousarray(scorer.matrix, dtype=np.int32)
    score = np.empty(n, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sift4g_score_batch(
        q.ctypes.data_as(u8p), q.shape[0],
        base.ctypes.data_as(u8p),
        starts.ctypes.data_as(i64p), lens.ctypes.data_as(i32p), n,
        matrix26.ctypes.data_as(i32p),
        scorer.gap_open, scorer.gap_extend, _MODE_IDS[mode],
        max(int(threads), 0),
        score.ctypes.data_as(i32p),
    )
    return score.astype(np.int64)

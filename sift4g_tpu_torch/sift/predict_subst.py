"""Substitution-mode prediction at proteome scale: device-f32 screen +
sparse host-f64 exact scoring (VERDICT r4 item 1).

The reference's product mode scores a user substitution list against the
float64 SIFT matrix (sift_prediction.cpp:220-230, sift_scores.cpp:247-314);
its printed calls sit directly on the 0.05 TOLERATED threshold and on
2-decimal rounding boundaries, so the full-matrix float32 device path
cannot be trusted for the OUTPUT values.  But almost none of the matrix is
ever printed: a subst-mode query prints (a) one line per substitution —
needing the exact score row at each substituted position — and (b)
WARNING lines for positions whose REFERENCE residue scores below 0.05
(printSubstFile's leading loop, sift_scores.cpp:258-276, plus
addPosWithDelRef, :218-231) — needing only the exact rows at positions
that might trip that threshold.

So the hybrid: the batched device pipeline (predict_batch.py) computes
the f32 matrix for every subst query; positions whose f32 reference-cell
score falls below ``0.05 + EPS_SCREEN`` — together with every substituted
position — are re-derived EXACTLY in float64 by running the oracle's own
math on just those rows (sparse_exact_scores below; the Dirichlet
gammaln tree, the oracle's per-query cost center, is elementwise per
position, so a row subset is bit-identical to slicing the full result —
property-tested).  Every printed value and every threshold decision that
CAN fire therefore comes from the float64 path; the f32 screen only ever
asserts "this reference cell is comfortably TOLERATED", with two layers
of protection:

* margin — measured |f32 − f64| on these [0, 1] scores is ~1e-5
  (tests/test_sift_jax.py); the screen margin is 100x that;
* in-run verification — at every exactly-computed row the f32 values are
  compared against f64; any deviation beyond EPS_SCREEN/2 falls the
  whole query back to the float64 oracle (predict.predict_prepared),
  so a systematic f32 drift degrades to the slow-correct path, loudly.

Median seq info (the other printed column) is always host float64
(scores.add_median_seq_info, memoized per keep-mask).

Where the finishers run: that float64 NumPy holds the GIL, so a job's
finishers (:class:`JobFinishers`) go to one spawn process pool a process
(:class:`FinisherPool`, ``POOL``), kept across its jobs, once its workers
have started; until then, and where the pool is not started, they run on
the device branch's writer threads.  The files are the same bytes either
way.

In the port the device branch of ``pipeline.finish_pipeline`` calls the
finishers here, with the screen from ``scores_torch.py``.  The copy drops
the "stale .so" ``hasattr`` guard around the native weights helper.
"""

from __future__ import annotations

import io
import os
import sys
from concurrent.futures import Future, wait
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.chain import Chain
from ..io.subst import parse_subst_line
from ..io.writers import write_subst_predictions
from .predict import add_pos_with_del_ref, hash_predicted_pos, predict_prepared
from .scores import (
    add_median_seq_info,
    calc_diri,
    calc_epsilon,
    calc_seq_weights,
    create_matrix,
    find_max_aa,
)

from ..constants import TOLERANCE_PROB_THRESHOLD

# screen margin over the 0.05 threshold (see module docstring); the env
# knob exists for the forced-fallback tests and for paranoid production
# runs (raising it only adds exactly-computed positions)
try:
    EPS_SCREEN = float(os.environ.get("SIFT4G_TPU_SUBST_EPS", "1e-3"))
except ValueError:
    raise ValueError(
        "environment variable SIFT4G_TPU_SUBST_EPS="
        f"{os.environ.get('SIFT4G_TPU_SUBST_EPS')!r} is not a float"
    ) from None


def _seq_weights_fast(rows: np.ndarray, raw_matrix: np.ndarray):
    """calc_seq_weights via native/median.cpp when available (bitwise
    equal — it replicates numpy's pairwise reduction orders; fuzz-locked
    with the rest of the median tree in tests/test_native.py)."""
    from .. import native
    from ..constants import VALID_AA_MASK

    lib = native.load()
    if lib is None:
        return calc_seq_weights(rows, raw_matrix)
    import ctypes

    r = np.ascontiguousarray(rows, dtype=np.uint8)
    n, L = r.shape
    w = np.empty(n, dtype=np.float64)
    ndiff = np.empty(L, dtype=np.float64)
    valid_u8 = np.ascontiguousarray(VALID_AA_MASK, dtype=np.uint8)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.sift4g_seq_weights(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, L,
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w.ctypes.data_as(dp), ndiff.ctypes.data_as(dp),
    )
    return w, ndiff


def sparse_exact_scores(
    rows: np.ndarray, raw_matrix: np.ndarray, positions: np.ndarray
) -> np.ndarray:
    """Float64 SIFT score rows at ``positions`` — bit-identical to
    ``calc_sift_scores(rows, raw_matrix)[0][positions]`` (the Henikoff
    weights / weighted matrix / epsilon are global across positions and
    computed in full; only the Dirichlet tree and the blend/normalize,
    which are per-position, run on the subset).  Property-tested equal in
    tests/test_predict_subst.py."""
    seq_weights, ndiff = _seq_weights_fast(rows, raw_matrix)
    # the weighted count matrix, epsilon and Dirichlet tree are all
    # per-position: computing them on the COLUMN subset is bit-identical
    # to slicing the full computation (each column's summation tree and
    # elementwise chain is independent of which other columns exist) and
    # drops the remaining O(26*n*L) host term to O(26*n*|positions|)
    sub_rows = np.ascontiguousarray(rows[:, positions])
    weighted, tot_weights = create_matrix(sub_rows, seq_weights)
    max_aa = find_max_aa(weighted)
    eps = calc_epsilon(weighted, max_aa, ndiff[positions])
    diric = calc_diri(weighted)
    sift = (weighted + eps[:, None] * diric) / (tot_weights + eps)[:, None]
    mx = find_max_aa(sift)
    sift = sift / sift[np.arange(positions.shape[0]), mx][:, None]
    return sift


def finish_counts(n_positions: int, exact: int, fallback: bool = False) -> Dict[str, float]:
    """A finisher's counts (:func:`finish_subst_query`): ``n_positions``
    all exact after a fallback."""
    return {"positions": float(n_positions),
            "exact_positions": 0.0 if fallback else float(exact),
            "fallback_positions": float(n_positions) if fallback else 0.0}


def finish_subst_task(payload) -> Tuple[Dict[str, float], str]:
    """Process-pool entry for one subst finisher (a picklable flat
    payload; :class:`FinisherPool`).  Workers import only the port's host
    modules (no JAX).  Returns the finisher's counts, which the job's
    thread adds to its metrics, and what the finisher printed (its
    fallback notice), which the job's thread prints to the job's log: a
    worker's stderr is not the job's log."""
    (name, letters, rows, subst_lines, f32_scores, out_path, eps_screen) = payload
    log = io.StringIO()
    counts = finish_subst_query(Chain.from_string(name, letters), rows, subst_lines,
                                f32_scores, out_path, eps_screen=eps_screen, log=log)
    return counts, log.getvalue()


# a job of this many device subst queries starts the pool in a process
# that has run no such job before
POOL_FROM_QUERIES = 256


def _knob() -> Optional[int]:
    """``SIFT4G_TPU_SUBST_PROCS``, read at every job: None where unset."""
    knob = os.environ.get("SIFT4G_TPU_SUBST_PROCS", "")
    if not knob:
        return None
    try:
        return max(0, int(knob))
    except ValueError:
        raise ValueError(
            f"environment variable SIFT4G_TPU_SUBST_PROCS={knob!r} is not an integer"
        ) from None


def _default_width() -> int:
    try:
        n_cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        n_cores = os.cpu_count() or 1
    # the job's thread keeps a core for packing and device fetches
    return min(3, max(1, n_cores - 1))


def _worker_ready() -> int:
    """The no-op a pool worker answers once it can run a finisher: it
    imports this module and binds the native library on the way."""
    from .. import native

    native.load()
    return os.getpid()


class FinisherPool:
    """The subst finishers' spawn process pool of one process (``POOL``).

    The finishers' float64 NumPy holds the GIL (about 6-11 ms a query),
    so on the writer threads they serialise the job's thread, which
    dispatches the device chunks; in worker processes they leave it the
    GIL.  Spawning the workers costs seconds, so the pool is started once
    and kept for the process's later jobs (a daemon's, the benchmark's
    warm process's).  :meth:`start_for_job`, at a job's start, decides
    whether to start it; its workers start in the background, during the
    job's search, and until they have answered a no-op (:meth:`ready`) a
    job runs its finishers inline.  A job that finds a worker dead drops
    the pool (:meth:`close`), and a later job starts another.  At exit
    the workers are ended at once, not joined: one still starting would
    hold the exit until it had imported its modules.

    It uses two CPython internals, which every Python from 3.10 (the
    package's floor) has: ``threading._register_atexit`` and
    ``ProcessPoolExecutor._processes``."""

    def __init__(self):
        self.executor = None
        self.width = 0
        self.answered = ()      # the no-op's futures, one a worker
        self.ran_subst_job = False
        self._exit_hook = False

    def start_for_job(self, n_subst: int) -> None:
        """The start rule, at the start of a job that device predict may
        finish ``n_subst`` subst queries of.  Unset,
        ``SIFT4G_TPU_SUBST_PROCS`` leaves it to what the process has seen:
        the pool starts at the process's second such job, or at a job of
        ``POOL_FROM_QUERIES`` of them, and is kept.  A number starts that
        many workers from the first job (:meth:`for_job` waits for them);
        0 starts none and leaves a live pool as it is."""
        if n_subst <= 0:
            return
        knob = _knob()
        if knob is not None:
            width = knob
        elif self.executor is not None:
            width = 0
        elif self.ran_subst_job or n_subst >= POOL_FROM_QUERIES:
            width = _default_width()
        else:
            width = 0
        self.ran_subst_job = True
        if width > 0:
            self._start(width)

    def for_job(self) -> bool:
        """Whether a job's finishers go to the pool, once :meth:`ready`:
        where a pool was started and ``SIFT4G_TPU_SUBST_PROCS`` is not 0.
        Under a number, waits for the workers to start."""
        knob = _knob()
        if self.executor is None or knob == 0:
            return False
        if knob is not None:
            wait(self.answered)
        return True

    def _start(self, width: int) -> None:
        if self.executor is not None and self.width == width:
            return
        self.close()
        import multiprocessing
        import threading
        from concurrent.futures import ProcessPoolExecutor

        try:
            # spawn, not fork: the parent is multi-threaded (writer pool,
            # PyTorch's threads) when workers start, and a fork could
            # inherit a lock mid-acquisition and deadlock the child
            self.executor = ProcessPoolExecutor(
                max_workers=width, mp_context=multiprocessing.get_context("spawn"))
        except (OSError, ValueError):
            return
        self.width = width
        if not self._exit_hook:
            # concurrent.futures joins its pools' workers in a hook of the
            # same kind, registered when it was imported; these hooks run
            # last registered first, so this one ends the workers before
            self._exit_hook = True
            threading._register_atexit(self.close)
        # each submit that finds no idle worker spawns one
        self.answered = [self.executor.submit(_worker_ready) for _ in range(width)]

    def ready(self) -> bool:
        """Whether the workers have answered the no-op."""
        return self.executor is not None and all(f.done() for f in self.answered)

    def submit(self, payload) -> Future:
        """:func:`finish_subst_task` of ``payload`` in a worker; raises
        ``BrokenProcessPool`` if a worker has died."""
        return self.executor.submit(finish_subst_task, payload)

    def close(self) -> None:
        """Stop the workers now; a later job may start new ones."""
        ex, self.executor, self.answered = self.executor, None, ()
        if ex is None:
            return
        # the executor has no public way to end its workers before 3.14
        procs = list(ex._processes.values()) if ex._processes else []
        ex.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            p.terminate()


POOL = FinisherPool()


class JobFinishers:
    """One job's subst finishers (``pipeline._predict_on_device``): each
    runs in the process's pool (``POOL``) once its workers have answered,
    else inline on the writer thread that calls it."""

    def __init__(self, log=sys.stderr):
        self.log = log
        self.pool = POOL if POOL.for_job() else None
        self.sent = []          # (future, the finisher's arguments)
        self.broken = False

    def finisher(self, query: Chain, rows: np.ndarray, subst_lines: List[str], out_path: str):
        """The ``finishers`` hook of ``predict_batch.predict_matrix_batch``
        for one query: it returns the counts of an inline finisher, None
        for one sent to the pool (:meth:`drain` collects those)."""
        return lambda scores: self._finish((query, rows, subst_lines, scores, out_path))

    def _finish(self, args):
        query, rows, subst_lines, scores, out_path = args
        if self.pool is not None and not self.broken and self.pool.ready():
            try:
                fut = self.pool.submit((query.name, query.letters, rows, subst_lines,
                                        np.ascontiguousarray(scores), out_path, EPS_SCREEN))
            except BrokenProcessPool:
                self.broken = True
            else:
                self.sent.append((fut, args))
                return None
        return finish_subst_query(*args, log=self.log)

    def drain(self) -> Tuple[List[Dict[str, float]], float]:
        """Wait for the finishers sent to the pool, on the job's thread.
        Returns their counts and the positions of the queries they
        finished in a worker; prints their notices to the job's log.
        A finisher a dead worker left unfinished reruns here, inline, and
        the pool is dropped; any other worker exception is raised."""
        counts, pooled = [], 0.0
        for fut, args in self.sent:
            try:
                c, notice = fut.result()
            except BrokenProcessPool:
                self.broken = True
                counts.append(finish_subst_query(*args, log=self.log))
                continue
            print(notice, end="", file=self.log)
            counts.append(c)
            pooled += c["positions"]
        if self.broken:
            self.pool.close()
        return counts, pooled

    def cancel(self) -> None:
        """After a job's error: cancel its finishers that no worker has
        taken, and wait for the rest, so that none of the job's files is
        written after the job has ended.  Once :meth:`drain` has
        returned, there is nothing left to do."""
        for fut, _ in self.sent:
            fut.cancel()
        wait([fut for fut, _ in self.sent])


def finish_subst_query(
    query: Chain,
    rows: np.ndarray,
    subst_lines: List[str],
    f32_scores: np.ndarray,
    out_path: str,
    eps_screen: Optional[float] = None,
    log=sys.stderr,
) -> Dict[str, float]:
    """Complete one subst-mode query from its device f32 score matrix.

    ``rows``: prepared code rows (query as row 0 — predict.prepare_rows).
    ``f32_scores``: (>=L, 26) device scores (padding rows beyond L ignored).
    Output is byte-identical to predict.predict_prepared's by
    construction; a failed screen verification falls back to it.

    Returns its counts (:func:`finish_counts`): the query's ``positions``;
    ``exact_positions``, those re-derived by :func:`sparse_exact_scores`
    in a query that kept the hybrid; ``fallback_positions``, those of a
    query sent whole to ``predict_prepared``.  The caller adds them to its
    metrics: a finisher runs on a writer thread or a pool process, where
    no metrics are added."""
    if eps_screen is None:
        eps_screen = EPS_SCREEN
    L = len(query)
    f32 = np.asarray(f32_scores[:L], dtype=np.float64)

    ref_cells = f32[np.arange(L), query.codes]
    need = np.flatnonzero(ref_cells < TOLERANCE_PROB_THRESHOLD + eps_screen)
    subst_pos = {
        parsed[1] - 1
        for line in subst_lines
        if (parsed := parse_subst_line(line)) is not None
    }
    positions = np.asarray(sorted(set(need.tolist()) | subst_pos), dtype=np.int64)

    total_seq = rows.shape[0]
    raw_matrix, aas_stored = create_matrix(rows, np.ones(total_seq))

    hybrid = f32
    if positions.size:
        exact = sparse_exact_scores(rows, raw_matrix, positions)
        # in-run screen verification (module docstring): beyond-margin f32
        # drift at any exactly-computed row -> the slow-correct oracle
        drift = float(np.nanmax(np.abs(exact - f32[positions])))
        if not drift <= eps_screen / 2:
            print(
                f"* subst f32 screen drift {drift:.2e} at query "
                f"[ {query.name} ]: falling back to the float64 oracle *",
                file=log,
            )
            predict_prepared(query, rows, subst_lines, out_path)
            return finish_counts(L, 0, fallback=True)
        hybrid = f32.copy()
        hybrid[positions] = exact

    median_for_pos = hash_predicted_pos(subst_lines)
    # correctness of using `hybrid` here: any position whose f64 ref cell
    # is < 0.05 has an f32 ref cell < 0.05 + eps (margin), so it is in
    # `positions` and exact; every other position's test compares an f32
    # value known to be >= 0.05 + eps against 0.05 — same outcome
    add_pos_with_del_ref(query, hybrid, median_for_pos)
    add_median_seq_info(rows, median_for_pos)
    write_subst_predictions(
        subst_lines, median_for_pos, hybrid, aas_stored,
        total_seq, query, out_path,
    )
    return finish_counts(L, int(positions.size))

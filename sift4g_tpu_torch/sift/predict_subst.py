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

In the port the device branch of ``pipeline.finish_pipeline`` calls the
finishers here, with the screen from ``scores_torch.py``.  The copy drops
the "stale .so" ``hasattr`` guard around the native weights helper.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

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


def finish_subst_task(payload) -> Dict[str, float]:
    """Process-pool entry for one subst finisher (picklable flat payload;
    used by the pipeline when the subst query count is large — the
    finisher's GIL-held numpy share (~6 ms/query) serializes a THREAD
    pool, measured as ~125 s of the writers' drain at 20k queries).
    Workers import only numpy/scipy modules (no JAX).  Returns the
    finisher's counts, which the pipeline adds on the job's thread."""
    (name, letters, rows, subst_lines, f32_scores, out_path) = payload
    query = Chain.from_string(name, letters)
    return finish_subst_query(query, rows, subst_lines, f32_scores, out_path)


def make_subst_executor(n_subst: int):
    """A spawn ProcessPoolExecutor for the finishers, or None to run them
    inline on the caller's thread pool.  SIFT4G_TPU_SUBST_PROCS forces a
    worker count (0 disables); default: engage from 256 subst queries
    with min(3, cores-1) workers (the parent keeps a core for packing
    and device fetches)."""
    import multiprocessing

    knob = os.environ.get("SIFT4G_TPU_SUBST_PROCS", "")
    if knob:
        try:
            n_procs = int(knob)
        except ValueError:
            raise ValueError(
                f"environment variable SIFT4G_TPU_SUBST_PROCS={knob!r} "
                "is not an integer"
            ) from None
    else:
        if n_subst < 256:
            return None
        try:
            n_cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            n_cores = os.cpu_count() or 1
        n_procs = min(3, max(1, n_cores - 1))
    if n_procs <= 0:
        return None
    from concurrent.futures import ProcessPoolExecutor

    try:
        # spawn, not fork: the parent is multi-threaded (writer pool +
        # JAX runtime threads) when workers start, and a fork could
        # inherit a lock mid-acquisition and deadlock the child.  Worker
        # startup re-imports only numpy/scipy modules (~2.4 s, no JAX) —
        # amortized over hundreds of queries per worker.
        return ProcessPoolExecutor(
            max_workers=n_procs,
            mp_context=multiprocessing.get_context("spawn"),
        )
    except (OSError, ValueError):
        return None


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

"""SIFT scoring math (PSSM + Henikoff weights + Dirichlet mixture).

Vectorized float64 mirror of sift_scores.cpp; each function cites the
reference routine it reproduces.  Rows are (n_seqs, L) uint8 letter codes
('X' = masked, quirk Q6); matrices are (L, 26) float64.

This NumPy version is the bit-accuracy oracle for file output.  The
port's copy drops the "stale .so" ``hasattr`` guard around the native
helper (the port builds its library from the sources it binds).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
from scipy.special import gammaln

from ..constants import (
    AA_FREQUENCY,
    DIRI_ALPHA,
    DIRI_ALTOT,
    DIRI_Q,
    LOG_2_20,
    RANK_MATRIX,
    VALID_AA_MASK,
    get_median,
)

X_CODE = ord("X") - ord("A")

_VALID_F = VALID_AA_MASK.astype(np.float64)


def _onehot_counts(rows: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted per-position letter counts over valid amino acids.

    Mirror of createMatrix (sift_scores.cpp:555-570): matrix[pos][aa] +=
    w[seq] for valid aa; tot_pos_weight likewise.
    Returns (matrix (L,26), tot_pos_weight (L,)).
    """
    n, L = rows.shape
    matrix = np.zeros((L, 26), dtype=np.float64)
    if n and weights.size and np.all(weights == 1.0):
        # weight-1 counts are integers: any summation order is exact
        # (< 2^53), so a bincount scatter replaces the per-letter passes
        valid = VALID_AA_MASK[rows]
        pos = np.broadcast_to(
            np.arange(L, dtype=np.intp)[None, :], rows.shape
        )
        flat = (pos * 26 + rows.astype(np.intp)).ravel()[valid.ravel()]
        matrix += np.bincount(flat, minlength=L * 26).reshape(L, 26)
        tot = matrix.sum(axis=1)
        return matrix, tot
    if n:
        valid = VALID_AA_MASK[rows]  # (n, L)
        w = np.where(valid, weights[:, None], 0.0)  # (n, L)
        # scatter-add per (pos, letter).  Only letters actually present
        # contribute (absent letters sum exact zeros), and the masked
        # per-letter array reuses one scratch buffer; the per-column
        # pairwise summation tree is unchanged, so results stay
        # bit-identical to the unrestricted loop.
        present = np.zeros(32, dtype=bool)
        present[rows.ravel() & 31] = True
        scratch = np.empty_like(w)
        for aa in range(26):
            if not present[aa]:
                continue
            np.multiply(w, rows == aa, out=scratch)
            matrix[:, aa] = scratch.sum(axis=0)
    tot = matrix.sum(axis=1)
    return matrix, tot


def create_matrix(rows: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return _onehot_counts(rows, np.asarray(weights, dtype=np.float64))


def calc_seq_weights(
    rows: np.ndarray, raw_matrix: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Henikoff position-based weights (calcSeqWeights, :453-498).

    Returns (seq_weights (n,), number_of_diff_aas (L,)).
    """
    n, L = rows.shape
    ndiff = ((raw_matrix > 0.0) & VALID_AA_MASK[None, :]).sum(axis=1).astype(np.float64)
    # per row: sum over positions of 1/(ndiff[pos]*raw[pos, aa]) where the
    # row's aa is valid and raw > 0
    pos_idx = np.arange(L)
    counts_at = raw_matrix[pos_idx[None, :], rows]           # (n, L)
    valid = VALID_AA_MASK[rows] & (counts_at > 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        contrib = np.where(valid, 1.0 / (ndiff[None, :] * counts_at), 0.0)
    w = contrib.sum(axis=1)
    tot = w.sum()
    if tot != 0:
        w = w / tot * n
    return w, ndiff


def find_max_aa(matrix: np.ndarray) -> np.ndarray:
    """First-wins argmax per position (find_max_aa_in_matrix, :43-58)."""
    return np.argmax(matrix, axis=1)


def calc_epsilon(
    weighted: np.ndarray, max_aa: np.ndarray, ndiff: np.ndarray
) -> np.ndarray:
    """Rank-based pseudocount scale (calcEpsilon, :60-86)."""
    L = weighted.shape[0]
    ranks = RANK_MATRIX[max_aa]                    # (L, 26)
    wv = weighted * _VALID_F[None, :]
    num = (ranks.astype(np.float64) * wv).sum(axis=1)
    den = wv.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        eps = np.exp(num / den)
    return np.where(ndiff == 1, 0.0, eps)


def _add_logs_fold(log_terms: np.ndarray) -> np.ndarray:
    """Sequential fold of add_logs (:387-393) over axis 0."""
    acc = log_terms[0]
    for j in range(1, log_terms.shape[0]):
        acc = np.logaddexp(acc, log_terms[j])
    return acc


_GAMMALN_ALTOT = gammaln(DIRI_ALTOT)        # (13,) constants
_GAMMALN_ALPHA = gammaln(DIRI_ALPHA)        # (13, 26) constants


def calc_diri(weighted: np.ndarray) -> np.ndarray:
    """13-component Dirichlet-mixture regularizer (calcDiri /
    add_diric_values, :379-451).  weighted: (L, 26) -> (L, 26).

    gammaln (the cost center: ~100k evals/query at 400 rows) is
    evaluated on the UNIQUE count values per column and gathered back —
    near-identical missense MSAs repeat a handful of column
    compositions, so the dedup is large there; values are bit-identical
    (same function, same inputs, same elementwise combine order)."""
    L = weighted.shape[0]
    tot = weighted.sum(axis=1)  # (L,)
    ut, it = np.unique(tot, return_inverse=True)
    # probn[j] over positions: (13, L)
    probn = (
        gammaln(ut + 1.0)[it][None, :]
        + _GAMMALN_ALTOT[:, None]
        - gammaln(ut[None, :] + DIRI_ALTOT[:, None])[:, it]
    )
    # per amino acid terms, valid only
    for aa in range(26):
        if not VALID_AA_MASK[aa]:
            continue
        c = weighted[:, aa]  # (L,)
        alpha = DIRI_ALPHA[:, aa]  # (13,)
        u, inv = np.unique(c, return_inverse=True)
        probn += (
            gammaln(u[None, :] + alpha[:, None])[:, inv]
            - gammaln(u + 1.0)[inv][None, :]
            - _GAMMALN_ALPHA[:, aa][:, None]
        )
    logq = np.log(DIRI_Q)[:, None]  # (13, 1)
    denom = _add_logs_fold(logq + probn)  # (L,)
    probj = logq + probn - denom[None, :]  # (13, L)
    diric = np.einsum("jl,ja->la", np.exp(probj), DIRI_ALPHA)
    diric *= _VALID_F[None, :]
    totreg = diric.sum(axis=1)  # (L,)
    with np.errstate(divide="ignore", invalid="ignore"):
        diric = diric / totreg[:, None]
    return diric


def calc_sift_scores(
    rows: np.ndarray, raw_matrix: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """calcSIFTScores (:324-377).

    rows include the query as row 0.  raw_matrix is the weight-1 count
    matrix (the caller computed it for aas_stored, sift_prediction.cpp:206).
    Returns (SIFTscores (L,26), seq_weights, number_of_diff_aas).
    """
    seq_weights, ndiff = calc_seq_weights(rows, raw_matrix)
    weighted, tot_weights = create_matrix(rows, seq_weights)
    max_aa = find_max_aa(weighted)
    eps = calc_epsilon(weighted, max_aa, ndiff)
    diric = calc_diri(weighted)
    sift = (weighted + eps[:, None] * diric) / (tot_weights + eps)[:, None]
    max_aa2 = find_max_aa(sift)
    L = sift.shape[0]
    sift = sift / sift[np.arange(L), max_aa2][:, None]
    return sift, seq_weights, ndiff


def remove_seqs_identical_to_query(
    query_codes: np.ndarray, names: List[str], rows: np.ndarray, seq_identity: float
) -> Tuple[List[str], np.ndarray]:
    """remove_seqs_percent_identical_to_query (:500-544)."""
    if rows.shape[0] == 0:
        return names, rows
    valid_q = VALID_AA_MASK[query_codes]            # (L,)
    valid_r = VALID_AA_MASK[rows] & (rows != X_CODE)
    both = valid_r & valid_q[None, :]
    seq_total = both.sum(axis=1).astype(np.float64)
    identity = (both & (rows == query_codes[None, :])).sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = identity / seq_total * 100.0
    keep = ~(pct >= seq_identity)  # NaN (0/0) compares False -> kept
    kept_names = [nm for nm, k in zip(names, keep) if k]
    return kept_names, rows[keep]


def basic_matrix_construction(rows: np.ndarray, seq_weights: np.ndarray) -> np.ndarray:
    """basic_matrix_construction (:633-705): frequency-normalized percentage
    matrix with B->D/N and Z->E/Q partitioning."""
    n, L = rows.shape
    freq = AA_FREQUENCY
    iD, iN, iE, iQ, iB, iZ = (ord(c) - ord("A") for c in "DNEQBZ")
    part_D = freq[iD] / (freq[iD] + freq[iN])
    part_N = freq[iN] / (freq[iD] + freq[iN])
    part_E = freq[iE] / (freq[iE] + freq[iQ])
    part_Q = freq[iQ] / (freq[iE] + freq[iQ])

    matrix = np.zeros((L, 26), dtype=np.float64)
    w = seq_weights  # (n,)
    # per-letter scan with precomputed presence + reused scratch: this is
    # the subst-mode hybrid's host cost center (one full call per distinct
    # keep mask, add_median_seq_info).  w * mask (0.0/1.0) equals the
    # previous np.where(sel, w, 0.0) bit-for-bit (w is finite >= 0), and
    # the per-column pairwise sum tree is unchanged, so results are
    # bit-identical.
    present = np.bincount(rows.ravel() & 31, minlength=32) > 0
    wcol = w[:, None]
    sel = np.empty(rows.shape, dtype=bool)
    scratch = np.empty(rows.shape, dtype=np.float64)
    for aa in range(26):
        if not present[aa]:
            continue
        np.equal(rows, aa, out=sel)
        np.multiply(wcol, sel, out=scratch)
        contrib = scratch.sum(axis=0)  # (L,)
        if aa == iB:
            matrix[:, iD] += part_D * contrib / freq[iD]
            matrix[:, iN] += part_N * contrib / freq[iN]
        elif aa == iZ:
            matrix[:, iE] += part_E * contrib / freq[iE]
            matrix[:, iQ] += part_Q * contrib / freq[iQ]
        elif aa != X_CODE and freq[aa] != 0.0:
            matrix[:, aa] += contrib / freq[aa]
    total = matrix.sum(axis=1)  # (L,)
    with np.errstate(divide="ignore", invalid="ignore"):
        matrix = matrix * 100.0 / total[:, None]
    matrix[:, iB] = matrix[:, iD] * part_D + matrix[:, iN] * part_N
    matrix[:, iZ] = matrix[:, iE] * part_E + matrix[:, iQ] * part_Q
    return matrix


def calculate_median_seq_info(matrix: np.ndarray) -> float:
    """calculateMedianSeqInfo (:151-200): median over positions of column
    information r + log2(20), float32 storage (quirk Q9) and the get_median
    sort quirk (Q1)."""
    L = matrix.shape[0]
    wv = matrix * _VALID_F[None, :]
    total = wv.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        tmp = wv / total[:, None]
        contrib = np.where((tmp > 0.0) & VALID_AA_MASK[None, :], tmp * np.log(tmp), 0.0)
    r = contrib.sum(axis=1) / np.log(2.0)
    pos_freq = (r + LOG_2_20).astype(np.float32)
    return float(get_median(pos_freq, L))


def _basic_matrix_native(rows: np.ndarray, keep: np.ndarray):
    """native/median.cpp sift4g_basic_matrix: the counts -> Henikoff
    weights -> percentage-matrix tree for one X-free row subset, bitwise
    equal to the numpy pipeline (it replicates numpy's pairwise/sequential
    reduction orders; fuzz-locked in tests).  The log/median tail stays
    in numpy — np.log's vectorized kernel differs from libm in the last
    ulp.  Returns the (L, 26) matrix or None (no native library)."""
    from .. import native

    lib = native.load()
    if lib is None:
        return None
    import ctypes

    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    keep_idx = np.ascontiguousarray(keep, dtype=np.int64)
    out = np.empty((rows.shape[1], 26), dtype=np.float64)
    valid_u8 = np.ascontiguousarray(VALID_AA_MASK, dtype=np.uint8)
    freq = np.ascontiguousarray(AA_FREQUENCY, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.sift4g_basic_matrix(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        keep_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        keep_idx.shape[0], rows.shape[1],
        freq.ctypes.data_as(dp),
        valid_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(dp),
    )
    return out


def add_median_seq_info(
    rows: np.ndarray, median_for_pos: Dict[str, float]
) -> None:
    """addMedianSeqInfo (:101-149): fill -1 entries of median_for_pos with
    the median sequence info of the X-free sub-alignment at that position.
    ``rows`` include the query row.

    The result depends on the position only through its X-free row SUBSET,
    and conserved cores share the all-rows-valid mask, so the full
    count/weights/percentage/median recomputation (the reference's
    per-position rescan, sift_scores.cpp:120-147) is memoized per distinct
    keep mask — bit-identical, since identical subsets run the identical
    arithmetic.  The arithmetic tree itself runs in C++ when available
    (_basic_matrix_native, ~15x at missense shape — the subst-mode
    hybrid's host cost center); the numpy pipeline below is the fallback
    and the parity oracle."""
    cache: Dict[bytes, float] = {}
    for key, value in list(median_for_pos.items()):
        if value != -1:
            continue
        pos = int(key) - 1
        keep = VALID_AA_MASK[rows[:, pos]]
        ck = keep.tobytes()
        hit = cache.get(ck)
        if hit is not None:
            median_for_pos[key] = hit
            continue
        if not keep.any():
            median_for_pos[key] = cache.setdefault(ck, 0.0)
            continue
        basic = _basic_matrix_native(rows, np.flatnonzero(keep))
        if basic is None:
            sub = rows[keep]
            raw, _ = create_matrix(sub, np.ones(sub.shape[0]))
            seq_weights, _ = calc_seq_weights(sub, raw)
            basic = basic_matrix_construction(sub, seq_weights)
        result = calculate_median_seq_info(basic)
        cache[ck] = result
        median_for_pos[key] = result

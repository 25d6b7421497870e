"""Karlin-Altschul E-value statistics.

The reference delegates E-values to swsharp (``createEValueParams(cells,
scorer)`` main.cpp:210; ``eValues(...)`` via the valueFunction callback,
database_alignment.cpp:129-134) whose implementation is absent from the
snapshot.  This module re-derives the statistics from first principles the
way BLAST does:

* **Gapped parameters** (lambda, K, H, alpha, beta) come from the published
  NCBI BLAST tables for (matrix, gap) combinations.  Gap-cost convention:
  this framework charges ``gap_open`` for the first gapped residue and
  ``gap_extend`` thereafter (cost(L) = open + (L-1)*ext), which equals
  NCBI's ``(open-ext, ext)`` entry (NCBI charges O + L*E).
* **Ungapped fallback**: when no table entry matches, lambda/K/H are
  computed numerically from the score matrix and background residue
  frequencies (Robinson&Robinson) — Newton solve for lambda, convolution
  series for K (Karlin & Altschul 1990; NCBI BlastKarlinLHtoK structure).
* **Length adjustment** follows BLAST_ComputeLengthAdjustment (iterative),
  with the database treated as a single concatenated sequence of
  ``total_cells`` residues (the reference's EValueParams carries only the
  total cell count, database_search.cpp:126,182).

E = K * m' * n' * exp(-lambda * score), m' = max(m - ell, 1),
n' = max(n - ell, 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..constants import AA_FREQUENCY
from .scorers import Scorer

# Published NCBI gapped Karlin-Altschul parameters, keyed by
# (matrix, ncbi_gap_open, ncbi_gap_extend) -> (lambda, K, H, alpha, beta).
# Transcribed from NCBI blast_stat.c (public data): every gap setting NCBI
# supports for BLOSUM_45/50/62/80/90 and PAM_250 (= this framework's
# BLOSUM_250).  Zero-egress transcription caveat as in core/scorers.py.
_GAPPED: Dict[Tuple[str, int, int], Tuple[float, float, float, float, float]] = {
    ("BLOSUM_62", 11, 2): (0.297, 0.082, 0.27, 1.1, -10),
    ("BLOSUM_62", 10, 2): (0.291, 0.075, 0.23, 1.3, -15),
    ("BLOSUM_62", 9, 2): (0.279, 0.058, 0.19, 1.5, -19),
    ("BLOSUM_62", 8, 2): (0.264, 0.045, 0.15, 1.8, -26),
    ("BLOSUM_62", 7, 2): (0.239, 0.027, 0.10, 2.5, -46),
    ("BLOSUM_62", 6, 2): (0.201, 0.012, 0.061, 3.3, -58),
    ("BLOSUM_62", 13, 1): (0.292, 0.071, 0.23, 1.2, -11),
    ("BLOSUM_62", 12, 1): (0.283, 0.059, 0.19, 1.5, -19),
    ("BLOSUM_62", 11, 1): (0.267, 0.041, 0.14, 1.9, -30),
    ("BLOSUM_62", 10, 1): (0.243, 0.024, 0.10, 2.5, -44),
    ("BLOSUM_62", 9, 1): (0.206, 0.010, 0.052, 4.0, -87),
    ("BLOSUM_45", 13, 3): (0.207, 0.049, 0.14, 1.5, -22),
    ("BLOSUM_45", 12, 3): (0.199, 0.039, 0.11, 1.8, -34),
    ("BLOSUM_45", 11, 3): (0.190, 0.031, 0.095, 2.0, -38),
    ("BLOSUM_45", 10, 3): (0.179, 0.023, 0.075, 2.4, -51),
    ("BLOSUM_45", 15, 2): (0.203, 0.041, 0.12, 1.7, -31),
    ("BLOSUM_45", 14, 2): (0.195, 0.032, 0.10, 1.9, -36),
    ("BLOSUM_45", 13, 2): (0.185, 0.024, 0.084, 2.2, -45),
    ("BLOSUM_45", 12, 2): (0.171, 0.016, 0.061, 2.8, -65),
    ("BLOSUM_45", 19, 1): (0.205, 0.040, 0.11, 1.9, -43),
    ("BLOSUM_45", 18, 1): (0.198, 0.032, 0.10, 2.0, -43),
    ("BLOSUM_45", 17, 1): (0.189, 0.024, 0.079, 2.4, -57),
    ("BLOSUM_45", 16, 1): (0.176, 0.016, 0.063, 2.8, -67),
    ("BLOSUM_80", 25, 2): (0.342, 0.17, 0.66, 0.52, -1.6),
    ("BLOSUM_80", 13, 2): (0.336, 0.15, 0.57, 0.59, -3),
    ("BLOSUM_80", 9, 2): (0.319, 0.11, 0.42, 0.76, -6),
    ("BLOSUM_80", 8, 2): (0.308, 0.090, 0.35, 0.89, -9),
    ("BLOSUM_80", 7, 2): (0.293, 0.070, 0.27, 1.1, -14),
    ("BLOSUM_80", 11, 1): (0.314, 0.095, 0.35, 0.90, -9),
    ("BLOSUM_80", 10, 1): (0.299, 0.071, 0.27, 1.1, -14),
    ("BLOSUM_80", 9, 1): (0.279, 0.048, 0.20, 1.4, -19),
    ("BLOSUM_50", 13, 3): (0.212, 0.063, 0.19, 1.1, -16),
    ("BLOSUM_50", 12, 3): (0.206, 0.055, 0.17, 1.2, -18),
    ("BLOSUM_50", 11, 3): (0.197, 0.042, 0.14, 1.4, -25),
    ("BLOSUM_50", 10, 3): (0.186, 0.031, 0.11, 1.7, -34),
    ("BLOSUM_50", 9, 3): (0.172, 0.022, 0.082, 2.1, -48),
    ("BLOSUM_50", 16, 2): (0.215, 0.066, 0.20, 1.05, -15),
    ("BLOSUM_50", 15, 2): (0.210, 0.058, 0.17, 1.2, -20),
    ("BLOSUM_50", 14, 2): (0.202, 0.045, 0.14, 1.4, -27),
    ("BLOSUM_50", 13, 2): (0.193, 0.035, 0.12, 1.6, -32),
    ("BLOSUM_50", 12, 2): (0.181, 0.025, 0.095, 1.9, -41),
    ("BLOSUM_50", 19, 1): (0.212, 0.057, 0.18, 1.2, -21),
    ("BLOSUM_50", 18, 1): (0.207, 0.050, 0.15, 1.4, -28),
    ("BLOSUM_50", 17, 1): (0.198, 0.037, 0.12, 1.6, -33),
    ("BLOSUM_50", 16, 1): (0.186, 0.025, 0.10, 1.9, -42),
    ("BLOSUM_90", 9, 2): (0.310, 0.12, 0.46, 0.67, -3),
    ("BLOSUM_90", 8, 2): (0.300, 0.099, 0.39, 0.76, -5),
    ("BLOSUM_90", 7, 2): (0.283, 0.072, 0.30, 0.93, -8),
    ("BLOSUM_90", 6, 2): (0.259, 0.048, 0.22, 1.2, -16),
    ("BLOSUM_90", 11, 1): (0.302, 0.093, 0.39, 0.78, -5),
    ("BLOSUM_90", 10, 1): (0.290, 0.075, 0.28, 1.04, -8),
    ("BLOSUM_90", 9, 1): (0.265, 0.044, 0.20, 1.3, -19),
    ("PAM_250", 15, 3): (0.205, 0.049, 0.13, 1.6, -23),
    ("PAM_250", 14, 3): (0.200, 0.043, 0.12, 1.7, -26),
    ("PAM_250", 13, 3): (0.194, 0.036, 0.10, 1.9, -31),
    ("PAM_250", 12, 3): (0.186, 0.029, 0.085, 2.2, -41),
    ("PAM_250", 11, 3): (0.174, 0.020, 0.070, 2.5, -48),
    ("PAM_250", 17, 2): (0.204, 0.047, 0.12, 1.7, -28),
    ("PAM_250", 16, 2): (0.198, 0.038, 0.11, 1.8, -29),
    ("PAM_250", 15, 2): (0.191, 0.031, 0.087, 2.2, -44),
    ("PAM_250", 14, 2): (0.182, 0.024, 0.073, 2.5, -53),
    ("PAM_250", 13, 2): (0.171, 0.017, 0.059, 2.9, -64),
    ("PAM_250", 21, 1): (0.205, 0.045, 0.11, 1.8, -34),
    ("PAM_250", 20, 1): (0.199, 0.037, 0.10, 1.9, -35),
    ("PAM_250", 19, 1): (0.192, 0.029, 0.083, 2.3, -52),
    ("PAM_250", 18, 1): (0.183, 0.021, 0.070, 2.6, -60),
    ("PAM_250", 17, 1): (0.171, 0.014, 0.052, 3.3, -86),
}
# NCBI BLAST ships no gapped parameters for BLOSUM_30/BLOSUM_70 at any gap
# cost (blast_stat.c has no blosum30/70 tables): those matrices always take
# the computed-ungapped path below, with a loud warning.


@dataclass
class EValueParams:
    lam: float
    K: float
    H: float
    alpha: float
    beta: float
    total_cells: int
    gapped: bool

    @property
    def log_k(self) -> float:
        return math.log(self.K)


def _ungapped_lambda(matrix: np.ndarray, freqs: np.ndarray) -> float:
    """Newton solve of sum p_i p_j exp(lambda * s_ij) = 1."""
    p = freqs / freqs.sum()
    nz = p > 0
    pp = np.outer(p[nz], p[nz])
    s = matrix[np.ix_(nz, nz)].astype(np.float64)
    lam = 0.5
    for _ in range(200):
        e = np.exp(lam * s)
        f = float((pp * e).sum()) - 1.0
        fp = float((pp * s * e).sum())
        step = f / fp
        lam -= step
        if abs(step) < 1e-12:
            break
        lam = max(lam, 1e-6)
    return lam


def _ungapped_entropy(matrix: np.ndarray, freqs: np.ndarray, lam: float) -> float:
    p = freqs / freqs.sum()
    nz = p > 0
    pp = np.outer(p[nz], p[nz])
    s = matrix[np.ix_(nz, nz)].astype(np.float64)
    q = pp * np.exp(lam * s)
    return float((q * s).sum()) * lam


def _ungapped_k(matrix: np.ndarray, freqs: np.ndarray, lam: float, H: float) -> float:
    """K via the Karlin-Altschul 1990 convolution series (the structure of
    NCBI BlastKarlinLHtoK), on the integer score distribution."""
    p = freqs / freqs.sum()
    nz = p > 0
    pp = np.outer(p[nz], p[nz]).ravel()
    s = matrix[np.ix_(nz, nz)].astype(np.int64).ravel()
    low, high = int(s.min()), int(s.max())
    if low >= 0:
        return 1.0  # degenerate
    # score pmf
    size = high - low + 1
    pmf = np.zeros(size)
    for sc, pr in zip(s.tolist(), pp.tolist()):
        pmf[sc - low] += pr
    # gcd of scores with nonzero probability
    delta = 0
    for sc in range(low, high + 1):
        if pmf[sc - low] > 0:
            delta = math.gcd(delta, abs(sc)) if sc != 0 else delta
    delta = max(delta, 1)
    # sigma = sum_{j>=1} (1/j) [ sum_{x<0} Pj(x) e^{lambda x} + sum_{x>=0} Pj(x) ]
    iterations = 60
    sigma = 0.0
    conv = np.zeros(1)
    conv[0] = 1.0
    offset = 0  # conv[k] = P(walk sum == offset + k)
    for j in range(1, iterations + 1):
        conv = np.convolve(conv, pmf)
        offset += low
        xs = offset + np.arange(conv.shape[0])
        neg = xs < 0
        term = float((conv[neg] * np.exp(lam * xs[neg])).sum() + conv[~neg].sum())
        sigma += term / j
    return float(lam * delta / (H * (1.0 - math.exp(-lam * delta))) * math.exp(-2.0 * sigma))


def create_evalue_params(
    total_cells: int, scorer: Scorer, log=None
) -> EValueParams:
    """Mirror of createEValueParams (main.cpp:210).

    Falls back to computed ungapped statistics when no published gapped
    (lambda, K) row exists for (matrix, gap costs) — loudly: ungapped
    parameters make E-values conservative (smaller), which can change
    which alignments pass the --evalue filter vs BLAST-style tools.
    """
    key = (scorer.name, scorer.gap_open - scorer.gap_extend, scorer.gap_extend)
    if key in _GAPPED:
        lam, K, H, alpha, beta = _GAPPED[key]
        return EValueParams(lam, K, H, alpha, beta, total_cells, gapped=True)
    import sys

    print(
        f"WARNING: no published gapped Karlin-Altschul parameters for "
        f"{scorer.name} with gap open {scorer.gap_open} / extend "
        f"{scorer.gap_extend}; using ungapped statistics computed from the "
        f"matrix — E-value filtering may differ from gapped-BLAST behaviour",
        file=log if log is not None else sys.stderr,
    )
    lam = _ungapped_lambda(scorer.matrix, AA_FREQUENCY)
    H = _ungapped_entropy(scorer.matrix, AA_FREQUENCY, lam)
    K = _ungapped_k(scorer.matrix, AA_FREQUENCY, lam, H)
    alpha = lam / H if H > 0 else 0.0
    return EValueParams(lam, K, H, alpha, beta=0.0, total_cells=total_cells, gapped=False)


def length_adjustment(params: EValueParams, query_len: int) -> int:
    """BLAST_ComputeLengthAdjustment (iterative), N = 1 subject."""
    m = float(query_len)
    n = float(params.total_cells)
    if params.K <= 0 or m <= 0 or n <= 0:
        return 0
    logk = params.log_k
    a_div_lam = params.alpha / params.lam
    beta = params.beta
    ell = 0.0
    for _ in range(20):
        space = (m - ell) * (n - ell)
        if space <= 0:
            break
        ell_new = a_div_lam * (logk + math.log(space)) + beta
        ell_new = max(ell_new, 0.0)
        ell_max = min(m, n) * 0.5
        ell_new = min(ell_new, ell_max)
        if abs(ell_new - ell) < 1.0:
            ell = ell_new
            break
        ell = ell_new
    return int(ell)


def evalues(scores: np.ndarray, query_len: int, params: EValueParams) -> np.ndarray:
    """E-values for an array of alignment scores of one query
    (mirror of swsharp eValues as called at database_alignment.cpp:133)."""
    ell = length_adjustment(params, query_len)
    m = max(query_len - ell, 1)
    n = max(params.total_cells - ell, 1)
    s = np.asarray(scores, dtype=np.float64)
    return params.K * m * n * np.exp(-params.lam * s)


def min_passing_score(
    max_evalue: float, query_len: int, params: EValueParams
) -> "int | None":
    """Smallest integer score whose E-value passes ``<= max_evalue`` —
    the exact inverse of :func:`evalues` (E = Kmn·exp(-λs) is strictly
    decreasing in s), stepped to the integer boundary through the same
    float path the filter uses so device-side integer screening
    (``score >= min_passing_score``) keeps EXACTLY the set
    ``evalues(score) <= max_evalue`` keeps.  Returns None when the
    statistics cannot invert (λ <= 0) — callers then skip screening.
    Mirrors the E-value filter inside swsharp's alignDatabase
    (reference database_alignment.cpp:83-86,129-134)."""
    if params.lam <= 0 or params.K <= 0 or max_evalue <= 0:
        return None
    ell = length_adjustment(params, query_len)
    m = max(query_len - ell, 1)
    n = max(params.total_cells - ell, 1)
    raw = math.log(params.K * m * n / max_evalue) / params.lam
    s = max(int(math.ceil(raw)), 0)
    # float-rounding guard: agree bit-for-bit with evalues()
    while s > 0 and float(
        evalues(np.array([s - 1]), query_len, params)[0]
    ) <= max_evalue:
        s -= 1
    while float(evalues(np.array([s]), query_len, params)[0]) > max_evalue:
        s += 1
    return s

"""Karlin-Altschul E-values of the plain reference, frozen at commit eca6a4da.

A copy of ``length_adjustment``, ``evalues`` and ``min_passing_score`` from
``sift4g_tpu_torch/core/evalue.py`` for the gapped statistics only (the
configurations use BLOSUM62 at gaps 10/1, which has NCBI's published row):
E = K m' n' exp(-lambda s), m' = max(m - ell, 1), n' = max(n - ell, 1), with
the database taken as one sequence of all its residues.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class EValueParams:
    lam: float
    K: float
    H: float
    alpha: float
    beta: float
    total_cells: int


def length_adjustment(p: EValueParams, query_len: int) -> int:
    """BLAST_ComputeLengthAdjustment (iterative), one subject."""
    m, n = float(query_len), float(p.total_cells)
    if p.K <= 0 or m <= 0 or n <= 0:
        return 0
    logk = math.log(p.K)
    a_div_lam = p.alpha / p.lam
    ell = 0.0
    for _ in range(20):
        space = (m - ell) * (n - ell)
        if space <= 0:
            break
        ell_new = max(a_div_lam * (logk + math.log(space)) + p.beta, 0.0)
        ell_new = min(ell_new, min(m, n) * 0.5)
        if abs(ell_new - ell) < 1.0:
            ell = ell_new
            break
        ell = ell_new
    return int(ell)


def evalues(scores, query_len: int, p: EValueParams) -> np.ndarray:
    ell = length_adjustment(p, query_len)
    m = max(query_len - ell, 1)
    n = max(p.total_cells - ell, 1)
    return p.K * m * n * np.exp(-p.lam * np.asarray(scores, dtype=np.float64))


def min_passing_score(max_evalue: float, query_len: int, p: EValueParams) -> int:
    """The least integer score whose E-value is <= ``max_evalue``, stepped
    through the same float path as :func:`evalues`."""
    ell = length_adjustment(p, query_len)
    m = max(query_len - ell, 1)
    n = max(p.total_cells - ell, 1)
    s = max(int(math.ceil(math.log(p.K * m * n / max_evalue) / p.lam)), 0)
    while s > 0 and float(evalues(np.array([s - 1]), query_len, p)[0]) <= max_evalue:
        s -= 1
    while float(evalues(np.array([s]), query_len, p)[0]) > max_evalue:
        s += 1
    return s

"""SIFT scoring math in float32 PyTorch, batched over queries (device
predict).

The counterpart of ``sift4g_tpu/sift/scores_jax.py``, itself a mirror of
the float64 oracle in ``scores.py`` (reference sift_scores.cpp).  Every
function takes a leading query axis where the JAX module uses
``jax.vmap``: ``rows`` is ``(Q, n, L)`` integer codes, the matrices are
``(Q, L, 26)``.  The tensors' device decides where the math runs: a CUDA
tensor on the card, a CPU tensor on the CPU (the tests).

Numerics: float32.  Agreement with the float64 oracle is held to the
reference's own tolerance (rtol 2e-3, atol 2e-4, ``tests/test_sift_jax.py``);
the file writers of subst mode keep using the oracle through the hybrid
of ``predict_subst.py``.

Where the JAX module multiplies by a one-hot to avoid gathers (slow on
the TPU's scalar core), this module gathers when the product has one
nonzero term, so the value is the same exactly: the per-row counts at a
letter (``raw[l, rows[s, l]]``) and the rank row of the most frequent
letter.  The sums are reductions with a fixed order, never atomics
(``torch.sum``, ``torch.logsumexp``), so two runs on the same card give
the same bits.  The weighted count matrix is the one-hot scaled in place
by the row weights and summed over the rows: the JAX module's einsum,
without a matrix product.  A float32 product through cuBLAS would follow
the process's TF32 setting (a 10-bit mantissa, which breaks the
tolerance), and PyTorch's legacy and per-backend TF32 switches cannot
both be saved and restored around a call (torch 2.11 raises once they
are mixed); a product without cuBLAS is full float32 whatever they say.

Padding: ``'X'`` is an invalid letter (valid_amino_acid,
sift_scores.cpp:316-322), so all-``'X'`` pad rows and pad positions add
nothing to the counts or weights; ``n_valid`` carries the real row count
for the Henikoff normalisation.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..constants import DIRI_ALPHA, DIRI_ALTOT, DIRI_Q, RANK_MATRIX, VALID_AA_MASK

X_CODE = ord("X") - ord("A")

_CONSTS: dict = {}
_CONSTS_LOCK = threading.Lock()


def _consts(device: torch.device) -> dict:
    """The float32 constant tables on ``device`` (built once per device)."""
    key = str(device)
    with _CONSTS_LOCK:
        c = _CONSTS.get(key)
        if c is None:
            def f32(a):
                return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

            valid = f32(VALID_AA_MASK)
            alpha = f32(DIRI_ALPHA)
            c = {
                "valid": valid,
                # row a: the one-hot of letter a, zero for an invalid letter
                "onehot": f32(np.eye(26)) * valid[:, None],
                "rank": f32(RANK_MATRIX),
                "alpha": alpha,
                "alpha_safe": torch.where(valid[None, :] > 0, alpha, torch.ones_like(alpha)),
                "altot": f32(DIRI_ALTOT),
                "logq": torch.log(f32(DIRI_Q)),
            }
            _CONSTS[key] = c
    return c


def _onehot_valid(rows: torch.Tensor) -> torch.Tensor:
    """(Q, n, L) codes -> (Q, n, L, 26) one-hot over valid amino acids only."""
    return _consts(rows.device)["onehot"][rows.long()]


def create_matrix(oh: torch.Tensor, weights: torch.Tensor):
    """Weighted count matrix (createMatrix, sift_scores.cpp:555-570).

    oh (Q, n, L, 26) from :func:`_onehot_valid`, consumed: it is scaled in
    place, so the product takes no second (Q, n, L, 26) tensor; weights
    (Q, n) -> (matrix (Q, L, 26), tot (Q, L))."""
    matrix = oh.mul_(weights.to(oh.dtype)[:, :, None, None]).sum(dim=1)
    return matrix, matrix.sum(dim=2)


def calc_seq_weights(rows: torch.Tensor, raw_matrix: torch.Tensor, n_valid=None):
    """Henikoff position-based weights (calcSeqWeights, :453-498).

    rows (Q, n, L); raw_matrix (Q, L, 26) -> (weights (Q, n), ndiff (Q, L)).
    ``n_valid`` (Q,) is the number of REAL rows per query: padding rows
    (all-'X') earn zero weight on their own, but the reference normalises
    the weights to sum to the sequence count, which must exclude them."""
    c = _consts(rows.device)
    Q, n, L = rows.shape
    idx = rows.long()
    ndiff = ((raw_matrix > 0.0) & (c["valid"] > 0)).sum(dim=2).to(torch.float32)
    # raw[l, rows[s, l]], zero at an invalid letter: the JAX module's
    # one-hot product has this one nonzero term, so the gather is exact
    counts_at = torch.gather(raw_matrix[:, None].expand(Q, n, L, 26), 3, idx[..., None])[..., 0]
    counts_at = counts_at * c["valid"][idx]
    ok = counts_at > 0.0
    denom = torch.where(ok, ndiff[:, None, :] * counts_at, torch.ones_like(counts_at))
    w = torch.where(ok, 1.0 / denom, torch.zeros_like(denom)).sum(dim=2)
    tot = w.sum(dim=1, keepdim=True)
    if n_valid is None:
        n_eff = torch.full_like(tot, float(n))
    else:
        n_eff = torch.as_tensor(n_valid, device=rows.device).to(torch.float32).reshape(Q, 1)
    return torch.where(tot != 0, w / tot * n_eff, w), ndiff


def calc_epsilon(weighted: torch.Tensor, max_aa: torch.Tensor, ndiff: torch.Tensor):
    """Rank-based pseudocount scale (calcEpsilon, :60-86).

    max_aa (Q, L): the most frequent letter per position (the JAX module
    passes its one-hot; the rank row is gathered here)."""
    c = _consts(weighted.device)
    ranks = c["rank"][max_aa]                          # (Q, L, 26)
    wv = weighted * c["valid"]
    num = (ranks * wv).sum(dim=2)
    den = wv.sum(dim=2)
    eps = torch.exp(num / torch.where(den == 0, torch.ones_like(den), den))
    return torch.where(ndiff == 1, torch.zeros_like(eps), eps)


def calc_diri(weighted: torch.Tensor) -> torch.Tensor:
    """13-component Dirichlet-mixture regularizer (calcDiri, :379-451).
    weighted (Q, L, 26) -> (Q, L, 26)."""
    c = _consts(weighted.device)
    validf, alpha, altot, logq = c["valid"], c["alpha"], c["altot"], c["logq"]
    lg = torch.lgamma
    wv = weighted * validf                              # (Q, L, 26)
    tot = wv.sum(dim=2)                                 # (Q, L)
    probn = (
        lg(tot + 1.0)[:, None, :]
        + lg(altot)[None, :, None]
        - lg(tot[:, None, :] + altot[None, :, None])
    )                                                   # (Q, 13, L)
    # per-letter terms over valid letters; alpha is 1.0 at invalid letters
    # (alpha_safe) because lgamma(0) = inf would turn inf * 0 into NaN
    a_safe = c["alpha_safe"]
    term = (
        lg(wv[:, None] + a_safe[None, :, None, :])
        - lg(wv + 1.0)[:, None]
        - lg(a_safe)[None, :, None, :]
    )                                                   # (Q, 13, L, 26)
    probn = probn + (term * validf).sum(dim=3)
    del term
    denom = torch.logsumexp(logq[None, :, None] + probn, dim=1)        # (Q, L)
    probj = torch.exp(logq[None, :, None] + probn - denom[:, None, :])  # (Q, 13, L)
    diric = (probj[..., None] * alpha[None, :, None, :]).sum(dim=1) * validf
    totreg = diric.sum(dim=2)
    return diric / torch.where(totreg == 0, torch.ones_like(totreg), totreg)[..., None]


def calc_sift_scores(rows: torch.Tensor, raw_matrix: torch.Tensor, n_valid=None, oh=None):
    """calcSIFTScores (:324-377): rows (Q, n, L) include the query as row 0;
    ``oh``: their :func:`_onehot_valid`, when the caller has it (consumed).

    Returns (SIFT scores (Q, L, 26), seq_weights (Q, n), ndiff (Q, L))."""
    seq_weights, ndiff = calc_seq_weights(rows, raw_matrix, n_valid)
    if oh is None:
        oh = _onehot_valid(rows)
    weighted, tot_weights = create_matrix(oh, seq_weights)
    del oh
    # torch.argmax returns the first maximum, as numpy and jnp do
    eps = calc_epsilon(weighted, torch.argmax(weighted, dim=2), ndiff)
    diric = calc_diri(weighted)
    sift = (weighted + eps[..., None] * diric) / (tot_weights + eps)[..., None]
    row_max = sift.amax(dim=2)
    sift = sift / torch.where(row_max == 0, torch.ones_like(row_max), row_max)[..., None]
    return sift, seq_weights, ndiff


def sift_scores_from_rows_batch(rows: torch.Tensor, n_valid: Optional[torch.Tensor] = None):
    """The batched full-matrix prediction entry: rows (Q, n_pad, L_pad)
    codes ('X' both as row padding and position padding), n_valid (Q,)
    real rows -> SIFT scores (Q, L_pad, 26), float32, on rows' device."""
    oh = _onehot_valid(rows)
    # weight-1 counts are integers, exact in float32 in any order
    raw = oh.sum(dim=1)
    sift, _, _ = calc_sift_scores(rows, raw, n_valid, oh)
    return sift


def sift_scores_from_rows(rows: torch.Tensor, n_valid) -> torch.Tensor:
    """One query: rows (n_pad, L_pad), n_valid real rows -> (L_pad, 26)."""
    nv = torch.as_tensor([int(n_valid)], dtype=torch.int32, device=rows.device)
    return sift_scores_from_rows_batch(rows[None], nv)[0]

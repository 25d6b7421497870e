"""The plain reference downstream of the alignments: alignment strings,
selection, SIFT scores and the .SIFTprediction text.

Frozen at commit eca6a4da from the NumPy paths of the program's host
predict: ``sift/select.py`` (the move replay and the blocked float32
selection), ``sift/scores.py`` and ``sift/predict.py`` (float64 SIFT math),
``io/writers.py`` (the two file formats) and ``constants.get_median``; the
native fast paths are left out.  ``benchmark/tests/second_oracle.py``,
the scalar transcription of the C++ (reference select_alignments.cpp,
sift_scores.cpp, sift_prediction.cpp), holds this copy in the benchmark's
tests.  ``lower`` is the control: every float one step below what SIFT4G
states, the float64 SIFT math in float32 and the float32 selection in
bfloat16.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
from scipy.special import gammaln

from .sw import MOVE_DIAG, MOVE_LEFT, MOVE_UP
from .tables import (
    AA_FREQUENCY,
    ADEQUATE_SEQ_INFO,
    DIRI_ALPHA,
    DIRI_ALTOT,
    DIRI_Q,
    LOG_2_20,
    MAX_SEQUENCES,
    RANK_MATRIX,
    TOLERANCE_PROB_THRESHOLD,
    VALID_AA_MASK,
)

X_CODE = ord("X") - ord("A")
SUBST_RE = re.compile(r"^([A-Z])([0-9]+)([A-Z])")
_SKIP_COLS = (9, 14, 20)  # J, O, U
_KEEP_COLS = [c for c in range(26) if c not in _SKIP_COLS]
MATRIX_HEADER = (
    "ID   UNK_ID; MATRIX\nAC   UNK_AC\nDE   UNK_DE\nMA   UNK_BL\n "
    + "".join(f" {chr(c + ord('A'))}  " for c in _KEEP_COLS)
    + " *   -\n"
)
_MATRIX_LINE_FMT = " %6.4f " * len(_KEEP_COLS) + " 0.0000  0.0000\n"


def get_median(a: np.ndarray, length: int):
    """constants.hpp:77-86: only a[:length - 1] is sorted (quirk Q1)."""
    b = np.asarray(a)[:length].copy()
    b[: length - 1] = np.sort(b[: length - 1], kind="stable")
    if length % 2 == 0:
        return np.float32((b[length // 2 - 1] + b[length // 2]) / 2.0)
    return b[length // 2]


# ------------------------------------------------------------ selection

def alignment_rows(query_len: int, records) -> np.ndarray:
    """alignmentsExtract + aligmentStr: (n, L) letter codes, 'X' outside
    the alignment and at target gaps, target insertions dropped (Q6).
    ``records``: (query_start, target_start, moves, target_codes)."""
    n = len(records)
    rows = np.full((n, query_len), X_CODE, dtype=np.uint8)
    if n == 0:
        return rows
    mlens = np.array([r[2].shape[0] for r in records], dtype=np.int64)
    total = int(mlens.sum())
    if total == 0:
        return rows
    moves = np.concatenate([r[2] for r in records])
    tcodes = np.concatenate([np.asarray(r[3], dtype=np.uint8) for r in records])
    tlens = np.array([len(r[3]) for r in records], dtype=np.int64)
    rec_starts = np.minimum(np.concatenate(([0], np.cumsum(mlens)[:-1])), total - 1)
    rec_of = np.repeat(np.arange(n, dtype=np.int64), mlens)
    q0 = np.array([r[0] for r in records], dtype=np.int64)
    t0 = np.array([r[1] for r in records], dtype=np.int64)
    t_base = np.cumsum(tlens) - tlens
    adv_q = moves != MOVE_LEFT
    adv_t = moves != MOVE_UP
    cq = np.cumsum(adv_q)
    ct = np.cumsum(adv_t)
    cq0 = (cq[rec_starts] - adv_q[rec_starts])[rec_of]
    ct0 = (ct[rec_starts] - adv_t[rec_starts])[rec_of]
    qpos = q0[rec_of] + (cq - cq0) - adv_q
    tpos = t0[rec_of] + (ct - ct0) - adv_t
    diag = moves == MOVE_DIAG
    rows[rec_of[diag], qpos[diag]] = tcodes[(t_base[rec_of] + tpos)[diag]]
    return rows


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), kept in
    float32."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def alignments_select(rows: np.ndarray, threshold: float, lower: bool = False) -> int:
    """alignmentsSelect (select_alignments.cpp:183-242): the first prefix
    whose median column entropy (+ log2 20, float32, Q9) is <= threshold.
    ``lower``: every float32 value rounded to bfloat16 (the control)."""
    rnd = _bf16 if lower else (lambda a: a)
    n, L = rows.shape
    if n == 0:
        return 0
    threshold = np.float32(threshold)
    if np.float32(LOG_2_20) <= threshold:
        return 0
    size = 1
    while size <= n:
        size *= 2
    v = np.arange(size, dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = v[:, None] / v[None, :]
        tab = (tt * np.log2(tt)).astype(np.float32)
    tab[0, :] = 0
    tab[:, 0] = 0
    tab = rnd(tab)
    counts = np.zeros((L, 26), dtype=np.int32)
    i, blk = 1, 4
    blk_cap = max(1, min(64, 4_000_000 // (max(L, 1) * 26)))
    while i <= n:
        b = min(blk, n - i + 1)
        seg = rows[i - 1 : i - 1 + b]
        onehot = np.zeros((b, L, 26), dtype=np.int32)
        bi, li = np.nonzero(seg != X_CODE)
        onehot[bi, li, seg[bi, li]] = 1
        cum = counts[None] + np.cumsum(onehot, axis=0)
        valid = cum.sum(axis=2)
        term = tab[cum, np.broadcast_to(valid[:, :, None], cum.shape)]
        pos_freq = np.zeros((b, L), dtype=np.float32)
        for aa in range(26):
            pos_freq = rnd((pos_freq + term[:, :, aa]).astype(np.float32))
        pf = rnd((pos_freq.astype(np.float64) + LOG_2_20).astype(np.float32))
        for k in range(b):
            if get_median(pf[k], L) <= threshold:
                return i + k
        counts = cum[-1]
        i += b
        blk = min(blk * 2, blk_cap)
    return n


# ------------------------------------------------------------ SIFT math

def create_matrix(rows: np.ndarray, weights: np.ndarray, dt=np.float64):
    """createMatrix (sift_scores.cpp:555-570): weighted letter counts."""
    n, L = rows.shape
    matrix = np.zeros((L, 26), dtype=dt)
    if n and weights.size and np.all(weights == 1.0):
        valid = VALID_AA_MASK[rows]
        pos = np.broadcast_to(np.arange(L, dtype=np.intp)[None, :], rows.shape)
        flat = (pos * 26 + rows.astype(np.intp)).ravel()[valid.ravel()]
        matrix += np.bincount(flat, minlength=L * 26).reshape(L, 26).astype(dt)
        return matrix, matrix.sum(axis=1)
    if n:
        valid = VALID_AA_MASK[rows]
        w = np.where(valid, weights.astype(dt)[:, None], dt(0.0)).astype(dt)
        present = np.zeros(32, dtype=bool)
        present[rows.ravel() & 31] = True
        scratch = np.empty_like(w)
        for aa in range(26):
            if present[aa]:
                np.multiply(w, rows == aa, out=scratch)
                matrix[:, aa] = scratch.sum(axis=0)
    return matrix, matrix.sum(axis=1)


def calc_seq_weights(rows: np.ndarray, raw: np.ndarray, dt=np.float64):
    """calcSeqWeights (:453-498): Henikoff weights summing to n."""
    n, L = rows.shape
    ndiff = ((raw > 0.0) & VALID_AA_MASK[None, :]).sum(axis=1).astype(dt)
    counts_at = raw[np.arange(L)[None, :], rows]
    valid = VALID_AA_MASK[rows] & (counts_at > 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        contrib = np.where(valid, dt(1.0) / (ndiff[None, :] * counts_at), dt(0.0)).astype(dt)
    w = contrib.sum(axis=1)
    tot = w.sum()
    if tot != 0:
        w = (w / tot * n).astype(dt)
    return w, ndiff


def calc_epsilon(weighted, max_aa, ndiff, dt=np.float64):
    valid_f = VALID_AA_MASK.astype(dt)
    wv = weighted * valid_f[None, :]
    num = (RANK_MATRIX[max_aa].astype(dt) * wv).sum(axis=1)
    den = wv.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        eps = np.exp(num / den)
    return np.where(ndiff == 1, dt(0.0), eps).astype(dt)


def calc_diri(weighted: np.ndarray, dt=np.float64) -> np.ndarray:
    """add_diric_values (:379-451): the 13-component Dirichlet mixture."""
    altot = DIRI_ALTOT.astype(dt)
    alpha_all = DIRI_ALPHA.astype(dt)
    g_altot = gammaln(altot)
    g_alpha = gammaln(alpha_all)
    tot = weighted.sum(axis=1)
    ut, it = np.unique(tot, return_inverse=True)
    probn = (gammaln(ut + dt(1.0))[it][None, :] + g_altot[:, None]
             - gammaln(ut[None, :] + altot[:, None])[:, it])
    for aa in range(26):
        if not VALID_AA_MASK[aa]:
            continue
        c = weighted[:, aa]
        alpha = alpha_all[:, aa]
        u, inv = np.unique(c, return_inverse=True)
        probn = probn + (gammaln(u[None, :] + alpha[:, None])[:, inv]
                         - gammaln(u + dt(1.0))[inv][None, :] - g_alpha[:, aa][:, None])
    logq = np.log(DIRI_Q.astype(dt))[:, None]
    terms = logq + probn
    denom = terms[0]
    for j in range(1, terms.shape[0]):
        denom = np.logaddexp(denom, terms[j])
    probj = logq + probn - denom[None, :]
    diric = np.einsum("jl,ja->la", np.exp(probj), alpha_all)
    diric *= VALID_AA_MASK.astype(dt)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        return diric / diric.sum(axis=1)[:, None]


def calc_sift_scores(rows: np.ndarray, raw: np.ndarray, dt=np.float64) -> np.ndarray:
    """calcSIFTScores (:324-377); rows include the query as row 0."""
    seq_weights, ndiff = calc_seq_weights(rows, raw, dt)
    weighted, tot_weights = create_matrix(rows, seq_weights, dt)
    max_aa = np.argmax(weighted, axis=1)
    eps = calc_epsilon(weighted, max_aa, ndiff, dt)
    diric = calc_diri(weighted, dt)
    sift = (weighted + eps[:, None] * diric) / (tot_weights + eps)[:, None]
    max_aa2 = np.argmax(sift, axis=1)
    return sift / sift[np.arange(sift.shape[0]), max_aa2][:, None]


def remove_identical(query: np.ndarray, rows: np.ndarray, seq_identity: float) -> np.ndarray:
    """remove_seqs_percent_identical_to_query (:500-544)."""
    if rows.shape[0] == 0:
        return rows
    valid_q = VALID_AA_MASK[query]
    both = VALID_AA_MASK[rows] & (rows != X_CODE) & valid_q[None, :]
    seq_total = both.sum(axis=1).astype(np.float64)
    identity = (both & (rows == query[None, :])).sum(axis=1).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pct = identity / seq_total * 100.0
    return rows[~(pct >= seq_identity)]


def basic_matrix_construction(rows: np.ndarray, seq_weights: np.ndarray, dt=np.float64):
    """basic_matrix_construction (:633-705)."""
    n, L = rows.shape
    freq = AA_FREQUENCY.astype(dt)
    iD, iN, iE, iQ, iB, iZ = (ord(c) - ord("A") for c in "DNEQBZ")
    part_D = freq[iD] / (freq[iD] + freq[iN])
    part_N = freq[iN] / (freq[iD] + freq[iN])
    part_E = freq[iE] / (freq[iE] + freq[iQ])
    part_Q = freq[iQ] / (freq[iE] + freq[iQ])
    matrix = np.zeros((L, 26), dtype=dt)
    present = np.bincount(rows.ravel() & 31, minlength=32) > 0
    wcol = seq_weights.astype(dt)[:, None]
    sel = np.empty(rows.shape, dtype=bool)
    scratch = np.empty(rows.shape, dtype=dt)
    for aa in range(26):
        if not present[aa]:
            continue
        np.equal(rows, aa, out=sel)
        np.multiply(wcol, sel, out=scratch)
        contrib = scratch.sum(axis=0)
        if aa == iB:
            matrix[:, iD] += part_D * contrib / freq[iD]
            matrix[:, iN] += part_N * contrib / freq[iN]
        elif aa == iZ:
            matrix[:, iE] += part_E * contrib / freq[iE]
            matrix[:, iQ] += part_Q * contrib / freq[iQ]
        elif aa != X_CODE and freq[aa] != 0.0:
            matrix[:, aa] += contrib / freq[aa]
    total = matrix.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        matrix = matrix * dt(100.0) / total[:, None]
    matrix[:, iB] = matrix[:, iD] * part_D + matrix[:, iN] * part_N
    matrix[:, iZ] = matrix[:, iE] * part_E + matrix[:, iQ] * part_Q
    return matrix


def median_seq_info(matrix: np.ndarray, dt=np.float64) -> float:
    """calculateMedianSeqInfo (:151-200), float32 storage (Q9, Q1)."""
    L = matrix.shape[0]
    wv = matrix * VALID_AA_MASK.astype(dt)[None, :]
    total = wv.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        tmp = wv / total[:, None]
        contrib = np.where((tmp > 0.0) & VALID_AA_MASK[None, :], tmp * np.log(tmp), dt(0.0))
    r = contrib.sum(axis=1) / np.log(dt(2.0))
    return float(get_median((r + LOG_2_20).astype(np.float32), L))


def add_median_seq_info(rows: np.ndarray, median_for_pos: Dict[str, float], dt=np.float64) -> None:
    """addMedianSeqInfo (:101-149), memoised on the X-free row subset."""
    cache: Dict[bytes, float] = {}
    for key, value in list(median_for_pos.items()):
        if value != -1:
            continue
        keep = VALID_AA_MASK[rows[:, int(key) - 1]]
        ck = keep.tobytes()
        if ck not in cache:
            if not keep.any():
                cache[ck] = 0.0
            else:
                sub = rows[keep]
                raw, _ = create_matrix(sub, np.ones(sub.shape[0]), dt)
                w, _ = calc_seq_weights(sub, raw, dt)
                cache[ck] = median_seq_info(basic_matrix_construction(sub, w, dt), dt)
        median_for_pos[key] = cache[ck]


# ------------------------------------------------------------ output text

def _fmt2(x) -> str:
    return f"{x:.2f}"


def subst_text(subst_lines: List[str], median_for_pos, sift, aas_stored, total_seq,
               query: np.ndarray) -> str:
    """printSubstFile (sift_scores.cpp:247-314), with quirk Q2."""
    out = []
    for pos in range(sift.shape[0]):
        ref_idx = int(query[pos])
        ref_aa = chr(ref_idx + 65)
        if sift[pos, ref_idx] < TOLERANCE_PROB_THRESHOLD:
            key1 = str(pos + 1)
            if key1 not in median_for_pos:
                continue
            if median_for_pos[key1] < ADEQUATE_SEQ_INFO:
                wrong = median_for_pos.setdefault(str(pos), 0.0)
                out.append(f"WARNING! {ref_aa}{pos + 1} not allowed! score: "
                           f"{_fmt2(sift[pos, ref_idx])} median: {_fmt2(wrong)} "
                           f"# of sequence: {int(aas_stored[pos])}")
    for line in subst_lines:
        m = SUBST_RE.search(line)
        if not m:
            continue
        clean = line.split()[0] if line.split() else ""
        ref_aa, pos1, new_aa = m.group(1), int(m.group(2)), m.group(3)
        pos = pos1 - 1
        score = sift[pos, ord(new_aa) - 65]
        here = chr(int(query[pos]) + 65)
        if here != ref_aa:
            out.append(f"WARNING! Amino acid {here} is at position {pos1}, "
                       f"but your list of substitutions assumes it's a {ref_aa}")
        label = "TOLERATED" if score >= TOLERANCE_PROB_THRESHOLD else "DELETERIOUS"
        out.append(f"{clean}\t{label}\t{_fmt2(score)}\t{_fmt2(median_for_pos[str(pos1)])}\t"
                   f"{int(aas_stored[pos])}\t{total_seq}")
    return "".join(line + "\n" for line in out)


def matrix_text(sift: np.ndarray) -> str:
    """printMatrixOriginalFormat (sift_scores.cpp:597-626, quirk Q12)."""
    body = sift[:, _KEEP_COLS].astype(np.float64)
    return MATRIX_HEADER + (_MATRIX_LINE_FMT * body.shape[0]) % tuple(body.ravel()) + "//\n"


def prediction(query: np.ndarray, rows: np.ndarray, subst_lines: Optional[List[str]],
               median_threshold: float, seq_identity: float, lower: bool = False) -> Optional[str]:
    """One query's .SIFTprediction text from its best-first alignment rows,
    or None where the program writes no file (no alignment kept).
    ``lower`` computes every float one step below what SIFT4G states (the
    control): the float64 SIFT math in float32, the float32 selection in
    bfloat16."""
    dt = np.float32 if lower else np.float64
    if rows.shape[0]:
        rows = rows[: alignments_select(rows, median_threshold, lower)]
    if rows.shape[0] == 0:
        return None  # sift_prediction.cpp:154
    rows = remove_identical(query, rows[: MAX_SEQUENCES - 1], seq_identity)
    rows = np.vstack([query[None, :], rows]) if rows.size else query[None, :].copy()
    total_seq = rows.shape[0]
    raw, aas_stored = create_matrix(rows, np.ones(total_seq), dt)
    sift = calc_sift_scores(rows, raw, dt)
    if subst_lines is None:
        return matrix_text(sift)
    median_for_pos: Dict[str, float] = {}
    for line in subst_lines:
        m = SUBST_RE.search(line)
        if m:
            median_for_pos[str(int(m.group(2)))] = -1.0
    for pos in range(sift.shape[0]):
        if sift[pos, int(query[pos])] < TOLERANCE_PROB_THRESHOLD:
            median_for_pos.setdefault(str(pos + 1), -1.0)
    add_median_seq_info(rows, median_for_pos, dt)
    return subst_text(subst_lines, median_for_pos, sift, aas_stored, total_seq, query)


def read_subst_lines(path: str) -> List[str]:
    with open(path) as fh:
        return [line.rstrip("\n") for line in fh]


def subst_valid(query: np.ndarray, lines: List[str]) -> bool:
    """checkData (sift_prediction.cpp:55-110): at least one valid line,
    every valid line inside the query and naming its residue."""
    n = 0
    for line in lines:
        m = SUBST_RE.search(line)
        if not m:
            continue
        n += 1
        pos = int(m.group(2)) - 1
        if pos < 0 or pos >= query.shape[0] or chr(int(query[pos]) + 65) != m.group(1):
            return False
    return n > 0


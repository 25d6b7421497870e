"""Plain PyTorch twin of the grouped affine-gap scorer (SW/NW/HW/OV).

This is the port's reference for the hand-written CUDA kernels
(``csrc/sw_grouped.cu`` on target slabs, ``csrc/sw_grouped_resident.cu``
on the resident database) and the scorer that ``--backend torch`` runs on
the CPU.  It follows ``sift4g_tpu/align/xla.py`` in shape and layout, with
two deliberate differences:

* The substitution row of query row ``i`` is built by indexing,
  ``matrix[q[i], t & 31]``, never as the ``(m, B, N)`` one-hot product
  (tens of GB at the production launch shape).  ``& 31`` keeps the
  uninitialized bytes past a target's length inside the 32-code table,
  as the Pallas kernel's 5-bit select tree does.
* Scores at the edges follow the Pallas kernel ``_sw_grouped_kernel``,
  not the XLA scan: the matrix is clamped to int8 and a zero-length
  target scores ``NEG`` under NW and HW (the XLA scan returns the
  boundary cell ``H[qlen, 0]`` there).  Every launch's padding rows pass
  through the E-value screen, so the kernel and this twin must agree on
  them too.

The row recurrence is the decayed-prefix-max identity of ``align/xla.py``:
``E[i, j] = max(X0, max_{k<j}(G[i, k] + k ge)) - go - (j-1) ge`` with the
prefix max taken by ``torch.cummax``.  It runs on whatever device the
inputs live on; the aligner only ever hands it CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 28)
PAD_CODE = 31

SCREEN_ROW_BITS = 12          # batch width <= 4096 rows per group
SCREEN_ROW_MASK = (1 << SCREEN_ROW_BITS) - 1
# score * 4096 must stay inside int32: survivors' scores are bounded by
# max_qlen * max_sub; callers gate screening on this
SCREEN_MAX_SCORE = (1 << (31 - SCREEN_ROW_BITS)) - 1


def matrix32_from_scorer(scorer, device) -> torch.Tensor:
    """The scorer's (26, 26) matrix as the (32, 32) int32 tensor the
    scorers take, NEG-padded for codes 26..31 (``align/xla.py``
    ``_extend_matrix``).  The Pallas kernel stored substitution scores as
    int8 and the CUDA kernel clamps to the same range, so an entry
    outside [-127, 127] would break the cross-backend bit-equality
    invariant: refuse it here."""
    matrix = np.asarray(scorer.matrix)
    amax = int(np.abs(matrix).max())
    if amax > 127:
        raise ValueError(
            f"substitution scores must fit int8 for the grouped scorer "
            f"(|score| max {amax} > 127)"
        )
    m32 = np.full((32, 32), NEG, dtype=np.int32)
    m32[:26, :26] = matrix
    return torch.from_numpy(m32).to(device)


def align_scores_grouped(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32
    targets: torch.Tensor,       # (G, B, N) int8/int32 codes
    target_lens: torch.Tensor,   # (G, B) int32
    matrix32: torch.Tensor,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
) -> torch.Tensor:
    """Scores (G, B) int32: group g is query
    ``q_codes_all[q_offsets[g] : q_offsets[g] + q_lens[g]]`` against its
    B targets.  Bytes past a target's length may be anything."""
    if targets.is_cuda:
        from . import sw_grouped

        sw_grouped.twin_calls_on_cuda += 1
    dev = targets.device
    G, B, N = targets.shape
    go, ge = int(gap_open), int(gap_extend)
    i32 = torch.int32
    if G == 0 or B == 0:
        return torch.zeros((G, B), dtype=i32, device=dev)

    m_flat = matrix32.to(dev, i32).clamp(-128, 127).reshape(-1)
    t_idx = targets.to(torch.int64) & 31                       # (G, B, N)
    q_all = q_codes_all.to(dev, torch.int64)
    q_off = q_offsets.to(dev, torch.int64)
    q_len = q_lens.to(dev, torch.int64)
    lens = target_lens.to(dev, torch.int64)
    col = torch.arange(N, dtype=i32, device=dev)

    free_top = mode in ("SW", "HW", "OV")
    free_left = mode in ("SW", "OV")
    local = mode == "SW"

    if free_top:
        h = torch.zeros((G, B, N), dtype=i32, device=dev)
    else:  # NW: H[0, j] = -(go + (j-1) ge)
        h = (-(go + col * ge)).expand(G, B, N).contiguous()
    f = torch.full((G, B, N), NEG, dtype=i32, device=dev)
    has_cols = lens >= 1                                       # (G, B)
    valid = col.to(torch.int64) < lens[..., None]              # (G, B, N)
    last = (lens - 1).clamp(min=0)[..., None]                  # (G, B, 1)
    best = torch.zeros((G, B), dtype=i32, device=dev)          # SW
    col_best = torch.full((G, B), NEG, dtype=i32, device=dev)  # OV
    neg_col = torch.full((G, B, 1), NEG, dtype=i32, device=dev)
    jge1 = (col + 1) * ge
    goge = go + col * ge

    n_rows = int(q_len.max())
    for i in range(n_rows):
        active = i < q_len                                     # (G,)
        pos = (q_off + i).clamp(max=q_all.shape[0] - 1)
        s = torch.take(m_flat, t_idx + (q_all[pos] * 32)[:, None, None])
        if free_left:
            left0, left0_prev = 0, 0
        else:
            left0 = -(go + i * ge)
            left0_prev = 0 if i == 0 else -(go + (i - 1) * ge)
        fn = torch.maximum(h - go, f - ge)
        diag = torch.cat([torch.full_like(neg_col, left0_prev), h[..., :-1]], dim=-1)
        g = torch.maximum(diag + s, fn)
        if local:
            g = g.clamp(min=0)
        cmax = torch.cummax(g + jge1, dim=-1).values
        cm1 = torch.cat([neg_col, cmax[..., :-1]], dim=-1)
        hn = torch.maximum(g, cm1.clamp(min=left0) - goge)
        act = active[:, None, None]
        h = torch.where(act, hn, h)
        f = torch.where(act, fn, f)
        if local:
            row_best = torch.where(valid, hn, 0).amax(dim=-1)
            best = torch.where(active[:, None], torch.maximum(best, row_best), best)
        elif mode == "OV":
            at_last = torch.where(has_cols, hn.gather(-1, last)[..., 0], NEG)
            col_best = torch.where(
                active[:, None], torch.maximum(col_best, at_last), col_best
            )

    if mode == "SW":
        return best
    if mode == "NW":
        return torch.where(has_cols, h.gather(-1, last)[..., 0], NEG).to(i32)
    row_best = torch.where(valid, h, NEG).amax(dim=-1)
    if mode == "HW":
        return row_best
    return torch.maximum(row_best, col_best).clamp(min=0)      # OV


def align_scores_grouped_resident(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32
    db_flat: torch.Tensor,       # (R,) uint8 resident codes, >= n_pad tail
    t_starts: torch.Tensor,      # (G, B) int64 byte starts into db_flat
    target_lens: torch.Tensor,   # (G, B) int32, each <= n_pad
    matrix32: torch.Tensor,      # (32, 32) int32
    n_pad: int,                  # the window (the length rung)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
) -> torch.Tensor:
    """Scores (G, B) int32 of each group's query against the
    ``n_pad``-byte windows ``db_flat[t_starts[g, b] :][:n_pad]``, as
    ``sift4g_tpu/align/xla.py:align_scores_grouped_resident`` computes
    them.  The bytes past a row's length are whatever follows it in the
    database; :func:`align_scores_grouped` masks them as it masks a slab's
    tails.  Unlike the XLA twin the starts are not rounded down to a slot
    grain: the caller passes the starts it means."""
    dev = db_flat.device
    idx = t_starts.to(dev, torch.int64)[..., None] + torch.arange(
        int(n_pad), dtype=torch.int64, device=dev
    )
    return align_scores_grouped(
        q_codes_all, q_offsets, q_lens, db_flat[idx], target_lens, matrix32,
        mode=mode, gap_open=gap_open, gap_extend=gap_extend,
    )


def align_scores(
    query_codes: torch.Tensor,   # (m_pad,) int32
    query_len,                   # int or () tensor
    targets: torch.Tensor,       # (B, N) codes
    target_lens: torch.Tensor,   # (B,) int32
    matrix32: torch.Tensor,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
) -> torch.Tensor:
    """Scores (B,) int32 of one query against B targets."""
    dev = targets.device
    return align_scores_grouped(
        query_codes,
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.as_tensor(query_len, dtype=torch.int32, device=dev).reshape(1),
        targets[None],
        target_lens[None],
        matrix32,
        mode=mode,
        gap_open=gap_open,
        gap_extend=gap_extend,
    )[0]


def screen_topk_words(scores: torch.Tensor, smin: torch.Tensor, k: int) -> torch.Tensor:
    """Exact E-value screen of ``sift4g_tpu/align/xla.py``: each group's
    survivors (``score >= smin[g]``) as int32 words
    ``score * 4096 + (B-1-row)``, the ``k`` largest per group in
    descending order, -1 for losers and padding.  Words are distinct
    within a row, so the order (score desc, row asc) is exact; rows are
    ascending in database id inside a group, which makes it the global
    tie order restricted to the group."""
    G, B = scores.shape
    if B > SCREEN_ROW_MASK + 1:
        raise ValueError(f"batch width {B} overflows the screen's row field")
    rowenc = (B - 1) - torch.arange(B, dtype=torch.int32, device=scores.device)
    words = torch.where(
        scores >= smin[:, None],
        scores * (SCREEN_ROW_MASK + 1) + rowenc,
        -1,
    ).to(torch.int32)
    return torch.topk(words, k, dim=1, sorted=True).values


def decode_screen_words(words: np.ndarray, batch_width: int):
    """Host inverse of :func:`screen_topk_words` for ONE group: (rows,
    scores) of the survivors, best-first."""
    w = words[words >= 0]
    rows = (batch_width - 1) - (w & SCREEN_ROW_MASK)
    return rows, w >> SCREEN_ROW_BITS

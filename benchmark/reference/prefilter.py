"""The plain reference's database prefilter, in PyTorch.

The semantics of ``sift4g_tpu_torch/prefilter/kmer.py`` and the pure-Python
path of ``prefilter/search.py`` (commit eca6a4da; reference
database_search.cpp:66-183), vectorised over the whole database and a batch
of queries at once:

* k-mers pack 5 bits a residue; a database k-mer equal to the one right
  before it in its sequence is skipped (quirk Q5);
* each remaining database k-mer lists, in order, every position of it in
  every query (the CSR hash's fill order: query, then position);
* a (query, sequence) pair's score is the length of the longest strictly
  increasing subsequence of those positions over the sequence's residue
  count, divided in float32;
* a query's candidates are its ``max_candidates`` best pairs by (score
  descending, database index ascending), returned as ascending indices.
  This is the set the program's monotone-floor admission (quirk Q3) and
  its (score, index) tie order (Q4) keep.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

BITS = 5
TABLE_SIZE = {3: 26427, 4: 845627, 5: 27060027}  # largest packed k-mer + 2


def _kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Packed k-mer starting at every position (garbage near the end)."""
    n = codes.shape[0]
    out = torch.zeros(n, dtype=torch.int32, device=codes.device)
    for j in range(k):
        shifted = torch.zeros(n, dtype=torch.int32, device=codes.device)
        shifted[: n - j] = codes[j:]
        out = (out << BITS) | shifted
    return out


class Database:
    """The database's k-mers, kept with their sequence, ready for queries."""

    def __init__(self, codes: np.ndarray, offsets: np.ndarray, k: int, device):
        self.k = k
        self.device = device
        self.n_seq = offsets.shape[0] - 1
        self.lengths = torch.as_tensor(np.diff(offsets), device=device)
        self.total_residues = int(offsets[-1])
        c = torch.as_tensor(codes, device=device).to(torch.int32)
        km = _kmers(c, k)
        seq = torch.repeat_interleave(
            torch.arange(self.n_seq, device=device, dtype=torch.int32), self.lengths)
        local = torch.arange(c.shape[0], device=device) - torch.as_tensor(offsets[:-1], device=device)[seq.long()]
        valid = local <= (self.lengths[seq.long()] - k)
        # quirk Q5: drop a k-mer equal to its immediate predecessor
        dup = torch.zeros_like(valid)
        dup[1:] = (km[1:] == km[:-1]) & (local[1:] > 0)
        keep = valid & ~dup
        self.kmers = km[keep]
        self.seq = seq[keep]
        del c, km, local, valid, dup, keep


def _query_hash(queries: List[np.ndarray], k: int, device):
    """CSR of the queries' k-mers: starts over the table, then (query,
    position) of each hit, ordered by k-mer, query, position."""
    kms, qids, pos = [], [], []
    for qi, q in enumerate(queries):
        n = q.shape[0] - k + 1
        if n <= 0:
            continue
        kms.append(_kmers(torch.as_tensor(q, device=device).to(torch.int32), k)[:n])
        qids.append(torch.full((n,), qi, dtype=torch.int32, device=device))
        pos.append(torch.arange(n, dtype=torch.int32, device=device))
    starts = torch.zeros(TABLE_SIZE[k] + 1, dtype=torch.int64, device=device)
    if not kms:
        return starts, torch.zeros(0, dtype=torch.int32, device=device), torch.zeros(0, dtype=torch.int32, device=device)
    km = torch.cat(kms)
    order = torch.sort(km.long(), stable=True).indices
    starts.index_add_(0, km.long() + 1, torch.ones_like(km, dtype=torch.int64))
    starts = torch.cumsum(starts, 0)
    return starts, torch.cat(qids)[order], torch.cat(pos)[order]


def _lis_lengths(vals: torch.Tensor, gstart: torch.Tensor, glen: torch.Tensor) -> torch.Tensor:
    """Longest strictly increasing subsequence of each group's values
    (``vals[gstart[g] : gstart[g] + glen[g]]``), by patience sorting over
    all groups at once: step t places every group's t-th value."""
    device = vals.device
    ng = glen.shape[0]
    if ng == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    order = torch.argsort(glen, descending=True, stable=True)
    glen_o, gstart_o = glen[order], gstart[order]
    big = int(vals.max().item()) + 2 if vals.numel() else 2
    g = torch.arange(ng, device=device, dtype=torch.int64)
    # every group's tails start at its own "infinity"; offsets g * big keep
    # the flat array sorted across groups, so one searchsorted serves all
    inf = g * big + (big - 1)
    flat = torch.repeat_interleave(inf, glen_o)
    # active[t] = number of groups longer than t (glen_o is descending)
    active = torch.searchsorted(-glen_o, -(torch.arange(int(glen_o[0]), device=device) + 1), right=True)
    for t in range(int(glen_o[0])):
        na = int(active[t])
        x = vals[gstart_o[:na] + t] + g[:na] * big
        flat[torch.searchsorted(flat, x)] = x
    lis_o = torch.zeros(ng, dtype=torch.int64, device=device)
    lis_o.index_add_(0, torch.repeat_interleave(g, glen_o), (flat < torch.repeat_interleave(inf, glen_o)).long())
    out = torch.empty_like(lis_o)
    out[order] = lis_o
    return out


def candidates(db: Database, queries: List[np.ndarray], max_candidates: int,
               batch_kmers: int = 40_000) -> List[np.ndarray]:
    """Each query's candidate database indices, ascending."""
    out: List[np.ndarray] = [None] * len(queries)
    # batches of queries sized by their k-mer count
    qk = [max(q.shape[0] - db.k + 1, 0) for q in queries]
    i = 0
    while i < len(queries):
        j, acc = i, 0
        while j < len(queries) and (j == i or acc + qk[j] <= batch_kmers):
            acc += qk[j]
            j += 1
        for qi, ids in zip(range(i, j), _candidates_batch(db, queries[i:j], max_candidates)):
            out[qi] = ids
        i = j
    return out


def _candidates_batch(db: Database, queries: List[np.ndarray], max_candidates: int):
    device, k, nq = db.device, db.k, len(queries)
    starts, hit_q, hit_pos = _query_hash(queries, k, device)
    lo = starts[db.kmers.long()]
    cnt = starts[db.kmers.long() + 1] - lo
    nz = torch.nonzero(cnt).squeeze(1)
    lo, cnt, seq = lo[nz], cnt[nz], db.seq[nz].long()
    total = int(cnt.sum().item())
    if total == 0:
        return [np.zeros(0, dtype=np.int64) for _ in range(nq)]
    excl = torch.cumsum(cnt, 0) - cnt
    h = torch.repeat_interleave(lo - excl, cnt) + torch.arange(total, device=device)
    e_seq = torch.repeat_interleave(seq, cnt)
    e_q = hit_q[h].long()
    e_pos = hit_pos[h].long()
    del lo, cnt, nz, h, excl
    key = e_q * db.n_seq + e_seq
    order = torch.sort(key, stable=True).indices
    key, e_pos = key[order], e_pos[order]
    del order, e_q, e_seq
    uniq, glen = torch.unique_consecutive(key, return_counts=True)
    gstart = torch.cumsum(glen, 0) - glen
    lis = torch.ones_like(glen)
    multi = torch.nonzero(glen > 1).squeeze(1)
    if multi.numel():
        lis[multi] = _lis_lengths(e_pos, gstart[multi], glen[multi])
    g_q = uniq // db.n_seq
    g_seq = uniq % db.n_seq
    score = lis.to(torch.float32) / db.lengths[g_seq].to(torch.float32)
    # (query asc, score desc, index asc): uniq is already (query, index)
    # ascending, and stable sorts keep that order among equals
    o = torch.sort(-score, stable=True).indices
    o = o[torch.sort(g_q[o], stable=True).indices]
    g_q, g_seq = g_q[o], g_seq[o]
    first = torch.searchsorted(g_q, torch.arange(nq, device=device))
    rank = torch.arange(g_q.shape[0], device=device) - first[g_q]
    keep = rank < max_candidates
    g_q, g_seq = g_q[keep].cpu().numpy(), g_seq[keep].cpu().numpy()
    bounds = np.searchsorted(g_q, np.arange(nq + 1))
    return [np.sort(g_seq[bounds[i]:bounds[i + 1]]) for i in range(nq)]

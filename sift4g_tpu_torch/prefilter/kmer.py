"""k-mer packing and the query inverted index (CSR hash).

Mirrors the reference's 5-bit rolling k-mer packing (hash.cpp:21-44) and
two-pass CSR hash over all query k-mers (hash.cpp:56-85), vectorized with
NumPy.  k ∈ {3, 4, 5}; codes are 0..25 so a packed k-mer fits in
5k ≤ 25 bits.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

PROT_BITS = 5
# Table sizes = max encodable kmer + 2 (hash.cpp:16-19).
NUM_DIFF_KMERS = {3: 26427, 4: 845627, 5: 27060027}
DEL_MASKS = {3: 0x7FFF, 4: 0xFFFFF, 5: 0x1FFFFFF}


def kmer_vector(codes: np.ndarray, k: int) -> np.ndarray:
    """Packed k-mers of a code sequence; empty if len < k (hash.cpp:21-44)."""
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.uint32)
    c = codes.astype(np.uint32)
    out = c[: n - k + 1].copy()
    for j in range(1, k):
        out = (out << PROT_BITS) | c[j : n - k + 1 + j]
    return out


def dedup_adjacent(kmers: np.ndarray) -> np.ndarray:
    """Drop a k-mer only when equal to its immediate predecessor (quirk Q5,
    database_search.cpp:212-214)."""
    if kmers.shape[0] <= 1:
        return kmers
    keep = np.ones(kmers.shape[0], dtype=bool)
    keep[1:] = kmers[1:] != kmers[:-1]
    return kmers[keep]


class QueryKmerHash:
    """CSR inverted index over all query k-mers (hash.cpp:56-85).

    ``starts``: (table_size+1,) int32 prefix offsets (int32 halves the
    216 MB k=5 table and its cache miss footprint; total query k-mers are
    far below 2^31);
    ``hit_query``: (H,) int32 query id; ``hit_pos``: (H,) int32 k-mer
    position within that query's k-mer vector.
    Hits for one k-mer are stored in query scan order then position order,
    matching the reference's fill order.
    """

    def __init__(self, query_codes: List[np.ndarray], k: int):
        self.k = k
        table_size = NUM_DIFF_KMERS[k]
        if self._init_native(query_codes, k, table_size):
            return
        all_kmers = []
        all_qids = []
        all_pos = []
        for qid, codes in enumerate(query_codes):
            kv = kmer_vector(codes, k)
            all_kmers.append(kv)
            all_qids.append(np.full(kv.shape[0], qid, dtype=np.int32))
            all_pos.append(np.arange(kv.shape[0], dtype=np.int32))
        kmers = np.concatenate(all_kmers) if all_kmers else np.zeros(0, np.uint32)
        qids = np.concatenate(all_qids) if all_qids else np.zeros(0, np.int32)
        pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int32)

        # counting pass without bincount: np.bincount touches all
        # ``minlength`` bins (~1.3 s at the 27M-entry k=5 table) while the
        # queries contribute only a few thousand distinct k-mers — scatter
        # the unique counts and prefix-sum in place instead (~0.15 s).
        # uniq/counts come off the already-sorted array directly (np.unique
        # would pay a second sort)
        order = np.argsort(kmers, kind="stable")
        sk = kmers[order]
        self.starts = np.zeros(table_size + 1, dtype=np.int32)
        if sk.size:
            b = np.flatnonzero(sk[1:] != sk[:-1]) + 1
            uniq = sk[np.concatenate(([0], b))]
            counts = np.diff(np.concatenate(([0], b, [sk.size])))
            self.starts[uniq.astype(np.int64) + 1] = counts.astype(np.int32)
        np.cumsum(self.starts, out=self.starts)
        # stable sort by kmer preserves (query, position) scan order per kmer
        self.hit_query = qids[order]
        self.hit_pos = pos[order]

    def _init_native(self, query_codes: List[np.ndarray], k: int,
                     table_size: int) -> bool:
        """C++ two-pass CSR build (bit-identical arrays: same fill order);
        the NumPy path below is the oracle (tests compare them)."""
        import ctypes

        from .. import native

        lib = native.load()
        if lib is None:
            return False
        total = sum(int(c.shape[0]) for c in query_codes)
        codes = np.empty(total, dtype=np.uint8)
        offsets = np.zeros(len(query_codes) + 1, dtype=np.int64)
        w = 0
        for i, c in enumerate(query_codes):
            codes[w : w + c.shape[0]] = c
            w += c.shape[0]
            offsets[i + 1] = w
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self.starts = np.empty(table_size + 1, dtype=np.int32)
        n_hits = lib.sift4g_hash_count(
            codes.ctypes.data_as(u8p), offsets.ctypes.data_as(i64p),
            len(query_codes), k,
            self.starts.ctypes.data_as(i32p), self.starts.shape[0],
        )
        self.hit_query = np.empty(max(int(n_hits), 1), dtype=np.int32)
        self.hit_pos = np.empty(max(int(n_hits), 1), dtype=np.int32)
        lib.sift4g_hash_fill(
            codes.ctypes.data_as(u8p), offsets.ctypes.data_as(i64p),
            len(query_codes), k,
            self.starts.ctypes.data_as(i32p), self.starts.shape[0],
            self.hit_query.ctypes.data_as(i32p),
            self.hit_pos.ctypes.data_as(i32p),
        )
        self.hit_query = self.hit_query[: int(n_hits)]
        self.hit_pos = self.hit_pos[: int(n_hits)]
        return True

    def lookup(self, kmer: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.starts[kmer], self.starts[kmer + 1]
        return self.hit_query[s:e], self.hit_pos[s:e]


def lis_length(positions: np.ndarray) -> int:
    """Length of the longest strictly increasing subsequence
    (patience/binary-search, database_search.cpp:255-280)."""
    tails: List[int] = []
    for x in positions.tolist():
        lo, hi = 0, len(tails)
        while lo < hi:
            mid = (lo + hi) // 2
            if tails[mid] < x:
                lo = mid + 1
            else:
                hi = mid
        if lo == len(tails):
            tails.append(x)
        else:
            tails[lo] = x
    return len(tails)

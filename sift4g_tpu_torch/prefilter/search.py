"""Database prefilter: streamed k-mer search with LIS chaining scores.

Mirrors ``searchDatabase`` (reference database_search.cpp:66-183):

* queries are indexed once in a CSR k-mer hash;
* the database is streamed in residue-byte-bounded chunks;
* per database sequence: packed k-mer vector → adjacent-duplicate skip
  (quirk Q5) → hash hits grouped per query → score =
  LIS(query k-mer positions) / db_seq_len (float32 division) →
  top-``max_candidates`` admission with a monotone floor (quirk Q3 — net
  effect is exact top-k up to tie order at the truncation boundary; this
  implementation breaks score ties by ascending database index, a
  deterministic refinement of the reference's unstable sort, quirk Q4);
* per-query candidate lists are returned as ascending database indices,
  along with the total database residue count (E-value search space).

The per-sequence hot loop has a native C++ fast path (the port's own
``native`` library, built with g++ into ``sift4g_tpu_torch/_build/`` on
first use); this module falls back to the NumPy path when
``SIFT4G_TPU_NO_NATIVE`` turns the library off.  The copy drops the JAX
package's "stale .so" ``hasattr`` guards: the library is always built
from the sources it is bound to.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

import numpy as np

from ..core.chain import Chain
from ..io.fasta import FastaStream
from ..utils import PhaseMetrics
from .kmer import QueryKmerHash, dedup_adjacent, kmer_vector, lis_length

SEARCH_CHUNK_BYTES = 250_000_000  # database_search.cpp:17

_EMPTY_CODES = np.zeros(0, dtype=np.uint8)


class _TopK:
    """Per-query candidate accumulator with the reference's admission rule."""

    __slots__ = ("max_candidates", "scores", "ids", "floor")

    def __init__(self, max_candidates: int):
        self.max_candidates = max_candidates
        self.scores: List[float] = []
        self.ids: List[int] = []
        self.floor = 1000000.0  # database_search.cpp:86

    def admit(self, score: float, db_index: int) -> None:
        if len(self.scores) < self.max_candidates or score > self.floor:
            self.scores.append(score)
            self.ids.append(db_index)
            if score < self.floor:
                self.floor = score

    def truncate(self) -> None:
        """End-of-chunk sort desc + truncate (database_search.cpp:142-153)."""
        if not self.scores:
            return
        order = sorted(range(len(self.scores)), key=lambda i: (-self.scores[i], self.ids[i]))
        order = order[: self.max_candidates]
        self.scores = [self.scores[i] for i in order]
        self.ids = [self.ids[i] for i in order]
        self.floor = self.scores[-1]


def _score_chunk_numpy(
    qhash: QueryKmerHash,
    chunk_codes: List[np.ndarray],
    chunk_start_index: int,
    topks: List[_TopK],
    k: int,
) -> int:
    """Score one streamed chunk; returns its residue-cell count."""
    cells = 0
    starts = qhash.starts
    hit_query = qhash.hit_query
    hit_pos = qhash.hit_pos
    for local_i, codes in enumerate(chunk_codes):
        db_index = chunk_start_index + local_i
        n = codes.shape[0]
        cells += n
        kmers = dedup_adjacent(kmer_vector(codes, k)).astype(np.int64)
        if kmers.shape[0] == 0:
            continue
        s = starts[kmers]
        e = starts[kmers + 1]
        lens = e - s
        total = int(lens.sum())
        if total == 0:
            continue
        # flatten variable ranges [s_i, e_i) preserving db k-mer order
        idx = np.repeat(s - np.concatenate(([0], np.cumsum(lens)[:-1])), lens) + np.arange(total)
        qids = hit_query[idx]
        qpos = hit_pos[idx]
        # group hits per query, preserving arrival order
        order = np.argsort(qids, kind="stable")
        qids_sorted = qids[order]
        qpos_sorted = qpos[order]
        boundaries = np.flatnonzero(np.diff(qids_sorted)) + 1
        groups = np.split(qpos_sorted, boundaries)
        unique_qids = qids_sorted[np.concatenate(([0], boundaries))]
        len_f32 = np.float32(n)
        for qid, positions in zip(unique_qids.tolist(), groups):
            # int / float division in float32, as the reference does
            score = float(np.float32(lis_length(positions)) / len_f32)
            topks[qid].admit(score, db_index)
    return cells


def _search_database_native(
    lib,
    database_path: str,
    queries: List[Chain],
    kmer_length: int,
    max_candidates: int,
    chunk_bytes: int,
    log,
    threads: int = 0,
    record_range=None,
    return_scored: bool = False,
    on_chunk=None,
    metrics=None,
):
    """All-native chunk loop: C++ FASTA streaming feeding the C++ k-mer/LIS
    engine, no per-sequence Python objects (native/search.cpp).

    ``metrics`` (a ``PhaseMetrics``) times the spans ``search.index`` (the
    queries' k-mer index and the engine's tables), ``search.read`` (each
    database part's read) and ``search.scan`` (each
    ``sift4g_search_chunk``, counting its ``residues`` and ``sequences``),
    and splits the scan by the engine's own counters (:func:`_scan_split`).

    ``on_chunk(codes, offsets, names, start_index, snapshot)`` is invoked
    after each chunk is admitted; ``snapshot()`` returns the engine's
    CURRENT per-query candidate id arrays (safe mid-stream: the candidate
    lists are truncated to the exact top-k SET at every chunk boundary;
    ordering is established only at final collect).  The pipeline uses
    this to overlap device scoring with the next chunk's host scan."""
    import ctypes

    from ..io.fasta import FastaStream

    if metrics is None:
        metrics = PhaseMetrics(enabled=False)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    with metrics.phase("search.index"):
        qhash = QueryKmerHash([q.codes for q in queries], kmer_length)
        # the native context borrows these arrays — keep them alive until destroy
        starts = np.ascontiguousarray(qhash.starts)
        hit_query = np.ascontiguousarray(qhash.hit_query)
        hit_pos = np.ascontiguousarray(qhash.hit_pos)
        ctx = lib.sift4g_search_create(
            len(queries),
            max_candidates,
            kmer_length,
            starts.ctypes.data_as(i32p),
            starts.shape[0],
            hit_query.ctypes.data_as(i32p),
            hit_pos.ctypes.data_as(i32p),
            hit_query.shape[0],
            max(int(threads), 0),
        )
    scan_s0 = metrics.phases.get("search.scan", {}).get("seconds", 0.0)
    total_cells = 0
    consumed = record_range[0] if record_range else 0
    try:
        # the factory prefers the binary parse cache, then the C++ parser;
        # both expose the zero-object read_part_arrays fast path
        with FastaStream(database_path, record_range=record_range) as fs:
            more = True
            part = 1
            def _snapshot_ids():
                counts = np.empty(len(queries), dtype=np.int64)
                lib.sift4g_search_counts(ctx, counts.ctypes.data_as(i64p))
                flat = np.empty(max(int(counts.sum()), 1), dtype=np.int64)
                lib.sift4g_search_collect(ctx, flat.ctypes.data_as(i64p))
                bounds = np.concatenate(([0], np.cumsum(counts)))
                # views: flat stays alive via .base, consumers don't mutate
                return [
                    flat[bounds[i] : bounds[i + 1]]
                    for i in range(len(queries))
                ]

            while more:
                with metrics.phase("search.read"):
                    more, codes, offsets, names = fs.read_part_arrays(chunk_bytes)
                n_seq = offsets.shape[0] - 1
                if n_seq:
                    with metrics.phase("search.scan"):
                        residues = lib.sift4g_search_chunk(
                            ctx,
                            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            offsets.ctypes.data_as(i64p),
                            n_seq,
                            consumed,
                        )
                    metrics.add("search.scan", residues=float(residues), sequences=float(n_seq))
                    total_cells += residues
                    start_index = consumed
                    consumed += n_seq
                    if on_chunk is not None:
                        on_chunk(codes, offsets, names, start_index, _snapshot_ids)
                print(f"* database part {part} done *", file=log)
                part += 1
        counts = np.empty(len(queries), dtype=np.int64)
        lib.sift4g_search_counts(ctx, counts.ctypes.data_as(i64p))
        flat = np.empty(max(int(counts.sum()), 1), dtype=np.int64)
        bounds = np.concatenate(([0], np.cumsum(counts)))
        scored = None
        if return_scored:
            fscores = np.empty(max(int(counts.sum()), 1), dtype=np.float32)
            lib.sift4g_search_collect_scored(
                ctx, flat.ctypes.data_as(i64p),
                fscores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            # per query in (score desc, id asc) order; views of the flat
            # arrays (kept alive via .base)
            scored = [
                (fscores[bounds[i] : bounds[i + 1]],
                 flat[bounds[i] : bounds[i + 1]])
                for i in range(len(queries))
            ]
            indices = [np.sort(ids) for _, ids in scored]
        else:
            lib.sift4g_search_collect(ctx, flat.ctypes.data_as(i64p))
            # views: flat stays alive via .base, consumers don't mutate
            indices = [
                flat[bounds[i] : bounds[i + 1]] for i in range(len(queries))
            ]
        st = np.zeros(8, dtype=np.uint64)
        lib.sift4g_search_stats(ctx, st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        scan_s = metrics.phases.get("search.scan", {}).get("seconds", 0.0) - scan_s0
        _scan_split(metrics, scan_s, [int(x) for x in st])
    finally:
        lib.sift4g_search_destroy(ctx)
    if return_scored:
        return indices, int(total_cells), scored
    return indices, int(total_cells)


def _scan_split(metrics, scan_s: float, stats) -> None:
    """Count ``search.kmer`` and ``search.lis`` seconds: the engine's
    scan split by its own counters (``sift4g_search_stats``).

    The engine counts, in CPU cycles, each chunk's scan rounds and its
    merges on the wall clock (scan_wall, merge_wall) and, in the scan, the
    busiest thread's k-mer packing, hit gathering and LIS scoring (pack,
    gather, score).  The rule: ``search.kmer`` is the scan rounds' share
    of the wall times (pack + gather)'s share of the three, of the
    ``search.scan`` seconds ``scan_s``; ``search.lis`` likewise with score.
    The two sum to the scan rounds' share, so never to more than
    ``search.scan``; the rest is the merges.  A host without a cycle
    counter reads zeros and counts nothing."""
    pack, gather, score, _, _, _, scan_w, merge_w = stats
    busy = pack + gather + score
    if busy <= 0 or scan_w + merge_w <= 0:
        return
    rounds_s = scan_s * scan_w / (scan_w + merge_w)
    metrics.add("search.kmer", seconds=rounds_s * (pack + gather) / busy)
    metrics.add("search.lis", seconds=rounds_s * score / busy)


def search_database(
    database_path: str,
    queries: List[Chain],
    kmer_length: int = 5,
    max_candidates: int = 5000,
    chunk_bytes: int = SEARCH_CHUNK_BYTES,
    log=sys.stderr,
    threads: int = 0,
    record_range=None,
    return_scored: bool = False,
    on_chunk=None,
    metrics=None,
):
    """Returns (per-query ascending candidate db indices, total db residues).

    ``threads`` bounds the native engine's worker count (the reference
    threads the search with its -t pool, database_search.cpp:101-123);
    0 means hardware concurrency.  Candidate sets are independent of the
    thread count (property-tested).

    Multi-host extras: ``record_range=(lo, hi)`` scans only that database
    shard (candidate ids stay GLOBAL); ``return_scored`` additionally
    returns per-query (scores, ids) in (score desc, id asc) order so
    per-shard top-k lists merge under the same total order the
    single-process truncate uses (quirk Q3/Q4 refinement).

    ``metrics``: the native engine's spans and counters
    (:func:`_search_database_native`)."""
    print("** Searching database for candidate sequences **", file=log)

    from .. import native

    lib = native.load()
    if lib is not None:
        return _search_database_native(
            lib, database_path, queries, kmer_length, max_candidates, chunk_bytes,
            log, threads=threads, record_range=record_range,
            return_scored=return_scored, on_chunk=on_chunk, metrics=metrics,
        )
    if on_chunk is not None:
        raise ValueError(
            "on_chunk streaming requires the native search engine "
            "(callers gate the overlapped pipeline on native.load())"
        )

    qhash = QueryKmerHash([q.codes for q in queries], kmer_length)
    topks = [_TopK(max_candidates) for _ in queries]

    total_cells = 0
    chains: List[Chain] = []
    consumed = 0                                        # local list position
    offset = record_range[0] if record_range else 0     # global index base
    with FastaStream(database_path, record_range=record_range) as fs:
        more = True
        part = 1
        while more:
            more = fs.read_part(chains, chunk_bytes)
            chunk = chains[consumed:]
            total_cells += _score_chunk_numpy(
                qhash, [c.codes for c in chunk], offset + consumed, topks, kmer_length
            )
            consumed = len(chains)
            # drop residue data of the processed chunk (the alignment phase
            # re-streams the file, mirroring the reference's chainDelete at
            # database_search.cpp:125-129)
            for c in chunk:
                c.codes = _EMPTY_CODES
            for t in topks:
                t.truncate()
            print(f"* database part {part} done *", file=log)
            part += 1

    indices = [np.sort(np.asarray(t.ids, dtype=np.int64)) for t in topks]
    if return_scored:
        scored = [
            (np.asarray(t.scores, dtype=np.float32),
             np.asarray(t.ids, dtype=np.int64))
            for t in topks
        ]
        return indices, total_cells, scored
    return indices, total_cells

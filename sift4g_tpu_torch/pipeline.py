"""End-to-end pipeline on the port's aligner.

The phase order and the align phase are those of
``sift4g_tpu/pipeline.py`` (reference main.cpp:188-250 and
database_alignment.cpp:21-127): host k-mer search, then the database is
re-streamed in chunks and each query's candidates in the chunk are
scored on the device in one round trip; then :func:`_keep_and_trace`
E-value filters them, caps them at ``max_alignments`` best-first
(:func:`best_first_order`) and traces them back on the host; then
selection, prediction and reports.

``PipelineConfig``, ``_query_fanout``, the run-manifest helpers and
``finish_pipeline`` are copies of the JAX package's.  Under
``--predict-backend device`` ``finish_pipeline`` scores the queries up to
4,096 residues in float32 on the run's first device
(``sift/predict_batch.py``; :func:`predict_device`), the subst-mode ones
through the float64 hybrid of ``sift/predict_subst.py``.

The align phase scores on the aligner's device list: the cards of
``--cards`` (``PipelineConfig.cards``), or every visible card, as the JAX
package's mesh does (``parallel/sharded.py``).  The device-resident
database (``_maybe_resident_db``) follows the JAX rule with two changes:
the accelerator check is a CUDA device, and the memory budget is derived
from the cards' free memory (``_resident_budget``, the smallest among
them) instead of the fixed 12 GiB of a 16 GB TPU; the database is
replicated on every card.  ``--resident-db on`` that
cannot hold the database raises with the reason; it never quietly keeps
the slab path.  A multi-host shard (``align_database(record_range=)``,
``parallel/multihost.py``) streams, slot-packs and uploads only its own
records; ``PipelineConfig.query_range`` selects a query-sharded host's
slice before subst validation, as in the JAX package.

The overlapped schedule (``_overlap_cache``, ``_run_overlapped``) scores
each search chunk's new candidates while the scan goes on, under the JAX
package's rule with a CUDA check in place of its accelerator check; its
budget and compaction cap are ``PipelineConfig`` fields, not environment
knobs.  An overlapped run scores on slabs and never builds the resident
database, as in the JAX package.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .align.batch import SCRATCH_BYTES, BatchAligner
from .align.host import PackedTargets, _targets_total_len, align_pairs_batch
from .align.records import AlignmentRecord
from .core.chain import Chain
from .core.evalue import (
    EValueParams,
    create_evalue_params,
    evalues,
    min_passing_score,
)
from .core.scorers import Scorer, create_scorer
from .io.fasta import CachedFastaStream, ChunkStore, FastaStream, read_fasta
from .io.subst import check_data
from .io.writers import (
    create_file_name,
    write_alignments_report,
    write_selected_alignments,
)
from .prefilter.search import search_database
from .sift.predict import predict_query
from .sift.select import alignments_select, extract_alignment_strings
from .utils import PhaseMetrics, query_log

__all__ = ["PipelineConfig", "ResidentRefused", "align_database", "run_pipeline"]

ALIGN_CHUNK_BYTES = 1_000_000_000  # database_alignment.cpp:12

# the exact name shape of io/writers.py atomic_output temp files,
# "<file>.tmp.<pid>.<seq>": nothing else in --out is swept on resume
_STRAY_TMP = re.compile(r"\.tmp\.\d+\.\d+$")
_STRAY_GRACE_S = 300.0

# device memory kept free beside the resident database: the scratch of
# the launch in flight (K1/K3 allocate up to SCRATCH_BYTES each, and the
# caching allocator hands the same block to the next launch on the
# stream) plus 1 GiB for launch inputs, results kept until the fetch, the
# screen's temporaries and the allocator's rounding
_RESIDENT_HEADROOM = SCRATCH_BYTES["cuda"] + (1 << 30)


def _query_fanout(fn, n: int, threads: int, log) -> None:
    """One task per query on a host thread pool (the TPU-side analogue of
    the reference's threadPoolSubmit fan-out, select_alignments.cpp:55-65 /
    sift_prediction.cpp:152-162).  NumPy releases the GIL in the hot math,
    so threads give real parallelism; per-query outputs are independent."""
    if threads <= 1 or n <= 1:
        for qi in range(n):
            fn(qi)
            query_log(qi + 1, n, log=log)
        return
    from concurrent.futures import ThreadPoolExecutor

    done = 0
    with ThreadPoolExecutor(max_workers=min(threads, n)) as ex:
        for _ in ex.map(fn, range(n)):
            done += 1
            query_log(done, n, log=log)


@dataclass
class PipelineConfig:
    query_path: str = ""
    database_path: str = ""
    kmer_length: int = 5
    max_candidates: int = 5000
    gap_open: int = 10
    gap_extend: int = 1
    matrix: str = "BLOSUM_62"
    max_alignments: int = 400
    max_evalue: float = 0.0001
    algorithm: str = "SW"
    median_threshold: float = 2.75
    subst_path: str = ""
    out_path: str = ""
    sub_results: bool = False
    out_format: str = "bm9"
    sequence_identity: int = 100
    align_backend: str = "auto"
    predict_backend: str = "host"
    search_chunk_bytes: int = 250_000_000
    align_chunk_bytes: int = ALIGN_CHUNK_BYTES
    log: object = field(default_factory=lambda: sys.stderr)
    timings: bool = False
    threads: int = 8  # host fan-out over queries (reference -t, main.cpp:85)
    # overlap the host prefilter with provisional device scoring:
    # "auto" = when an accelerator + the parse cache + the native engine are
    # all present; "on" forces it (CPU tests); "off" keeps the reference's
    # strict two-phase order (main.cpp:204-218)
    overlap: str = "auto"
    # process only queries [lo, hi) of the query FASTA (multi-host query
    # sharding; applied BEFORE subst validation so the partition is
    # deterministic across hosts)
    query_range: Optional[tuple] = None
    # HBM-resident database scoring: "auto" | "on" | "off"
    # (align_database docstring; docs/PLATFORM.md "resident database")
    resident_db: str = "auto"
    # multi-host partitioning axis: "db" (shard the database, merge
    # candidates/winners — the few-queries x huge-db mode) or "queries"
    # (each host owns a contiguous query slice end to end — the
    # missense/proteome mode, no cross-host merges)
    multihost_shard: str = "db"
    # crash recovery for proteome-scale runs: skip queries whose
    # .SIFTprediction already exists in out_path.  Queries are
    # independent end to end (per-query candidate sets; E-value params
    # depend only on database size), so the remaining outputs are
    # byte-identical to a full run's.  Queries that legitimately produce
    # NO output (zero E-value survivors) are re-processed every resume —
    # cheap and harmless.  Incompatible with --sub-results (the global
    # alignments.txt would cover only the resumed subset).
    resume: bool = False
    # local device indices for alignment (reference --cards); None = all
    cards: Optional[tuple] = None
    # caller-provided PhaseMetrics (benchmark harnesses read the phase
    # table back after the run; None = pipeline-internal)
    metrics: Optional[object] = None
    # the overlapped pipeline's limits (the JAX package's environment
    # knobs SIFT4G_TPU_OVERLAP_PROV_BUDGET and _COMPACT_CAP): the most
    # provisional entries (queries x max_candidates) it takes on, and the
    # entry count above which it compacts (None = the larger of 1M and
    # twice the live set; 0 = at every chunk)
    overlap_budget: int = 20_000_000
    overlap_compact_cap: Optional[int] = None


class ResidentRefused(RuntimeError):
    """``--resident-db on`` cannot hold the database on the device."""


def _resident_budget(device: torch.device) -> Optional[int]:
    """Bytes the resident database may take on ``device``; None = no
    limit (on the CPU the resident tensor is the host buffer itself).

    On a card: the free device memory less ``_RESIDENT_HEADROOM``.  An 80
    GB H100 with nothing else on it frees about 79 GB, so databases up to
    about 76 GB slotted stay resident (UniRef50 is about 20 GB, Swiss-Prot
    0.2 GB); the JAX package's fixed 12 GiB was sized for a 16 GB v5e."""
    if device.type != "cuda":
        return None
    from .align.resident import free_device_bytes

    return free_device_bytes(device) - _RESIDENT_HEADROOM


def _shard_offsets(fs, record_range) -> np.ndarray:
    """The parse cache's absolute offsets of the records in
    ``record_range`` (all of them when None): the resident layout of a
    multi-host shard holds that shard only."""
    if record_range is None:
        return fs._offsets
    return fs._offsets[record_range[0] : record_range[1] + 1]


def _resident_refusal(mode_flag: str, devices, fs, indices,
                      record_range=None) -> Optional[str]:
    """Why the align phase keeps the slab path, or None to go resident.

    The JAX rule: the parse cache (absolute offsets + mmap codes) and a
    slotted size inside every device's budget; under "auto" also CUDA
    devices and total candidate bytes above the slotted size (the one-time
    upload must beat the slab traffic it replaces), unless the same
    database is already resident there (its upload is sunk cost).
    ``devices``: a device or a list of them.  Under a multi-host
    ``record_range`` only that shard is slotted; ``indices`` stay global."""
    from .align.resident import ResidentDB, distinct_devices, resident_db_cached

    if not isinstance(fs, CachedFastaStream):
        return ("the database has no parse cache (.s4gc; check "
                "SIFT4G_TPU_NO_FASTA_CACHE and that the cache directory is writable)")
    devs = distinct_devices(devices)
    offsets = _shard_offsets(fs, record_range)
    rr_lo = record_range[0] if record_range else 0
    slotted = ResidentDB.slotted_size(offsets)
    budgets = [b for b in (_resident_budget(d) for d in devs) if b is not None]
    budget = min(budgets) if budgets else None
    if budget is not None and slotted + ResidentDB.tail_pad(offsets) > budget:
        return (f"the slotted database ({slotted / 1e9:.2f} GB) exceeds the "
                f"device budget ({max(budget, 0) / 1e9:.2f} GB free beside the "
                f"launch scratch)")
    if mode_flag == "auto":
        if any(d.type != "cuda" for d in devs):
            return "no CUDA device"
        if not resident_db_cached(fs._codes, offsets, devs):
            cand_bytes = 0
            for ix in indices:
                ix = np.asarray(ix, dtype=np.int64) - rr_lo  # shard-local
                if ix.size:
                    cand_bytes += int((offsets[ix + 1] - offsets[ix]).sum())
            if cand_bytes <= slotted:
                return (f"candidate bytes ({cand_bytes}) do not exceed the "
                        f"slotted size ({slotted})")
    return None


def _available_cores() -> int:
    """Cores this process may run on (its CPU affinity)."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def _overlap_cache(cfg: PipelineConfig, n_queries: int = 1, devices=None):
    """The parse-cache handle when the overlapped pipeline runs, else None.

    The JAX package's rule: the native search engine (chunk callbacks) and
    the .s4gc parse cache (random access for the end-of-run traceback);
    under "auto" also at least 8 available cores (the overlap costs about
    a core of host work while the scan runs) and, where the JAX package
    asks for an accelerator, CUDA devices (``--backend cuda``; on the CPU
    the overlap is extra work only).  ``devices``: the run's device list
    (None = every visible card).

    Memory bound: the overlap holds a provisional score per live
    candidate, n_queries x max_candidates entries (about 100 B each).
    Above ``cfg.overlap_budget`` it refuses (loudly under "on") and the
    run keeps the two-phase order, which streams candidates chunk by
    chunk.  Admitted-then-evicted entries are bounded by compaction in
    :func:`_run_overlapped`."""
    if cfg.overlap == "off":
        return None
    live_entries = n_queries * max(cfg.max_candidates, 1)
    if live_entries > cfg.overlap_budget:
        if cfg.overlap == "on":
            print(
                f"* WARNING: --overlap on refused: {n_queries} queries x "
                f"{cfg.max_candidates} candidates = {live_entries} "
                f"provisional entries exceeds the {cfg.overlap_budget}-entry budget "
                f"(PipelineConfig.overlap_budget); running two-phase *",
                file=cfg.log,
            )
        return None
    from . import native

    if native.load() is None:
        return None
    if cfg.overlap == "auto":
        if cfg.align_backend not in ("auto", "cuda") or _available_cores() < 8:
            return None
        if devices is None:
            if not torch.cuda.is_available():
                return None
        else:
            devs = devices if isinstance(devices, (list, tuple)) else [devices]
            if any(torch.device(d).type != "cuda" for d in devs):
                return None
    try:
        fs = FastaStream(cfg.database_path)
    except Exception:
        return None
    if isinstance(fs, CachedFastaStream):
        return fs
    fs.close()
    return None


def best_first_order(scores, ids, cap: int) -> np.ndarray:
    """Positions of the best ``cap`` rows, best-first: score desc,
    database id asc on ties (the reference's sort of alignments and of
    candidates alike; ``scores`` signed integers or floats)."""
    return np.lexsort((np.asarray(ids, dtype=np.int64), -np.asarray(scores)))[:cap]


def best_first_records(records: List[AlignmentRecord], cap: int) -> List[AlignmentRecord]:
    """``records`` best-first (:func:`best_first_order`), capped at ``cap``:
    the merge of a query's records across chunks and across hosts."""
    order = best_first_order([r.score for r in records], [r.target_idx for r in records], cap)
    return [records[i] for i in order]


def _keep_and_trace(query: Chain, ids: np.ndarray, scores: np.ndarray, smin, evalue_params,
                    max_evalue: float, max_alignments: int, scorer: Scorer, mode: str,
                    threads: int, metrics: PhaseMetrics, codes_at, name_at
                    ) -> List[AlignmentRecord]:
    """One query's alignment records, best-first, from its candidates'
    global database ``ids`` and ``scores``; both align schedules call it.

    Under ``align.evalue``: keep ``scores >= smin`` (the query's
    :func:`min_passing_score`, the E-value filter's exact inverse; also
    right after the device screen, whose non-survivors come back 0), or
    ``evalues(scores) <= max_evalue`` where ``smin`` is None or below 1;
    order best-first, cap at ``max_alignments``, take the kept rows'
    E-values.  Then the host traceback of the kept targets, whose codes
    and names ``codes_at`` and ``name_at`` give by id."""
    with metrics.phase("align.evalue"):
        if smin is not None and smin >= 1:
            keep = np.flatnonzero(scores >= smin)
        else:
            keep = np.flatnonzero(evalues(scores, len(query), evalue_params) <= max_evalue)
        keep = keep[best_first_order(scores[keep], ids[keep], max_alignments)]
        kept_ids = ids[keep].tolist()
        evals = evalues(scores[keep], len(query), evalue_params).tolist()
    recs = align_pairs_batch(query.codes, [codes_at(t) for t in kept_ids], scorer, mode,
                             threads=threads, metrics=metrics)
    for rec, t, ev in zip(recs, kept_ids, evals):
        rec.target_idx = t
        rec.target_name = name_at(t)
        rec.evalue = ev
    return recs


def _run_overlapped(
    cfg: PipelineConfig,
    queries: List[Chain],
    scorer: Scorer,
    cache,
    metrics: PhaseMetrics,
    devices=None,
) -> List[List[AlignmentRecord]]:
    """Prefilter and provisional device scoring, overlapped.

    Exactness: a database sequence enters the engine's top-k only while
    its own chunk is current (the admission floor is monotone, quirk Q3),
    so the union of the per-chunk snapshots is a superset of the final
    candidate set; provisional scores of ids evicted later are dropped.
    Kept scores are those of the two-phase run, because the same
    BatchAligner computes them, and :func:`_keep_and_trace` runs once per
    query over its whole candidate set: the set the two-phase run's
    per-chunk steps and merge produce.

    The scores come from slab launches (K1 on a card): an overlapped run
    never builds the resident database, as in the JAX package, whose
    dispatch skips ``align_database`` and so its resident path.

    Spans inside ``search``: ``search.snapshot``, the provisional
    ``align.dispatch`` and ``search.wait`` (the scan blocked on the
    resolves); inside ``align``: ``align.evalue`` (the provisional scores'
    read, then the cut of :func:`_keep_and_trace`) and the traceback's.
    ``align.provisional`` counts every cell scored, ``align`` those of
    the final candidate sets, as the two-phase run counts them."""
    from concurrent.futures import ThreadPoolExecutor

    log = cfg.log
    if cfg.resident_db == "on":
        print("* --resident-db on has no effect in an overlapped run (it scores on "
              "slabs; --overlap off keeps the resident path) *", file=log)
    aligner = BatchAligner(
        scorer, mode=cfg.algorithm, backend=cfg.align_backend, devices=devices,
        threads=cfg.threads, cards=cfg.cards, metrics=metrics,
    )
    prov: List[dict] = [dict() for _ in queries]
    # one resolve worker keeps the scan free of the fetches' waits; one
    # worker also keeps the resolves in order, so prov needs no lock (it
    # is read only after shutdown)
    resolver = ThreadPoolExecutor(max_workers=1)
    resolves: List = []

    def _resolve_one(fetch, meta):
        # runs on the resolver's thread: it returns its wait, which
        # _collect adds on the job's thread as the counter align.fetch
        t0 = time.perf_counter()
        all_scores = fetch()
        fetch_s = time.perf_counter() - t0
        for (qi, ids), scores in zip(meta, all_scores):
            d = prov[qi]
            for t, s in zip(ids.tolist(), scores.tolist()):
                d[t] = s
        return fetch_s

    def _collect(fut):
        fetch_s = fut.result()  # a resolve's or a compaction's error surfaces here
        if fetch_s is not None:
            metrics.add("align.fetch", seconds=fetch_s)

    # admitted-then-evicted ids accrue in prov across chunks; compaction
    # drops keys absent from the engine's snapshot, which is exact because
    # each record is scanned once and the admission floor is monotone
    # (Q3), so an evicted id never re-enters.  It runs on the resolver:
    # FIFO order means it sees prov after exactly the resolves submitted
    # before it
    prov_live_cap = cfg.overlap_compact_cap
    if prov_live_cap is None:
        prov_live_cap = max(1_000_000, 2 * len(queries) * max(cfg.max_candidates, 1))

    def _compact(ids_now):
        if sum(len(d) for d in prov) <= prov_live_cap:
            return
        for qi, cur in enumerate(ids_now):
            d = prov[qi]
            if len(d) > cur.size:
                prov[qi] = {int(t): d[int(t)] for t in cur}

    def on_chunk(codes, offsets, names, start_idx, snapshot):
        with metrics.phase("search.snapshot"):
            ids_now = snapshot()
        offs = np.asarray(offsets, dtype=np.int64)
        items, meta = [], []
        for qi, query in enumerate(queries):
            cur = ids_now[qi]
            new = cur[cur >= start_idx]  # this chunk's admissions (ids asc)
            if new.size == 0:
                continue
            local = new - start_idx
            starts = offs[local]
            lens = (offs[local + 1] - starts).astype(np.int32)
            items.append((query.codes, PackedTargets(codes, starts, lens)))
            meta.append((qi, new))
            # every cell scored, those of candidates evicted later too
            metrics.add("align.provisional", cells=float(len(query)) * float(int(lens.sum())))
        if items:
            with metrics.phase("align.dispatch"):
                fetch = aligner.scores_many_async(items)
            resolves.append(resolver.submit(_resolve_one, fetch, meta))
            # tracked like the resolves, so a compaction error propagates
            resolves.append(resolver.submit(_compact, ids_now))
        # drain finished resolves (an error surfaces at the next chunk)
        # and bound the backlog: each pending resolve pins a chunk's
        # device results (two futures per chunk)
        with metrics.phase("search.wait"):
            while resolves and (resolves[0].done() or len(resolves) > 4):
                _collect(resolves.pop(0))

    try:
        with metrics.phase("search"):
            indices, cells = search_database(
                cfg.database_path,
                queries,
                kmer_length=cfg.kmer_length,
                max_candidates=cfg.max_candidates,
                chunk_bytes=cfg.search_chunk_bytes,
                log=log,
                threads=cfg.threads,
                on_chunk=on_chunk,
                metrics=metrics,
            )
            with metrics.phase("search.wait"):
                for fut in resolves:
                    _collect(fut)  # fetch errors propagate; every score landed
    finally:
        resolver.shutdown(wait=True)
    metrics.add("search", db_residues=float(cells), queries=float(len(queries)),
                overlapped=1.0)
    # the final candidate sets' cells, as the two-phase run counts them
    offs = cache._offsets
    metrics.add("align", cells=float(sum(
        len(q) * int((offs[ix + 1] - offs[ix]).sum()) for q, ix in zip(queries, indices))))

    evalue_params = create_evalue_params(cells, scorer, log=log)
    print("** Aligning queries with candidate sequences **", file=log)
    results: List[List[AlignmentRecord]] = [[] for _ in queries]
    with metrics.phase("align"):
        for qi, query in enumerate(queries):
            ids = indices[qi]
            if ids.size == 0:
                continue
            with metrics.phase("align.evalue"):
                scores = np.fromiter(
                    (prov[qi][int(t)] for t in ids), dtype=np.int64, count=ids.size
                )
            results[qi] = _keep_and_trace(
                query, ids, scores, min_passing_score(cfg.max_evalue, len(query), evalue_params),
                evalue_params, cfg.max_evalue, cfg.max_alignments, scorer, cfg.algorithm,
                cfg.threads, metrics, cache.codes_at, cache.name_at,
            )
    return results


def _maybe_resident_db(fs, indices, aligner, mode_flag: str, log, record_range=None):
    """Build (or fetch the cached) device-resident database when it pays
    (``_resident_refusal``).  Under "on" a refusal raises
    :class:`ResidentRefused`; under "auto" it keeps the slab path.  Under
    a multi-host ``record_range`` only that shard is slot-packed and
    uploaded, and the cache keys it by its own record span."""
    from .align.resident import get_resident_db

    reason = _resident_refusal(mode_flag, aligner.devices, fs, indices, record_range)
    if reason is not None:
        if mode_flag == "on":
            raise ResidentRefused(f"--resident-db on: {reason}")
        return None
    rdb = get_resident_db(fs._codes, _shard_offsets(fs, record_range), aligner.devices)
    print(
        f"** Align phase uses the HBM-resident database "
        f"({rdb.nbytes / 1e9:.2f} GB slotted) **",
        file=log,
    )
    return rdb


def align_database(
    database_path: str,
    queries: List[Chain],
    indices: List[np.ndarray],
    scorer: Scorer,
    evalue_params: EValueParams,
    max_evalue: float,
    max_alignments: int,
    mode: str = "SW",
    backend: str = "cuda",
    devices=None,
    chunk_bytes: int = ALIGN_CHUNK_BYTES,
    log=sys.stderr,
    metrics: Optional[PhaseMetrics] = None,
    record_range=None,
    resident_db: str = "auto",
    threads: int = 0,
    cards: Optional[tuple] = None,
) -> List[List[AlignmentRecord]]:
    """Per-query alignment records, best-first (score desc, database
    index asc on ties).

    ``devices``: the torch devices the scorer runs on (a list, or one
    device); None resolves ``backend`` and ``cards`` (every visible card
    when ``cards`` is None).

    ``record_range=(lo, hi)``: multi-host shard; streams only that record
    slice, and the caller passes candidate ``indices`` already restricted
    to the shard (ids stay global).

    ``resident_db``: "auto" | "on" | "off" — device-resident scoring
    (upload the slot-packed database codes once; launches ship start and
    length arrays instead of target bytes).  See ``_resident_refusal``
    for when "auto" takes it; it has no effect under backend native.

    ``metrics``: the spans ``align.dispatch`` (with the launches'
    ``align.launch.*``), ``align.fetch`` and ``align.traceback`` (with
    :func:`_keep_and_trace`'s ``align.evalue`` and ``align.traceback.*``),
    and the candidates' cells on ``align``."""
    print("** Aligning queries with candidate sequences **", file=log)
    if metrics is None:
        metrics = PhaseMetrics(enabled=False)
    aligner = BatchAligner(
        scorer, mode=mode, backend=backend, devices=devices, threads=threads, cards=cards,
        metrics=metrics,
    )
    results: List[List[AlignmentRecord]] = [[] for _ in queries]
    remaining = [np.asarray(ix, dtype=np.int64) for ix in indices]  # ids ascending
    # integer passing-score thresholds: the exact inverse of the E-value
    # filter, used by the device screen and the host keep filter alike
    smin_all = [min_passing_score(max_evalue, len(q), evalue_params) for q in queries]

    rr_lo = record_range[0] if record_range else 0
    store = ChunkStore(start=rr_lo)
    with FastaStream(database_path, record_range=record_range) as fs:
        resident = None
        if aligner.backend == "native":
            if resident_db == "on":
                print("* --resident-db has no effect under --backend native *", file=log)
        elif resident_db != "off":
            t_up = time.perf_counter()
            resident = _maybe_resident_db(fs, indices, aligner, resident_db, log, record_range)
            if resident is not None:
                metrics.add("align.upload", seconds=time.perf_counter() - t_up,
                            bytes=float(resident.nbytes))
            aligner.resident = resident
        cache_offsets = getattr(fs, "_offsets", None)
        more, codes0, offsets0, names0 = fs.read_part_arrays(chunk_bytes)
        store.append_part(codes0, offsets0, names0)
        while True:
            db_end = store.count - 1
            # slices of a heap-backed part pin the whole part; kept records
            # copy their codes so the part can be evicted below
            consumed_is_mmap = store.latest_is_mmap
            chunk_used: List[np.ndarray] = [None] * len(queries)
            score_items = []
            active = []
            for qi, query in enumerate(queries):
                cand = remaining[qi]
                take = int(np.searchsorted(cand, db_end, side="right"))
                if take == 0:
                    continue
                ids = chunk_used[qi] = cand[:take]
                remaining[qi] = cand[take:]
                if resident is not None:
                    lens_q = (cache_offsets[ids + 1] - cache_offsets[ids]).astype(np.int32)
                    # the resident layout is shard-local under record_range
                    targets = resident.packed_targets(ids - rr_lo, lens_q)
                else:
                    packed = store.pack_latest(ids)
                    if packed is not None:
                        targets = PackedTargets(*packed)
                    else:  # indices outside the newest part
                        targets = [store.codes(t) for t in ids]
                score_items.append((query.codes, targets))
                active.append(qi)
                metrics.add(
                    "align",
                    cells=float(len(query)) * float(_targets_total_len(targets)),
                )
            with metrics.phase("align.dispatch"):
                fetch = aligner.scores_many_async(
                    score_items,
                    screen=([smin_all[qi] for qi in active], max_alignments),
                )
            # stream the next database part while the device scores
            next_more = more
            if more:
                result = {}

                def _read():
                    result["part"] = fs.read_part_arrays(chunk_bytes)

                reader = threading.Thread(target=_read)
                reader.start()
            with metrics.phase("align.fetch"):
                all_scores = fetch()
            if more:
                reader.join()
                next_more, codes_n, offsets_n, names_n = result["part"]
                store.append_part(codes_n, offsets_n, names_n)
            with metrics.phase("align.traceback"):
                for qi, scores in zip(active, all_scores):
                    recs = _keep_and_trace(
                        queries[qi], chunk_used[qi], scores,
                        smin_all[qi], evalue_params, max_evalue, max_alignments, scorer,
                        mode, threads, metrics, store.codes, store.name,
                    )
                    if not consumed_is_mmap:
                        for rec in recs:
                            rec.target_codes = np.array(rec.target_codes, copy=True)
                    results[qi] = best_first_records(results[qi] + recs, max_alignments)
            store.drop_before_latest()
            if not more:
                break
            more = next_more
    return results


_MANIFEST_NAME = ".sift4g_tpu_run.json"
# the parameters that change .SIFTprediction bytes for a given query —
# resuming with any of these differing would silently mix outputs from
# two distinct runs (advisor r4: resume matches on filename only)
_MANIFEST_KEYS = (
    "query_path", "database_path", "kmer_length", "max_candidates",
    "gap_open", "gap_extend", "matrix", "max_alignments", "max_evalue",
    "algorithm", "median_threshold", "subst_path", "sequence_identity",
)


def _manifest_params(cfg: PipelineConfig) -> dict:
    return {
        k: os.path.abspath(v) if k.endswith("_path") and v else v
        for k, v in ((k, getattr(cfg, k)) for k in _MANIFEST_KEYS)
    }


def _write_run_manifest(cfg: PipelineConfig) -> None:
    """Record the output-affecting parameters in --out (best-effort)."""
    import json

    path = os.path.join(cfg.out_path, _MANIFEST_NAME)
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fp:
            json.dump(_manifest_params(cfg), fp, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass


def _resume_check_manifest(cfg: PipelineConfig, log) -> None:
    """Warn when --resume reuses an --out directory whose recorded run
    parameters differ from this invocation's (outputs would silently mix
    two different runs).  Warn-not-fail: the manifest is advisory and
    absent for pre-manifest output directories."""
    import json

    path = os.path.join(cfg.out_path, _MANIFEST_NAME)
    try:
        with open(path) as fp:
            prev = json.load(fp)
    except (OSError, ValueError):
        return
    now = _manifest_params(cfg)
    diffs = [
        f"{k}: {prev[k]!r} -> {now[k]!r}"
        for k in _MANIFEST_KEYS
        if k in prev and prev[k] != now[k]
    ]
    if diffs:
        print(
            "* WARNING: --resume with parameters differing from the run "
            "that produced this --out directory; existing predictions "
            "were made with: " + "; ".join(diffs) + " *",
            file=log,
        )


def _sweep_stray_temps(out_path: str) -> None:
    """Remove temp files a crashed run left in ``out_path``.  Only names of
    the exact ``<file>.tmp.<pid>.<seq>`` shape older than a grace window
    go: a sibling process sharing --out may be mid-write, and a user's
    own file that merely contains ``.tmp.`` is not ours to delete."""
    now = time.time()
    for name in os.listdir(out_path):
        if not _STRAY_TMP.search(name):
            continue
        path = os.path.join(out_path, name)
        try:
            if now - os.path.getmtime(path) > _STRAY_GRACE_S:
                os.unlink(path)
        except OSError:
            pass


def run_pipeline(cfg: PipelineConfig, devices=None) -> List[Chain]:
    """Run the full pipeline; returns the list of processed queries.

    ``cfg.align_backend`` is a port backend ('cuda', 'torch', 'native');
    ``devices`` are the torch devices the scorer runs on (a list, or one
    device; None = ``cfg.cards``, or every visible card)."""
    log = cfg.log
    metrics = cfg.metrics or PhaseMetrics(log=log, enabled=cfg.timings)
    queries = read_fasta(cfg.query_path)
    if cfg.query_range is not None:
        lo, hi = cfg.query_range
        queries = queries[lo:hi]
    print("** Checking query data and substitutions files **", file=log)
    queries = check_data(queries, cfg.subst_path, log=log)
    if cfg.resume and cfg.out_path:
        _resume_check_manifest(cfg, log)
        # outputs are written by atomic replace, so an existing
        # .SIFTprediction is a complete one
        _sweep_stray_temps(cfg.out_path)
        done = {
            q.name for q in queries
            if os.path.exists(create_file_name(q.name, cfg.out_path, ".SIFTprediction"))
        }
        if done:
            print(f"** Resume: skipping {len(done)} queries with existing "
                  f"predictions **", file=log)
            queries = [q for q in queries if q.name not in done]
    if cfg.out_path:
        _write_run_manifest(cfg)
    if not queries:
        print("** EXITING! No valid queries to process. **", file=log)
        return []

    start_finisher_pool(cfg, queries)
    cache = _overlap_cache(cfg, len(queries), devices)
    if cache is not None:
        # the records' target codes are views of the cache's mapping
        with cache:
            scorer = create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend)
            records = _run_overlapped(cfg, queries, scorer, cache, metrics, devices)
            finish_pipeline(cfg, queries, records, metrics, devices)
        return queries

    with metrics.phase("search"):
        indices, cells = search_database(
            cfg.database_path,
            queries,
            kmer_length=cfg.kmer_length,
            max_candidates=cfg.max_candidates,
            chunk_bytes=cfg.search_chunk_bytes,
            log=log,
            threads=cfg.threads,
            metrics=metrics,
        )
    metrics.add("search", db_residues=float(cells), queries=float(len(queries)))

    scorer = create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend)
    evalue_params = create_evalue_params(cells, scorer, log=log)

    with metrics.phase("align"):
        records = align_database(
            cfg.database_path,
            queries,
            indices,
            scorer,
            evalue_params,
            cfg.max_evalue,
            cfg.max_alignments,
            mode=cfg.algorithm,
            backend=cfg.align_backend,
            devices=devices,
            chunk_bytes=cfg.align_chunk_bytes,
            log=log,
            metrics=metrics,
            resident_db=cfg.resident_db,
            threads=cfg.threads,
            cards=cfg.cards,
        )

    finish_pipeline(cfg, queries, records, metrics, devices)
    return queries


def predict_device(cfg: PipelineConfig, devices=None) -> torch.device:
    """Where ``--predict-backend device`` runs: the first device of the
    run's device list (``--cards``' first card, or ``cuda:0``) under
    ``--backend cuda``, the CPU under ``torch`` and ``native``."""
    if devices is None:
        from .align import resolve_backend

        _, devices = resolve_backend(cfg.align_backend, cfg.cards)
    if not isinstance(devices, (list, tuple)):
        devices = [devices]
    return torch.device(devices[0])


def start_finisher_pool(cfg: PipelineConfig, queries: List[Chain]) -> None:
    """At a job's start: the subst finishers' process pool
    (``predict_subst.FinisherPool.start_for_job``) may start now, so that
    its workers start during the search, where device predict will finish
    subst queries: those up to ``MAX_DEVICE_QUERY_LEN`` residues with a
    subst file."""
    if cfg.predict_backend != "device" or not cfg.subst_path:
        return
    from .io.subst import subst_file_name
    from .sift.predict_batch import MAX_DEVICE_QUERY_LEN
    from .sift.predict_subst import POOL

    POOL.start_for_job(sum(
        1 for q in queries
        if len(q) <= MAX_DEVICE_QUERY_LEN
        and os.path.isfile(subst_file_name(q.name, cfg.subst_path))))


def finish_pipeline(
    cfg: PipelineConfig,
    queries: List[Chain],
    records: List[List[AlignmentRecord]],
    metrics: Optional[PhaseMetrics] = None,
    devices=None,
) -> None:
    """Post-align stages: sub-results, selection, prediction, reports.

    Under ``--predict-backend device`` the queries up to
    ``MAX_DEVICE_QUERY_LEN`` residues are scored by
    ``sift/predict_batch.py`` on :func:`predict_device` (``devices``: the
    run's device list; None resolves ``cfg``), the longer ones by the
    host oracle.  On a card a CUDA error ends the run: nothing continues
    on the CPU."""
    log = cfg.log
    if metrics is None:
        metrics = PhaseMetrics(log=log, enabled=cfg.timings)
    if cfg.sub_results:
        path = create_file_name("alignments", cfg.out_path, ".txt")
        write_alignments_report(
            records, queries, path, cfg.out_format,
            scorer=create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend),
        )

    print(
        f"** Selecting alignments with median threshold: {cfg.median_threshold:.2f} **",
        file=log,
    )
    all_names: List[List[str]] = [None] * len(queries)
    all_rows: List[np.ndarray] = [None] * len(queries)

    def _select_one(qi: int) -> None:
        names, rows = extract_alignment_strings(queries[qi], records[qi])
        if rows.shape[0]:
            n_sel = alignments_select(rows, cfg.median_threshold)
            names, rows = names[:n_sel], rows[:n_sel]
        all_names[qi] = names
        all_rows[qi] = rows

    with metrics.phase("select"):
        _query_fanout(_select_one, len(queries), cfg.threads, log)

    if cfg.sub_results:
        strings = [
            [Chain.from_string(nm, (row + ord("A")).tobytes().decode("ascii"))
             for nm, row in zip(all_names[qi], all_rows[qi])]
            for qi in range(len(queries))
        ]
        write_selected_alignments(strings, queries, cfg.out_path)

    print(
        f"** Generating SIFT predictions with sequence identity: "
        f"{float(cfg.sequence_identity):.2f}% **",
        file=log,
    )
    # under --predict-backend device every query up to the length cap
    # rides the batched launches: matrix-mode queries get the float32
    # full-matrix write, subst-mode queries the f32-screen + float64
    # hybrid, byte-identical to the host oracle (sift/predict_subst.py)
    device_qis: List[int] = []
    subst_paths = {}
    if cfg.predict_backend == "device":
        from .io.subst import subst_file_name
        from .sift.predict_batch import MAX_DEVICE_QUERY_LEN

        for qi in range(len(queries)):
            if not all_rows[qi].shape[0]:
                continue
            # the longest queries stay on the host oracle: the chunk's
            # one-hot grows linearly in the query length
            if len(queries[qi]) > MAX_DEVICE_QUERY_LEN:
                continue
            device_qis.append(qi)
            sp = subst_file_name(queries[qi].name, cfg.subst_path)
            if os.path.isfile(sp):
                subst_paths[qi] = sp
    device_set = set(device_qis)

    def _predict_one(qi: int) -> None:
        if all_rows[qi].shape[0] == 0 or qi in device_set:
            return  # sift_prediction.cpp:154
        predict_query(
            queries[qi],
            all_names[qi],
            all_rows[qi],
            cfg.subst_path,
            cfg.sequence_identity,
            cfg.out_path,
        )

    with metrics.phase("predict"):
        _query_fanout(_predict_one, len(queries), cfg.threads, log)
        if device_qis:
            _predict_on_device(cfg, queries, all_names, all_rows, device_qis, subst_paths,
                               predict_device(cfg, devices), metrics)
    if cfg.predict_backend == "device":
        # the queries with rows that the device branch left to the host oracle
        metrics.add("predict", host_queries=float(sum(
            1 for qi in range(len(queries))
            if all_rows[qi].shape[0] and qi not in device_set)))
    metrics.report()


def _predict_on_device(cfg, queries, all_names, all_rows, device_qis, subst_paths, device,
                       metrics) -> None:
    """The device-predict branch of :func:`finish_pipeline`: row
    preparation over the host threads (span ``predict.prep``), the subst
    finishers (``predict_subst.JobFinishers``: in the process's spawn pool,
    which :func:`start_finisher_pool` starts and the process keeps across
    its jobs, once its workers have answered, else on the writer
    threads), the batched launches
    (``predict_batch.predict_matrix_batch``: spans ``predict.pack``,
    ``predict.fetch``, ``predict.finish``) and the pool's drain
    (``predict.finish`` too).  The finishers' counts
    (``predict_subst.finish_counts``) come back from the writer threads or
    the pool and are added to ``predict.finish`` here, on the job's
    thread, with ``pooled_positions``: the positions of the queries
    finished in a pool worker."""
    from .sift.predict import prepare_rows
    from .sift.predict_batch import predict_matrix_batch

    log = cfg.log

    def _prep(qi):
        return prepare_rows(queries[qi], all_names[qi], all_rows[qi], cfg.sequence_identity)

    # row prep (Q7 cap, identity filter, vstack) is independent per query
    # and NumPy-heavy: fan it over the host threads
    with metrics.phase("predict.prep"):
        if cfg.threads > 1 and len(device_qis) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                prepared = list(ex.map(_prep, device_qis))
        else:
            prepared = [_prep(qi) for qi in device_qis]
    finishers = subst = None
    if subst_paths:
        from .io.subst import read_subst_lines
        from .sift.predict_subst import JobFinishers

        subst = JobFinishers(log)
        finishers = [None] * len(device_qis)
        for k, qi in enumerate(device_qis):
            sp = subst_paths.get(qi)
            if sp is not None:
                finishers[k] = subst.finisher(
                    queries[qi], prepared[k], read_subst_lines(sp),
                    create_file_name(queries[qi].name, cfg.out_path, ".SIFTprediction"))
    try:
        counts = predict_matrix_batch(
            [queries[qi] for qi in device_qis], prepared, cfg.out_path,
            threads=cfg.threads, metrics=metrics, finishers=finishers, device=device,
            log=log,
        )
        if subst is not None:
            with metrics.phase("predict.finish"):
                pooled_counts, pooled = subst.drain()
            counts += pooled_counts
            metrics.add("predict.finish", pooled_positions=pooled)
    finally:
        if subst is not None:
            # the pool outlives the job: none of a failed job's finishers
            # may write after it
            subst.cancel()
    for c in counts:
        metrics.add("predict.finish", **c)

"""End-to-end pipeline on the port's aligner.

The phase order and the align phase are those of
``sift4g_tpu/pipeline.py`` (reference main.cpp:188-250 and
database_alignment.cpp:21-127): host k-mer search, then the database is
re-streamed in chunks and each query's candidates in the chunk are
scored on the device in one round trip, E-value filtered, capped at
``max_alignments`` best-first (score desc, database index asc) and
traced back on the host; then selection, prediction and reports on the
host.

``PipelineConfig``, ``_query_fanout``, the run-manifest helpers and
``finish_pipeline`` are copies of the JAX package's.  ``finish_pipeline``
keeps the host predict only: the ``--predict-backend device`` branch
(``sift/predict_batch.py``, JAX) is not ported yet (ROADMAP item 9).

The device-resident database (``_maybe_resident_db``) follows the JAX
rule with two changes: the accelerator check is a CUDA device, and the
memory budget is derived from the card's free memory (``_resident_budget``)
instead of the fixed 12 GiB of a 16 GB TPU.  ``--resident-db on`` that
cannot hold the database raises with the reason; it never quietly keeps
the slab path.  The overlapped prefilter/align pipeline is not ported yet
(ROADMAP item 10): this module always runs the two-phase order.
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
    free, _total = torch.cuda.mem_get_info(device)
    # blocks PyTorch's caching allocator holds but does not use are free
    # to the resident tensor too
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(free) + int(cached) - _RESIDENT_HEADROOM


def _resident_refusal(mode_flag: str, device, fs, indices) -> Optional[str]:
    """Why the align phase keeps the slab path, or None to go resident.

    The JAX rule: the parse cache (absolute offsets + mmap codes) and a
    slotted size inside the device budget; under "auto" also a CUDA device
    and total candidate bytes above the slotted size (the one-time upload
    must beat the slab traffic it replaces), unless the same database is
    already resident (its upload is sunk cost)."""
    from .align.resident import ResidentDB, resident_db_cached

    if not isinstance(fs, CachedFastaStream):
        return ("the database has no parse cache (.s4gc; check "
                "SIFT4G_TPU_NO_FASTA_CACHE and that the cache directory is writable)")
    offsets = fs._offsets
    slotted = ResidentDB.slotted_size(offsets)
    budget = _resident_budget(device)
    if budget is not None and slotted + ResidentDB.tail_pad(offsets) > budget:
        return (f"the slotted database ({slotted / 1e9:.2f} GB) exceeds the "
                f"device budget ({max(budget, 0) / 1e9:.2f} GB free beside the "
                f"launch scratch)")
    if mode_flag == "auto":
        if device.type != "cuda":
            return "no CUDA device"
        if not resident_db_cached(fs._codes, offsets, device):
            cand_bytes = 0
            for ix in indices:
                ix = np.asarray(ix, dtype=np.int64)
                if ix.size:
                    cand_bytes += int((offsets[ix + 1] - offsets[ix]).sum())
            if cand_bytes <= slotted:
                return (f"candidate bytes ({cand_bytes}) do not exceed the "
                        f"slotted size ({slotted})")
    return None


def _maybe_resident_db(fs, indices, aligner, mode_flag: str, log):
    """Build (or fetch the cached) device-resident database when it pays
    (``_resident_refusal``).  Under "on" a refusal raises
    :class:`ResidentRefused`; under "auto" it keeps the slab path."""
    from .align.resident import get_resident_db

    reason = _resident_refusal(mode_flag, aligner.device, fs, indices)
    if reason is not None:
        if mode_flag == "on":
            raise ResidentRefused(f"--resident-db on: {reason}")
        return None
    rdb = get_resident_db(fs._codes, fs._offsets, aligner.device)
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
    device: Optional[torch.device] = None,
    chunk_bytes: int = ALIGN_CHUNK_BYTES,
    log=sys.stderr,
    metrics: Optional[PhaseMetrics] = None,
    resident_db: str = "auto",
    threads: int = 0,
) -> List[List[AlignmentRecord]]:
    """Per-query alignment records, best-first (score desc, database
    index asc on ties).

    ``resident_db``: "auto" | "on" | "off" — device-resident scoring
    (upload the slot-packed database codes once; launches ship start and
    length arrays instead of target bytes).  See ``_resident_refusal``
    for when "auto" takes it; it has no effect under backend native."""
    print("** Aligning queries with candidate sequences **", file=log)
    aligner = BatchAligner(
        scorer, mode=mode, backend=backend, device=device, threads=threads
    )
    results: List[List[AlignmentRecord]] = [[] for _ in queries]
    remaining = [list(ix) for ix in indices]
    # integer passing-score thresholds: the exact inverse of the E-value
    # filter, used by the device screen and the host keep filter alike
    smin_all = [min_passing_score(max_evalue, len(q), evalue_params) for q in queries]

    store = ChunkStore(start=0)
    with FastaStream(database_path) as fs:
        resident = None
        if aligner.backend == "native":
            if resident_db == "on":
                print("* --resident-db has no effect under --backend native *", file=log)
        elif resident_db != "off":
            t_up = time.perf_counter()
            resident = _maybe_resident_db(fs, indices, aligner, resident_db, log)
            if resident is not None and metrics is not None:
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
            chunk_used: List[List[int]] = [[] for _ in queries]
            score_items = []
            active = []
            for qi, query in enumerate(queries):
                cand = remaining[qi]
                take = 0
                while take < len(cand) and cand[take] <= db_end:
                    take += 1
                if take == 0:
                    continue
                chunk_used[qi] = cand[:take]
                remaining[qi] = cand[take:]
                if resident is not None:
                    ids = np.asarray(chunk_used[qi], dtype=np.int64)
                    lens_q = (cache_offsets[ids + 1] - cache_offsets[ids]).astype(np.int32)
                    targets = resident.packed_targets(ids, lens_q)
                else:
                    packed = store.pack_latest(chunk_used[qi])
                    if packed is not None:
                        targets = PackedTargets(*packed)
                    else:  # indices outside the newest part
                        targets = [store.codes(t) for t in chunk_used[qi]]
                score_items.append((query.codes, targets))
                active.append(qi)
                if metrics is not None:
                    metrics.add(
                        "align",
                        cells=float(len(query)) * float(_targets_total_len(targets)),
                    )
            t_disp = time.perf_counter()
            fetch = aligner.scores_many_async(
                score_items,
                screen=([smin_all[qi] for qi in active], max_alignments),
            )
            if metrics is not None:
                metrics.add("align.dispatch", seconds=time.perf_counter() - t_disp)
            # stream the next database part while the device scores
            next_more = more
            if more:
                result = {}

                def _read():
                    result["part"] = fs.read_part_arrays(chunk_bytes)

                reader = threading.Thread(target=_read)
                reader.start()
            t_fetch = time.perf_counter()
            all_scores = fetch()
            if metrics is not None:
                metrics.add("align.fetch", seconds=time.perf_counter() - t_fetch)
            if more:
                reader.join()
                next_more, codes_n, offsets_n, names_n = result["part"]
                store.append_part(codes_n, offsets_n, names_n)
            t_keep = time.perf_counter()
            for qi, scores in zip(active, all_scores):
                query = queries[qi]
                used = chunk_used[qi]
                smin_q = smin_all[qi]
                if smin_q is not None and smin_q >= 1:
                    # == the evalues() filter by construction; also right
                    # after the screen (non-survivors come back 0 < smin_q)
                    keep = np.flatnonzero(scores >= smin_q)
                else:
                    evals_full = evalues(scores, len(query), evalue_params)
                    keep = np.flatnonzero(evals_full <= max_evalue)
                keep = sorted(keep.tolist(), key=lambda i: (-int(scores[i]), used[i]))
                keep = keep[:max_alignments]
                evals_kept = evalues(
                    scores[np.asarray(keep, dtype=np.int64)], len(query), evalue_params
                )
                recs = align_pairs_batch(
                    query.codes,
                    [store.codes(used[i]) for i in keep],
                    scorer,
                    mode,
                    threads=threads,
                )
                for i, rec, ev in zip(keep, recs, evals_kept):
                    rec.target_idx = used[i]
                    rec.target_name = store.name(used[i])
                    rec.evalue = float(ev)
                    if not consumed_is_mmap:
                        rec.target_codes = np.array(rec.target_codes, copy=True)
                    results[qi].append(rec)
                if len(results[qi]) > max_alignments:
                    results[qi].sort(key=lambda r: (-r.score, r.target_idx))
                    del results[qi][max_alignments:]
            if metrics is not None:
                metrics.add("align.traceback", seconds=time.perf_counter() - t_keep)
            store.drop_before_latest()
            if not more:
                break
            more = next_more
    for qi in range(len(queries)):
        results[qi].sort(key=lambda r: (-r.score, r.target_idx))
        del results[qi][max_alignments:]
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


def run_pipeline(cfg: PipelineConfig, device: Optional[torch.device] = None) -> List[Chain]:
    """Run the full pipeline; returns the list of processed queries.

    ``cfg.align_backend`` is a port backend ('cuda', 'torch', 'native');
    ``device`` is the torch device the scorer runs on."""
    log = cfg.log
    metrics = cfg.metrics or PhaseMetrics(log=log, enabled=cfg.timings)
    queries = read_fasta(cfg.query_path)
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

    with metrics.phase("search"):
        indices, cells = search_database(
            cfg.database_path,
            queries,
            kmer_length=cfg.kmer_length,
            max_candidates=cfg.max_candidates,
            chunk_bytes=cfg.search_chunk_bytes,
            log=log,
            threads=cfg.threads,
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
            device=device,
            chunk_bytes=cfg.align_chunk_bytes,
            log=log,
            metrics=metrics,
            resident_db=cfg.resident_db,
            threads=cfg.threads,
        )

    finish_pipeline(cfg, queries, records, metrics)
    return queries


def finish_pipeline(
    cfg: PipelineConfig,
    queries: List[Chain],
    records: List[List[AlignmentRecord]],
    metrics: Optional[PhaseMetrics] = None,
) -> None:
    """Post-align stages: sub-results, selection, prediction, reports.

    Host predict only (the JAX package's device-predict branch is not
    ported yet)."""
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

    def _predict_one(qi: int) -> None:
        if all_rows[qi].shape[0] == 0:
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
    metrics.report()

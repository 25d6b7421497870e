"""End-to-end pipeline on the port's aligner.

The phase order and the align phase are those of
``sift4g_tpu/pipeline.py`` (reference main.cpp:188-250 and
database_alignment.cpp:21-127): host k-mer search, then the database is
re-streamed in chunks and each query's candidates in the chunk are
scored on the device in one round trip, E-value filtered, capped at
``max_alignments`` best-first (score desc, database index asc) and
traced back on the host; selection, prediction and reports are the JAX
package's ``finish_pipeline``, which runs on the host.

The overlapped prefilter/align pipeline and the device-resident database
are not ported yet (ROADMAP items 10 and 8): this module always runs the
two-phase order on streamed target slabs.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from sift4g_tpu.align.batch import PackedTargets, _targets_total_len, align_pairs_batch
from sift4g_tpu.align.records import AlignmentRecord
from sift4g_tpu.core.chain import Chain
from sift4g_tpu.core.evalue import (
    EValueParams,
    create_evalue_params,
    evalues,
    min_passing_score,
)
from sift4g_tpu.core.scorers import Scorer, create_scorer
from sift4g_tpu.io.fasta import ChunkStore, FastaStream, read_fasta
from sift4g_tpu.io.subst import check_data
from sift4g_tpu.io.writers import create_file_name
from sift4g_tpu.pipeline import (
    ALIGN_CHUNK_BYTES,
    PipelineConfig,
    _resume_check_manifest,
    _write_run_manifest,
    finish_pipeline,
)
from sift4g_tpu.prefilter.search import search_database
from sift4g_tpu.utils import PhaseMetrics

from .align.batch import BatchAligner

__all__ = ["PipelineConfig", "align_database", "run_pipeline"]

# the exact name shape of io/writers.py atomic_output temp files,
# "<file>.tmp.<pid>.<seq>": nothing else in --out is swept on resume
_STRAY_TMP = re.compile(r"\.tmp\.\d+\.\d+$")
_STRAY_GRACE_S = 300.0


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
    threads: int = 0,
) -> List[List[AlignmentRecord]]:
    """Per-query alignment records, best-first (score desc, database
    index asc on ties)."""
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
            threads=cfg.threads,
        )

    finish_pipeline(cfg, queries, records, metrics)
    return queries

"""Multi-host runs of the port: one process per host, joined by
``torch.distributed`` over gloo.

The design of ``sift4g_tpu/parallel/multihost.py`` (the reference's
pthread fan-out over database ranges with a host-side top-k merge,
database_search.cpp:101-154, spread over processes):

* the database is split into record-aligned, residue-balanced contiguous
  shards; host ``h`` streams only its shard (a free seek through the
  .s4gc parse cache) with global record indices;
* prefilter: per-host top-``max_candidates`` lists carry (score, id); one
  O(hosts x k) exchange merges them under the (score desc, id asc) order
  of the single-process truncate, so the candidate sets are those of one
  process;
* align: each host scores the merged candidates of its shard on its own
  devices (K1 on slabs, or K3 on the shard's resident database); the
  per-query ``max_alignments`` winner merge is another O(hosts x k)
  exchange of pickled records (dbAlignmentsMerge,
  database_alignment.cpp:97-104);
* selection, prediction and reports run on host 0 only.

``--mh-shard queries`` instead gives each host a contiguous slice of the
queries, run end to end by the single-process pipeline.

The exchanges carry pickled host objects (candidate lists and
``AlignmentRecord`` lists), so they go through gloo on CPU tensors, never
NCCL: NCCL would copy them through the card, and it refuses two ranks on
one GPU, which is what a one-card host running two processes has.

Changes from the JAX module: ``torch.distributed.init_process_group`` in
place of ``jax.distributed.initialize`` (``SIFT4G_MULTIHOST=auto`` reads
the variables ``torchrun`` sets, where JAX reads the TPU runtime's), a
group that is already initialised in the process is reused, the run's
``devices`` are passed down, and ``--resident-db`` reaches each shard's
align phase (the JAX harness leaves it at ``auto``).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np

from ..core.evalue import create_evalue_params
from ..core.scorers import create_scorer
from ..io.fasta import CachedFastaStream, FastaStream, read_fasta
from ..io.subst import check_data
from ..prefilter.search import search_database
from ..utils import PhaseMetrics


@dataclass
class HostContext:
    process_id: int
    num_processes: int

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0


def init_distributed_from_env() -> Optional[HostContext]:
    """Join the multi-host job described by SIFT4G_COORDINATOR (host:port
    of process 0) / SIFT4G_NUM_PROCESSES / SIFT4G_PROCESS_ID; None when
    not configured or when the job has one process.

    ``SIFT4G_MULTIHOST=auto`` instead joins the job a launcher describes
    (``init_method="env://"``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``
    and ``WORLD_SIZE``, as ``torchrun`` sets them).  A process group that
    is already initialised is reused."""
    import torch.distributed as dist

    if dist.is_initialized():
        ctx = HostContext(dist.get_rank(), dist.get_world_size())
        return ctx if ctx.num_processes > 1 else None
    if os.environ.get("SIFT4G_MULTIHOST") == "auto":
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        dist.init_process_group("gloo", init_method="env://")
        return HostContext(dist.get_rank(), dist.get_world_size())
    coord = os.environ.get("SIFT4G_COORDINATOR")
    if not coord:
        return None
    nproc = int(os.environ.get("SIFT4G_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("SIFT4G_PROCESS_ID", "0"))
    if nproc <= 1:
        return None
    dist.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
    return HostContext(pid, nproc)


def allgather_bytes(payload: bytes, n_processes: int) -> List[bytes]:
    """Gather one byte string from every process (a length exchange, then
    an all-gather of padded uint8 CPU tensors over gloo).  Doubles as a
    barrier."""
    import torch
    import torch.distributed as dist

    ln = torch.tensor([len(payload)], dtype=torch.int64)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n_processes)]
    dist.all_gather(lens, ln)
    lens = [int(x.item()) for x in lens]
    cap = max(max(lens), 1)
    buf = torch.zeros(cap, dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    gathered = [torch.empty(cap, dtype=torch.uint8) for _ in range(n_processes)]
    dist.all_gather(gathered, buf)
    return [gathered[i][: lens[i]].numpy().tobytes() for i in range(n_processes)]


def shard_record_ranges(database_path: str, n_hosts: int) -> List[Tuple[int, int]]:
    """Contiguous record-index shards, residue-balanced via the parse
    cache's offsets (record-count-balanced on the cache-less fallback).
    Deterministic: every host computes identical ranges."""
    fs = FastaStream(database_path)
    try:
        if isinstance(fs, CachedFastaStream):
            offsets = fs._offsets
            nrec = offsets.shape[0] - 1
            total = int(offsets[-1])
            bounds = [0]
            for h in range(1, n_hosts):
                b = int(np.searchsorted(offsets, total * h // n_hosts))
                bounds.append(min(max(b, bounds[-1]), nrec))
            bounds.append(nrec)
        else:
            nrec = 0
            more = True
            while more:
                more, _codes, offs, _names = fs.read_part_arrays(1 << 28)
                nrec += offs.shape[0] - 1
            bounds = [nrec * h // n_hosts for h in range(n_hosts + 1)]
    finally:
        fs.close()
    return [(bounds[h], bounds[h + 1]) for h in range(n_hosts)]


def _merge_candidates(per_host_scored, n_queries: int, max_candidates: int):
    """Global top-k from per-shard top-k lists under (score desc, id asc),
    the single-process truncate order (native search.cpp cand_less)."""
    indices = []
    for qi in range(n_queries):
        scores = np.concatenate([h[qi][0] for h in per_host_scored])
        ids = np.concatenate([h[qi][1] for h in per_host_scored])
        order = np.lexsort((ids, -scores))
        keep = order[:max_candidates]
        indices.append(np.sort(ids[keep]))
    return indices


def _run_queries_sharded(cfg, ctx: HostContext, devices=None):
    """Query-sharded multi-host: host ``h`` owns the contiguous query slice
    [n*h/H, n*(h+1)/H) of the query FASTA and runs the single-process
    pipeline on it (a full database scan per host).

    The missense/proteome mode: per-query outputs are independent files,
    so there is no cross-host merge and the outputs are those of one
    process.  Each host writes its own queries' files; a final barrier
    makes "done" mean every host's files exist.  Prefer this axis when
    queries are plentiful, the database axis when they are few."""
    from ..pipeline import run_pipeline

    n = len(read_fasta(cfg.query_path))
    lo = n * ctx.process_id // ctx.num_processes
    hi = n * (ctx.process_id + 1) // ctx.num_processes
    print(
        f"** Multi-host (query-sharded): {ctx.num_processes} hosts; this is "
        f"host {ctx.process_id} with queries [{lo}, {hi}) of {n} **",
        file=cfg.log,
    )
    queries = run_pipeline(replace(cfg, query_range=(lo, hi)), devices)
    allgather_bytes(b"done", ctx.num_processes)  # barrier: all files on disk
    return queries


def run_pipeline_multihost(cfg, ctx: HostContext, devices=None):
    """Distributed twin of ``pipeline.run_pipeline`` on the run's
    ``devices``; host 0 writes all output.  A database-sharded run scores
    two-phase (search, merge, then align)."""
    if cfg.multihost_shard == "queries":
        return _run_queries_sharded(cfg, ctx, devices)
    if ctx.is_primary:
        return _run_db_sharded(cfg, ctx, devices, cfg.log)
    with open(os.devnull, "w") as devnull:
        return _run_db_sharded(cfg, ctx, devices, devnull)


def _run_db_sharded(cfg, ctx: HostContext, devices, log):
    from ..pipeline import align_database, finish_pipeline

    metrics = cfg.metrics or PhaseMetrics(log=log, enabled=cfg.timings and ctx.is_primary)
    queries = read_fasta(cfg.query_path)
    print("** Checking query data and substitutions files **", file=log)
    queries = check_data(queries, cfg.subst_path, log=log)
    if not queries:
        print("** EXITING! No valid queries to process. **", file=log)
        return []

    ranges = shard_record_ranges(cfg.database_path, ctx.num_processes)
    lo, hi = ranges[ctx.process_id]
    print(
        f"** Multi-host: {ctx.num_processes} hosts; this is host "
        f"{ctx.process_id} with database records [{lo}, {hi}) **",
        file=log,
    )

    with metrics.phase("search"):
        _idx, cells_local, scored = search_database(
            cfg.database_path,
            queries,
            kmer_length=cfg.kmer_length,
            max_candidates=cfg.max_candidates,
            chunk_bytes=cfg.search_chunk_bytes,
            log=log,
            threads=cfg.threads,
            record_range=(lo, hi),
            return_scored=True,
        )
        # O(hosts x k) candidate exchange and global merge: every host
        # computes the same sets, and slices its own shard's work from them
        parts = allgather_bytes(
            pickle.dumps((cells_local, scored), protocol=4), ctx.num_processes
        )
        cells = 0
        per_host_scored = []
        for p in parts:
            c, s = pickle.loads(p)
            cells += c
            per_host_scored.append(s)
        indices = _merge_candidates(per_host_scored, len(queries), cfg.max_candidates)
    metrics.add("search", db_residues=float(cells), queries=float(len(queries)))

    scorer = create_scorer(cfg.matrix, cfg.gap_open, cfg.gap_extend)
    evalue_params = create_evalue_params(cells, scorer, log=log)

    local_indices = [ix[(ix >= lo) & (ix < hi)] for ix in indices]
    with metrics.phase("align"):
        records_local = align_database(
            cfg.database_path,
            queries,
            local_indices,
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
            record_range=(lo, hi),
            resident_db=cfg.resident_db,
            threads=cfg.threads,
            cards=cfg.cards,
        )
        # winner merge across hosts (dbAlignmentsMerge,
        # database_alignment.cpp:97-104)
        parts = allgather_bytes(pickle.dumps(records_local, protocol=4), ctx.num_processes)

    if not ctx.is_primary:
        return queries

    records = [[] for _ in queries]
    for p in parts:
        for qi, lst in enumerate(pickle.loads(p)):
            records[qi].extend(lst)
    for qi in range(len(queries)):
        records[qi].sort(key=lambda r: (-r.score, r.target_idx))
        del records[qi][cfg.max_alignments :]

    finish_pipeline(cfg, queries, records, metrics, devices)
    return queries

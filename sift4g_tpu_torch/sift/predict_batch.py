"""Device-batched SIFT prediction (``--predict-backend device``).

The counterpart of ``sift4g_tpu/sift/predict_batch.py``.  The reference
runs one host thread per query (sift_prediction.cpp:152-162); this path
packs queries into ``(Q, n_pad, L_pad)`` code tensors bucketed by padded
length and scores a whole chunk of them in one pass of the float32 math
of ``scores_torch.py``.

Numerics: float32 on the device.  Matrix-mode files can differ from the
float64 oracle's in the last printed digit on rare rounding boundaries,
as the JAX package's do, so the host oracle stays the default.
Substitution-mode queries use the device scores only as a screen: their
finishers (``predict_subst.py``, through the ``finishers`` hook)
re-derive every printed or threshold-adjacent value in float64, so
their files are byte-identical to the host oracle's.

Padding: 'X' is an invalid letter (sift_scores.cpp:316-322), so padded
positions and all-'X' padded rows add nothing to the counts or weights;
the real row count goes separately to the Henikoff normalisation
(sift_scores.cpp:493-497).

Transfers and streams (on a card): each chunk is packed into a pinned
int8 host buffer, copied up with ``non_blocking=True`` and scored on a
side stream, and its scores come back into a fresh pinned buffer, with
``DEPTH`` chunks in flight while the host packs the next and writes the
last.  The pinned input buffers form a ring of ``DEPTH + 1``; a buffer is
refilled only after the CUDA event recorded behind its upload has
completed.  A copy from pageable memory would be synchronous, and a
pinned buffer refilled before its upload ran would race it.

Memory (re-derived for the card; the JAX package's ``Q_CHUNK`` of 32/64
and its resident-database drop were sized for a 16 GB TPU).  One chunk
of ``Qc`` queries in the bucket ``(L_pad, n_pad)`` holds at its peak the
``(Qc, n_pad, L_pad, 26)`` float32 one-hot (104 bytes a cell of ``n_pad x
L_pad``), its int64 index (8), the int8 input (1) and the ``(Qc, n_pad,
L_pad)`` float32 temporaries of the Henikoff weights (about 5 x 4):
``BYTES_PER_CELL`` = 144 bytes with the allocator's rounding (on an
H100, ``tools/bench_predict.py`` peaked at 137), plus the ``DEPTH``
results in flight (``L_pad x 26 x 4`` bytes a query each).  Chunks of
one stream run in order, so one chunk's temporaries are live at a time.
The width of a bucket's chunks is the most queries, at most
``Q_CHUNK_MAX`` = 64, whose bytes fit in the card's free memory
(``resident.free_device_bytes``) less ``HEADROOM`` = 1 GiB; a bucket's
last chunk holds only its own queries (the JAX package pads it with
dummy queries to keep one compiled shape; nothing is compiled here).  Worked out on an 80 GB card:
the widest bucket the query-length cap allows, ``L_pad`` = 4096 and
``n_pad`` = 448 (399 rows and the query), takes 264 MB a query, 16.9 GB
at 64 queries; the common ``(512, 448)`` bucket 33 MB a query, 2.1 GB at
64.  The resident database of the align phase (``align/resident.py``)
is dropped only when the widest bucket's full-width chunk does not fit
beside it: a Swiss-Prot-size database (0.2 GB) or a UniRef50-size one
(about 20 GB) leaves room for 64 queries of every bucket, so the drop
happens only for a database of some 60 GB or more.  A caller's
``q_chunk`` sets every bucket's width as given.

``MAX_DEVICE_QUERY_LEN`` = 4096 is the JAX package's, so both packages
route the same queries to the host oracle.  The JAX package's
``SIFT4G_TPU_PREDICT_*`` environment knobs are not read: the width and
the depth are parameters.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.chain import Chain
from ..io.writers import create_file_name, write_matrix_original_format

X_CODE = ord("X") - ord("A")

# longest query the device path takes (the pipeline routes longer ones
# to the host oracle); the JAX package's value
MAX_DEVICE_QUERY_LEN = 4096
# chunks in flight on the side stream
DEPTH = 2
# the widest chunk, in queries
Q_CHUNK_MAX = 64
# peak device bytes of a chunk per cell of its (n_pad, L_pad) rows, and
# the device memory kept free beside it (module docstring)
BYTES_PER_CELL = 144
HEADROOM = 1 << 30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_shapes(
    lens: Sequence[int], n_rows: Sequence[int]
) -> Dict[Tuple[int, int], List[int]]:
    """Group query indices by their (L_pad, n_pad) bucket: L pads to 128,
    rows to 64 (the JAX package's buckets)."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, (L, n) in enumerate(zip(lens, n_rows)):
        key = (_round_up(max(L, 1), 128), _round_up(max(n, 1), 64))
        buckets.setdefault(key, []).append(i)
    return buckets


def query_bytes(key: Tuple[int, int], depth: int = DEPTH) -> int:
    """Peak device bytes one query of bucket ``key`` adds to a chunk."""
    L_pad, n_pad = key
    return n_pad * L_pad * BYTES_PER_CELL + depth * L_pad * 26 * 4


def chunk_widths(buckets, device: torch.device, q_chunk: int = 0, depth: int = DEPTH,
                 log=None) -> Dict[Tuple[int, int], int]:
    """Queries per chunk for each bucket (module docstring).  On a card
    this may drop the resident database, when the widest bucket's
    full-width chunk does not fit beside it."""
    if q_chunk > 0 or device.type != "cuda":
        return {key: q_chunk if q_chunk > 0 else Q_CHUNK_MAX for key in buckets}
    from ..align import resident

    def fits(key, free):
        return max(0, (free - HEADROOM) // query_bytes(key, depth))

    free = resident.free_device_bytes(device)
    worst = max(buckets, key=query_bytes)
    full = min(Q_CHUNK_MAX, len(buckets[worst]))
    if fits(worst, free) < full and resident.drop_resident_db():
        free = resident.free_device_bytes(device)
        if log is not None:
            print(f"* device predict dropped the resident database: "
                  f"{free / 1e9:.2f} GB free after *", file=log)
    return {key: max(1, min(Q_CHUNK_MAX, fits(key, free))) for key in buckets}


class _PinnedRing:
    """``size`` pinned host byte buffers, each reused only after the event
    recorded behind its last upload has completed."""

    def __init__(self, size: int):
        self.slots = [[None, None, None] for _ in range(size)]  # [int8, int32, event]
        self.next = 0

    def take(self, nbytes: int, nq: int):
        slot = self.slots[self.next]
        self.next = (self.next + 1) % len(self.slots)
        if slot[2] is not None:
            slot[2].synchronize()   # the upload that last read this buffer
            slot[2] = None
        if slot[0] is None or slot[0].numel() < nbytes:
            slot[0] = torch.empty(nbytes, dtype=torch.int8, pin_memory=True)
        if slot[1] is None or slot[1].numel() < nq:
            slot[1] = torch.empty(max(nq, Q_CHUNK_MAX), dtype=torch.int32, pin_memory=True)
        return slot


def predict_matrix_batch(
    queries: List[Chain],
    prepared_rows: List[np.ndarray],
    out_dir: str,
    q_chunk: int = 0,
    threads: int = 8,
    metrics=None,
    finishers=None,
    device=None,
    depth: int = DEPTH,
    log=None,
) -> None:
    """Score and write the ``.SIFTprediction`` files of device-batched
    queries.

    ``prepared_rows[i]``: (n_i, L_i) codes with the query as row 0
    (``predict.prepare_rows``: the Q7 cap and identity filter applied).
    ``device``: where the math runs (default ``cuda``; a CPU device runs
    it on the host, as the tests do).  ``q_chunk`` > 0 sets the queries
    per chunk; 0 sizes them to the card's free memory (module
    docstring).  ``depth``: chunks in flight.

    ``finishers``: optional per-query callables ``f(scores_f32)`` (scores
    trimmed to the query's length) that complete the query instead of
    the full-matrix write: the subst-mode hybrid
    (``predict_subst.finish_subst_query``) plugs in here, so subst and
    matrix queries share the same launches.

    Software-pipelined: chunk k+1 is packed and queued before chunk k's
    scores are fetched, and the per-query file writes run on a host
    thread pool (the reference's per-query prediction tasks,
    sift_prediction.cpp:144-171) under the device's work."""
    from .scores_torch import sift_scores_from_rows_batch

    device = torch.device(device if device is not None else "cuda")
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("device predict on CUDA needs a visible GPU")
    depth = max(1, int(depth))
    lens = [r.shape[1] for r in prepared_rows]
    n_rows = [r.shape[0] for r in prepared_rows]
    buckets = bucket_shapes(lens, n_rows)
    if not buckets:
        return
    widths = chunk_widths(buckets, device, q_chunk, depth, log)
    chunks = [
        (key, idxs[start : start + widths[key]])
        for key, idxs in sorted(buckets.items())
        for start in range(0, len(idxs), widths[key])
    ]
    ring = _PinnedRing(depth + 1) if on_card else None
    stream = torch.cuda.Stream(device) if on_card else None

    def dispatch(key, chunk, fill_pool):
        L_pad, n_pad = key
        nq = len(chunk)
        if on_card:
            slot = ring.take(nq * n_pad * L_pad, nq)
            packed_t = slot[0][: nq * n_pad * L_pad].view(nq, n_pad, L_pad)
            n_valid_t = slot[1][:nq]
        else:
            packed_t = torch.empty((nq, n_pad, L_pad), dtype=torch.int8)
            n_valid_t = torch.empty(nq, dtype=torch.int32)
        packed, n_valid = packed_t.numpy(), n_valid_t.numpy()

        # per-query fills write disjoint slices and release the GIL in the
        # copies, so they fan over the fill pool
        def fill(j):
            r = prepared_rows[chunk[j]]
            packed[j, : r.shape[0], : r.shape[1]] = r
            packed[j, r.shape[0] :, :] = X_CODE
            packed[j, : r.shape[0], r.shape[1] :] = X_CODE
            n_valid[j] = r.shape[0]

        list(fill_pool.map(fill, range(nq)))
        if not on_card:
            return sift_scores_from_rows_batch(packed_t, n_valid_t), None
        with torch.cuda.stream(stream):
            rows_d = packed_t.to(device, non_blocking=True)
            n_valid_d = n_valid_t.to(device, non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record(stream)
            slot[2] = uploaded
            scores = sift_scores_from_rows_batch(rows_d, n_valid_d)
            host = torch.empty(scores.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(scores, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return host, done

    def write_one(scores_row, qi):
        fin = finishers[qi] if finishers is not None else None
        if fin is not None:
            fin(scores_row[: lens[qi]])
            return
        out_path = create_file_name(queries[qi].name, out_dir, ".SIFTprediction")
        write_matrix_original_format(scores_row[: lens[qi]].astype(np.float64), out_path)

    t_pack = t_fetch = 0.0
    # the writer pool drains thousands of file writes; the fills get a
    # pool of their own, or they would queue behind every pending write
    with ThreadPoolExecutor(max_workers=max(1, threads)) as pool, \
            ThreadPoolExecutor(max_workers=4) as fill_pool:
        pending = deque()  # (host scores, done event, chunk): <= depth in flight
        write_futs = []

        def drain_one():
            nonlocal t_fetch
            host, done, chunk = pending.popleft()
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()  # the only wait on the card
            # the numpy view keeps the pinned buffer alive while writers read it
            scores = host.numpy()
            t_fetch += time.perf_counter() - t0
            write_futs.extend(pool.submit(write_one, scores[j], qi)
                              for j, qi in enumerate(chunk))

        for key, chunk in chunks:
            t0 = time.perf_counter()
            host, done = dispatch(key, chunk, fill_pool)
            pending.append((host, done, chunk))
            t_pack += time.perf_counter() - t0
            if len(pending) >= depth:
                drain_one()
        while pending:
            drain_one()
        t0 = time.perf_counter()
        for f in write_futs:
            f.result()  # surface writer exceptions
    if metrics is not None:
        metrics.add("predict.pack", seconds=t_pack)
        metrics.add("predict.fetch", seconds=t_fetch)
        metrics.add("predict.writedrain", seconds=time.perf_counter() - t0)

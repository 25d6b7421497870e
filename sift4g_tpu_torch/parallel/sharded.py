"""Scoring across several devices: sharded launches and a global top-k merge.

The port of ``sift4g_tpu/parallel/sharded.py``.  Every factory keeps the
JAX one's name, arguments, argument layout and divisibility rule; what a
``jax.sharding.Mesh`` and ``shard_map`` did is written out:

* a mesh is an ordered list of ``torch.device`` (``make_mesh``); the 2-D
  mesh of ``make_2d_mesh`` is a list of rows, one per query block;
* a sharded array is the list of its per-device shards, shard ``i`` on
  ``mesh[i]``.  A factory's function takes a sharded argument either as
  such a list (used as it is) or as one host or device array, which it
  splits evenly on the sharded axis (refusing a size that does not
  divide, as ``shard_map`` does).  A replicated argument is placed once
  per distinct device;
* each shard's work is queued on its device's current stream (the
  wrappers of ``align/sw_grouped.py`` launch there), with no host
  synchronisation between shards; several shards may name one device,
  and are then launched in turn on it;
* the O(k) merges of the top-k factories copy each shard's k best to the
  first device of the mesh (or of the query row) and take the k best
  there.  Copies between cards are ordered on both devices' streams by
  PyTorch.

``kernel="cuda"`` scores each shard with the wrappers of the CUDA kernels,
which run their plain PyTorch versions only on CPU tensors; ``"torch"``
calls the plain versions by name.  The local scorer is K4
(``sw_scores_single``) wherever the JAX step scores one query against a
shard (``make_sharded_scores``, ``make_sharded_topk_align``,
``make_sharded_pipeline_step``), K1 in the grouped factory (K2 there with
``scorer="long"``), K2 (``sw_scores_grouped_long``) in the long-target
factory (K1 there with ``scorer="grouped"``), and K3 in the resident
one.  The scorers are looked up at each call, so a caller may wrap them
to record the launches.

The per-shard top-k is a stable descending sort: among equal scores the
lower index comes first, as in ``jax.lax.top_k``, so the merged indices
equal the JAX package's, ties included.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..align import scan, sw_grouped

DB_AXIS = "db"
KERNELS = ("cuda", "torch")

# (wrapper of the CUDA kernel, plain version) of each local scorer
_SCORERS = {
    "single": (sw_grouped, "sw_scores_single", scan, "align_scores"),
    "grouped": (sw_grouped, "sw_scores_grouped", scan, "align_scores_grouped"),
    "resident": (sw_grouped, "sw_scores_grouped_resident", scan,
                 "align_scores_grouped_resident"),
    "long": (sw_grouped, "sw_scores_grouped_long", scan, "align_scores_grouped"),
}


def _scorer(kernel: str, which: str):
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    cuda_mod, cuda_name, plain_mod, plain_name = _SCORERS[which]
    mod, name = (cuda_mod, cuda_name) if kernel == "cuda" else (plain_mod, plain_name)
    return lambda *args, **kw: getattr(mod, name)(*args, **kw)


def _k2_hints(kernel, scorer, live_targets, longest_query, i):
    """K2's keywords for shard i's count of rows that hold a target and
    its longest query; none for the other scorers and the plain
    versions."""
    if kernel != "cuda" or scorer != "long":
        return {}
    kw = {}
    if live_targets is not None:
        kw["live_targets"] = int(live_targets[i])
    if longest_query is not None:
        kw["longest_query"] = int(longest_query[i])
    return kw


def local_devices() -> List[torch.device]:
    """Every visible CUDA card, or the CPU on a host without one."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = DB_AXIS,
    cards: Optional[tuple] = None,
) -> List[torch.device]:
    """1-D device mesh over the database axis: the local devices.

    ``cards`` restricts the mesh to those local device indices, in the
    given order (the reference's --cards list, main.cpp:254-262); empty or
    None means every local device.  ``axis`` names the JAX mesh axis and
    has no use here."""
    devices = local_devices()
    if cards:
        bad = [c for c in cards if not (0 <= c < len(devices))]
        if bad:
            raise ValueError(
                f"--cards indices {bad} out of range: {len(devices)} local "
                f"device(s) available"
            )
        devices = [devices[c] for c in cards]
    if n_devices is not None:
        devices = devices[:n_devices]
    return devices


def make_2d_mesh(
    n_devices: Optional[int] = None, q_axis: str = "q", axis: str = DB_AXIS
) -> List[List[torch.device]]:
    """2-D mesh, query blocks x database shards: ``(nq, n // nq)`` rows of
    devices, with nq = 2 when the count is even so both axes are
    exercised; one device gives ``[[device]]``.  Local devices only."""
    devices = local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    nq = 2 if n % 2 == 0 and n > 1 else 1
    return [devices[r * (n // nq) : (r + 1) * (n // nq)] for r in range(nq)]


def _replicated(mesh, x, dtype=None) -> list:
    """``x`` on every device of ``mesh`` (one copy per distinct device); a
    list is taken as already placed, one entry per device."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh):
            raise ValueError(f"{len(x)} shards for a mesh of {len(mesh)} devices")
        return list(x)
    t = torch.as_tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    copies = {}
    for d in mesh:
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
    return [copies[d] for d in mesh]


def _sharded(mesh, x, dim: int, dtype=None) -> list:
    """``x`` split evenly along ``dim``, shard i on ``mesh[i]``; a list is
    taken as already sharded, one shard per device."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh):
            raise ValueError(f"{len(x)} shards for a mesh of {len(mesh)} devices")
        return list(x)
    return [
        s.to(device=d, dtype=dtype, non_blocking=True).contiguous()
        for s, d in zip(_pieces(x, len(mesh), dim), mesh)
    ]


def _pieces(x, n: int, dim: int):
    """``x`` cut into ``n`` equal pieces along ``dim``."""
    t = torch.as_tensor(x)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"axis {dim} of size {size} does not divide over {n} devices")
    return torch.split(t, size // n, dim=dim)


def _topk(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties by ascending index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _merge_topk(shard_scores, k: int, home: torch.device):
    """The global top-k along the last axis of scores sharded on it: each
    shard's min(k, B_local) best with global indices (the shard offset
    added), copied to ``home``, where the k best of that pool are taken."""
    pool_s, pool_i = [], []
    for shard, s in enumerate(shard_scores):
        b_local = s.shape[-1]
        v, i = _topk(s, min(k, b_local))
        pool_s.append(v.to(home, non_blocking=True))
        pool_i.append((i + shard * b_local).to(device=home, dtype=torch.int32,
                                               non_blocking=True))
    pool = torch.cat(pool_s, dim=-1)
    sg, pos = _topk(pool, min(k, pool.shape[-1]))
    return sg, torch.cat(pool_i, dim=-1).gather(-1, pos)


def shard_batch(mesh, targets, target_lens, axis: str = DB_AXIS):
    """A padded (B, N) target batch and its (B,) lengths, sharded over the
    mesh on the batch axis."""
    return _sharded(mesh, targets, 0), _sharded(mesh, target_lens, 0)


def replicate_to_mesh(mesh, arr) -> list:
    """A host array on every device of the mesh (the resident database
    under a mesh: one upload per distinct device)."""
    return _replicated(mesh, arr)


def to_host(shards, dim: int = 0) -> torch.Tensor:
    """A sharded result as one CPU tensor (shards concatenated on ``dim``)."""
    return torch.cat([s.cpu() for s in shards], dim=dim)


def make_sharded_scores(
    mesh,
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    axis: str = DB_AXIS,
    kernel: str = "cuda",
):
    """Scores of one query against B targets sharded over the mesh.

    fn(query_codes (m_pad,) i32, query_len () i32,
       targets (B, N) i32 sharded on axis 0, target_lens (B,) i32 sharded,
       matrix32 (32, 32) i32 replicated) -> scores (B,) i32 sharded"""
    score = _scorer(kernel, "single")
    i32 = torch.int32

    def fn(q, ql, targets, target_lens, matrix32):
        qs, qls = _replicated(mesh, q, i32), _replicated(mesh, ql, i32)
        ts, tls = _sharded(mesh, targets, 0, i32), _sharded(mesh, target_lens, 0, i32)
        ms = _replicated(mesh, matrix32, i32)
        return [
            score(qs[i], qls[i], ts[i], tls[i], ms[i],
                  mode=mode, gap_open=gap_open, gap_extend=gap_extend)
            for i in range(len(mesh))
        ]

    return fn


def make_sharded_topk_align(
    mesh,
    *,
    k: int,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    axis: str = DB_AXIS,
    kernel: str = "cuda",
):
    """Score B sharded targets, return every score and the global top-k.

    fn(query_codes (m_pad,) i32, query_len () i32,
       targets (B, N) i32 sharded on axis 0, target_lens (B,) i32 sharded,
       matrix32 (32, 32) i32 replicated)
      -> (scores (B,) i32 sharded, topk_scores (k,) i32, topk_idx (k,) i32)

    Each shard keeps its min(k, B_local) best with global indices (the
    shard offset added); the merge on the first device takes the k best
    of that n_dev * k pool."""
    scores_fn = make_sharded_scores(mesh, mode=mode, gap_open=gap_open,
                                    gap_extend=gap_extend, kernel=kernel)

    def fn(q, ql, targets, target_lens, matrix32):
        scores = scores_fn(q, ql, targets, target_lens, matrix32)
        return (scores, *_merge_topk(scores, k, mesh[0]))

    return fn


def make_grouped_sharded(
    mesh,
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    max_qlen: int = 0,
    max_sub: int = 0,
    acc: str = "int",
    axis: str = DB_AXIS,
    kernel: str = "cuda",
    screen_k: int = 0,
    scorer: str = "grouped",
):
    """The grouped scorer (K1) sharded over the GROUP axis: each device
    scores its complete (query, target-chunk) groups.  ``acc`` picks K1's
    accumulator and ``max_qlen``/``max_sub`` bound an ``"i16"`` one
    (``scan.accumulator``): an unknown accumulator, or an ``"i16"`` bound
    that no width admits, is refused here; one that the targets' width N
    breaks, when the function is called, before any shard is placed.

    ``scorer="long"`` (the port's own keyword) scores with K2, the
    long-target kernel, on int32 accumulators, N a multiple of 512 and no
    bound on the queries: the aligner's long rungs grouped across queries.

    fn(q_codes_all (Qm,) i32 replicated, q_offsets (G,) i32 sharded,
       q_lens (G,) i32 sharded, targets (G, B, N) i8 sharded on axis 0,
       target_lens (G, B) i32 sharded, matrix32 (32, 32) i32 replicated
       [, smin (G,) i32 sharded when screen_k > 0], *, live_targets=None,
       longest_query=None)
      -> scores (G, B) i32, or (G, screen_k) screened words, sharded

    ``screen_k`` > 0 screens each shard's scores on its device
    (``align/scan.screen_topk_words``).  ``live_targets`` and
    ``longest_query``, one count a shard, tell K2 how many of a shard's
    rows hold a target and its longest query (its geometry,
    ``sw_grouped.long_geometry``); the other scorers ignore them."""
    if scorer not in ("grouped", "long"):
        raise ValueError(f"scorer must be 'grouped' or 'long', got {scorer!r}")
    score = _scorer(kernel, scorer)
    i32 = torch.int32
    # at width 0 the bound is the weakest it can be: what fails here fails at every width
    scan.accumulator(acc, max_qlen, max_sub, gap_open, gap_extend, 0)
    if scorer == "long":
        if acc != "int":
            raise ValueError("the long-target scorer runs int32 accumulators only")
        # K2 needs no query bound; the plain version takes none
        bounds = dict(m_cap=None) if kernel == "cuda" else {}
    else:
        bounds = dict(max_qlen=max_qlen, max_sub=max_sub, acc=acc)

    def fn(q_all, q_offsets, q_lens, targets, target_lens, matrix32, *smin, live_targets=None,
           longest_query=None):
        if len(smin) != (1 if screen_k else 0):
            raise TypeError("the smin argument comes with screen_k > 0, and only then")
        width = (targets[0] if isinstance(targets, (list, tuple)) else targets).shape[-1]
        scan.accumulator(acc, max_qlen, max_sub, gap_open, gap_extend, width)
        qa, ms = _replicated(mesh, q_all, i32), _replicated(mesh, matrix32, i32)
        go, gl = _sharded(mesh, q_offsets, 0, i32), _sharded(mesh, q_lens, 0, i32)
        tg = _sharded(mesh, targets, 0, torch.int8)
        tl = _sharded(mesh, target_lens, 0, i32)
        sm = _sharded(mesh, smin[0], 0, i32) if screen_k else None
        out = []
        for i in range(len(mesh)):
            s = score(qa[i], go[i], gl[i], tg[i], tl[i], ms[i],
                      mode=mode, gap_open=gap_open, gap_extend=gap_extend, **bounds,
                      **_k2_hints(kernel, scorer, live_targets, longest_query, i))
            out.append(scan.screen_topk_words(s, sm[i], screen_k) if screen_k else s)
        return out

    return fn


def make_grouped_long_sharded(
    mesh,
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    n_chunk: int = 512,
    m_cap: int | None = 2048,
    axis: str = DB_AXIS,
    kernel: str = "cuda",
    scorer: str = "long",
):
    """Long-target launches sharded over the BATCH axis (they carry one
    group, so the group axis cannot be split; rows are independent DP
    problems).  Each shard is scored by K2 (``sw_scores_grouped_long``),
    which holds the JAX contract: N a multiple of ``n_chunk``, queries of
    at most ``m_cap`` rows (``m_cap=None``: no bound).

    ``scorer="grouped"`` (the port's own keyword) scores each shard with
    K1 instead, and ``n_chunk`` and ``m_cap``, K2's contract, do not
    apply: the aligner's batch-split launches that K2 does not take.

    fn(q (Qm,) i32, go (G,) i32, gl (G,) i32 replicated,
       targets (G, B, N) i8 sharded on axis 1, target_lens (G, B) i32
       sharded on axis 1, matrix32, *, live_targets=None, longest_query=None)
      -> scores (G, B) i32 sharded on axis 1

    ``live_targets``, ``longest_query``: as for :func:`make_grouped_sharded`."""
    if scorer not in ("grouped", "long"):
        raise ValueError(f"scorer must be 'grouped' or 'long', got {scorer!r}")
    score = _scorer(kernel, scorer)
    i32 = torch.int32
    # neither K1 nor the plain version takes them
    chunks = dict(n_chunk=n_chunk, m_cap=m_cap) if kernel == "cuda" and scorer == "long" else {}

    def fn(q, go, gl, targets, target_lens, matrix32, *, live_targets=None, longest_query=None):
        qs, ms = _replicated(mesh, q, i32), _replicated(mesh, matrix32, i32)
        gos, gls = _replicated(mesh, go, i32), _replicated(mesh, gl, i32)
        tg = _sharded(mesh, targets, 1, torch.int8)
        tl = _sharded(mesh, target_lens, 1, i32)
        return [
            score(qs[i], gos[i], gls[i], tg[i], tl[i], ms[i],
                  mode=mode, gap_open=gap_open, gap_extend=gap_extend, **chunks,
                  **_k2_hints(kernel, scorer, live_targets, longest_query, i))
            for i in range(len(mesh))
        ]

    return fn


def make_grouped_resident_sharded(
    mesh,
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    n_pad: int = 512,
    kernel: str = "cuda",
    axis: str = DB_AXIS,
    screen_k: int = 0,
):
    """The resident scorer (K3) sharded over the GROUP axis; the resident
    database is replicated (``replicate_to_mesh``: every device holds all
    of it), so launches ship only the (G, B) starts and lengths.

    fn(q (Qm,) i32 replicated, go (G,) i32 sharded, gl (G,) i32 sharded,
       db_flat (R,) u8 replicated, t_starts (G, B) int sharded,
       target_lens (G, B) i32 sharded, matrix32 [, smin (G,) sharded])
      -> (G, B) i32 or (G, screen_k) words, sharded

    The starts are taken as int64 (the port's resident layout)."""
    score = _scorer(kernel, "resident")
    i32 = torch.int32

    def fn(q, go, gl, db_flat, t_starts, target_lens, matrix32, *smin):
        if len(smin) != (1 if screen_k else 0):
            raise TypeError("the smin argument comes with screen_k > 0, and only then")
        qs, ms = _replicated(mesh, q, i32), _replicated(mesh, matrix32, i32)
        dbs = _replicated(mesh, db_flat, torch.uint8)
        gos, gls = _sharded(mesh, go, 0, i32), _sharded(mesh, gl, 0, i32)
        ts = _sharded(mesh, t_starts, 0, torch.int64)
        tl = _sharded(mesh, target_lens, 0, i32)
        sm = _sharded(mesh, smin[0], 0, i32) if screen_k else None
        out = []
        for i in range(len(mesh)):
            s = score(qs[i], gos[i], gls[i], dbs[i], ts[i], tl[i], ms[i], n_pad,
                      mode=mode, gap_open=gap_open, gap_extend=gap_extend)
            out.append(scan.screen_topk_words(s, sm[i], screen_k) if screen_k else s)
        return out

    return fn


def make_sharded_pipeline_step(
    mesh,
    *,
    k: int,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    q_axis: str = "q",
    axis: str = DB_AXIS,
    kernel: str = "cuda",
):
    """Batched queries over a 2-D (query, database) mesh: query blocks go
    to the mesh's rows, the candidate axis is sharded over each row's
    devices, and each query's top-k is merged as in
    :func:`make_sharded_topk_align`, on the row's first device.  Each
    device scores its queries one at a time (one K4 launch each).

    fn(queries (Q, m_pad) i32, query_lens (Q,) i32,
       targets (B, N) i32, target_lens (B,) i32, matrix32 (32, 32) i32)
      -> (topk_scores (Q, k) i32, topk_idx (Q, k) i32), each sharded over
         the query axis: one (Q / nq, k) block per mesh row"""
    score = _scorer(kernel, "single")
    i32 = torch.int32

    def fn(queries, query_lens, targets, target_lens, matrix32):
        q_blocks = _pieces(queries, len(mesh), 0)
        ql_blocks = _pieces(query_lens, len(mesh), 0)
        top_s, top_i = [], []
        for row, qb, qlb in zip(mesh, q_blocks, ql_blocks):
            qs, qls = _replicated(row, qb, i32), _replicated(row, qlb, i32)
            ts, tls = _sharded(row, targets, 0, i32), _sharded(row, target_lens, 0, i32)
            ms = _replicated(row, matrix32, i32)
            scores = [
                torch.stack([
                    score(qs[d][j], qls[d][j : j + 1], ts[d], tls[d], ms[d],
                          mode=mode, gap_open=gap_open, gap_extend=gap_extend)
                    for j in range(qs[d].shape[0])
                ])                                               # (Q_loc, B_loc)
                for d in range(len(row))
            ]
            sg, gi = _merge_topk(scores, k, row[0])
            top_s.append(sg)
            top_i.append(gi)
        return top_s, top_i

    return fn

"""Affine-gap scorers: the wrappers around the CUDA kernels.

``sw_scores_grouped`` (K1) takes the layout of
``sift4g_tpu/align/pallas_sw.py:sw_scores_pallas_grouped``,
``sw_scores_grouped_resident`` (K3) that of
``sw_scores_pallas_grouped_resident``, with int64 starts,
``sw_scores_grouped_long`` (K2) that of ``sw_scores_pallas_grouped_long``
and ``sw_scores_single`` (K4) that of ``sw_scores_pallas``.  All dispatch
on the device of their tensors: CPU tensors go to the plain PyTorch
versions (``align/scan.py``), CUDA tensors to the kernels in
``csrc/sw_grouped.cu``, ``csrc/sw_grouped_resident.cu``,
``csrc/sw_grouped_long.cu`` and ``csrc/sw_single.cu``, built on first
use.  A CUDA call launches the kernel or raises; there is no fallback to
the plain version.

K1, K3 and K4 run the tiled body of ``csrc/sw_tiled.cuh``: T threads
score one target, each holding ``TILE_ROWS`` query rows.  K1 takes the
JAX wrapper's accumulator, ``acc=``: ``"int"`` (int32, the main path's),
``"f32"`` (the same body on float) or ``"i16"`` (``csrc/sw_pair16.cuh``:
T threads score a pair of targets in int16 halves, only where
``scan.i16_admissible`` proves every value fits; refused otherwise).
``tile_geometry`` picks T and the block from the launch's shape and the
card's SM count (K4's launch is one group, G = 1); ``threads_per_target=``
forces T (tests and ``chip_smoke.py`` run every value).  ``grid_cells``
gives the cells a launch covers, padding included.

K2 runs its own body: a target's columns in strips of ``LONG_STRIP``
columns over the warps of a thread-block cluster (up to
``MAX_LONG_CLUSTER`` blocks of up to ``MAX_LONG_WARPS`` warps), the query
rows streamed through them one row a step, steps unrolled in pairs
(``csrc/sw_grouped_long.cu``); ``long_geometry`` picks the cluster and
the warps, ``cluster=`` and ``warps_per_block=`` force them.

Counters (plain integers a run reads to show which path it took):
``kernel_launches`` counts K1 launches made here on int32,
``i16_launches`` and ``f32_launches`` K1's other accumulators,
``resident_launches`` K3 launches, ``long_launches`` K2 launches,
``single_launches`` K4 launches, and
``twin_calls_on_cuda`` calls of the plain versions on CUDA tensors (only
a comparison against a kernel makes those).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build, scan

MODE_IDS = {"SW": 0, "NW": 1, "HW": 2, "OV": 3}
# the accumulators of csrc/sw_grouped.cu (enum Accumulator)
ACC_IDS = {"int": 0, "i16": 1, "f32": 2}

# the tiled body's query rows per thread (kRows of csrc/sw_tiled.cuh)
TILE_ROWS = 16
GROUP_THREADS = (1, 2, 4, 8, 16, 32)
# the fewest threads per target the geometry gives a launch: at 8 (128
# rows a pass) K1 ran 5-22 % faster than at 1, 2 or 4 on the bench launch
# and on launches of the main path's shape (tools/bench_tiled.py threads)
MIN_GROUP_THREADS = 8
# warps per SM the geometry puts on the card at least, and the largest block
WARPS_PER_SM = 16
MAX_BLOCK = 128

# K2: columns a warp (16 a lane), the most warps a block holds and the
# most blocks a cluster holds (kStrip, kMaxWarps and kMaxCluster of
# csrc/sw_grouped_long.cu; 8 is the portable cluster size: 16 one-warp
# blocks, non-portable, lost to one block of 16 warps at every shape of
# chip_smoke.py phase 3b on an H100)
LONG_STRIP = 512
MAX_LONG_WARPS = 16
MAX_LONG_CLUSTER = 8
# the shortest query for which K2's geometry spreads a target over a
# cluster (long_geometry): on an H100, against launches of 4-48 targets of
# 32-69 strips (chip_smoke.py phase 3b), the cluster lost to one block at
# 256 rows and below and tied or won from 360 rows up
LONG_CLUSTER_ROWS = 320

kernel_launches = 0
i16_launches = 0
f32_launches = 0
resident_launches = 0
long_launches = 0
single_launches = 0
twin_calls_on_cuda = 0


def reset_counters() -> None:
    global kernel_launches, i16_launches, f32_launches, resident_launches, single_launches
    global long_launches, twin_calls_on_cuda
    kernel_launches = 0
    i16_launches = 0
    f32_launches = 0
    resident_launches = 0
    long_launches = 0
    single_launches = 0
    twin_calls_on_cuda = 0


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _threads_checked(threads_per_target):
    if threads_per_target is None:
        return None
    if isinstance(threads_per_target, bool) or threads_per_target not in GROUP_THREADS:
        raise ValueError(
            f"threads_per_target must be one of {GROUP_THREADS}, got {threads_per_target!r}")
    return int(threads_per_target)


def tile_geometry(G: int, B: int, N: int, sm_count: int, threads_per_target=None):
    """(T, block): threads per target and threads per block of a K1/K3/K4
    launch of G groups of B targets on an N-wide rung, on a card of
    ``sm_count`` SMs.

    T is the smallest power of two from ``MIN_GROUP_THREADS`` up that puts
    ``WARPS_PER_SM`` warps on every SM (``G * B * T >= sm_count *
    WARPS_PER_SM * 32``), at most 32 (one warp a target) and at most N /
    8, so that the wavefront's T - 1 idle steps stay under an eighth of a
    pass.  The block holds
    ``MAX_BLOCK`` threads, halved down to one warp while the launch would
    leave SMs without a block.  The query lengths are not read: they live
    on the card, and the kernel loops its passes over them.
    ``threads_per_target`` forces T."""
    T = _threads_checked(threads_per_target)
    if T is None:
        want = sm_count * WARPS_PER_SM * 32
        T = MIN_GROUP_THREADS
        while T < 32 and G * B * T < want:
            T *= 2
        while T > 1 and 8 * T > N:
            T //= 2
    block = MAX_BLOCK
    while block > 32 and G * -(-B * T // block) < sm_count:
        block //= 2
    return T, block


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_geometry(G: int, B: int, N: int, device, threads_per_target=None):
    """:func:`tile_geometry` on the card ``device``."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return tile_geometry(G, B, N, _sm_count(index), threads_per_target)


def thread_groups(B: int, acc: str = "int") -> int:
    """The thread groups a group of B targets takes in a K1, K3 or K4
    launch: a target each, or a pair of targets under ``acc="i16"``."""
    return (B + 1) // 2 if acc == "i16" else B


def grid_cells(scorer: str, q_lens, B: int, N: int, device, acc: str = "int") -> int:
    """The DP cells that a launch covers as the wrapper here launches it:
    ``scorer`` is ``"grouped"`` (K1), ``"resident"`` (K3), ``"single"``
    (K4) or ``"long"`` (K2), with one group a query of ``q_lens``, each
    against B target slots of an N-wide rung, on ``device``.  K1, K3 and
    K4 on a card run a query in whole passes of ``TILE_ROWS`` rows a
    thread of the T that :func:`launch_geometry` picks, over every slot of
    their :func:`thread_groups`; K2 streams a query's rows as they are over
    its strips, which tile N; the plain versions take the rows as they
    are."""
    q = np.asarray(q_lens, dtype=np.int64)
    rows, slots = q, B
    if torch.device(device).type == "cuda" and scorer != "long":
        width = thread_groups(B, acc)
        T, _ = launch_geometry(q.size, width, N, device)
        step = TILE_ROWS * T
        rows = -(-q // step) * step
        slots = width * (2 if acc == "i16" else 1)
    return int(rows.sum()) * slots * N


def sw_scores_grouped(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32
    targets: torch.Tensor,       # (G, B, N) int8 codes
    target_lens: torch.Tensor,   # (G, B) int32, each <= N
    matrix32: torch.Tensor,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    max_qlen: int = 0,
    max_sub: int = 0,
    acc: str = "int",
    threads_per_target: int | None = None,
) -> torch.Tensor:
    """Scores (G, B) int32: group g = query g against its B targets.
    ``acc`` picks the accumulator (``scan.accumulator``: an unknown one,
    or ``"i16"`` where ``max_qlen`` and ``max_sub`` do not prove that
    every value fits int16, raises before any work).
    ``threads_per_target`` forces the kernel's T (see
    :func:`tile_geometry`; under ``"i16"`` T threads score a pair of
    targets); the plain version ignores it."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown alignment mode {mode!r}")
    _threads_checked(threads_per_target)
    scan.accumulator(acc, max_qlen, max_sub, gap_open, gap_extend, targets.shape[-1])
    dev = targets.device
    if dev.type == "cpu":
        return scan.align_scores_grouped(
            q_codes_all, q_offsets, q_lens, targets, target_lens, matrix32,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
            max_qlen=max_qlen, max_sub=max_sub, acc=acc,
        )
    if dev.type != "cuda":
        raise ValueError(f"sw_scores_grouped runs on cpu or cuda, not {dev}")
    G, B, N = targets.shape
    _check("q_codes_all", q_codes_all, torch.int32, (q_codes_all.numel(),), dev)
    _check("q_offsets", q_offsets, torch.int32, (G,), dev)
    _check("q_lens", q_lens, torch.int32, (G,), dev)
    _check("targets", targets, torch.int8, (G, B, N), dev)
    _check("target_lens", target_lens, torch.int32, (G, B), dev)
    _check("matrix32", matrix32, torch.int32, (32, 32), dev)
    if N % 16 or targets.data_ptr() % 16:
        raise ValueError("targets rows must be 16-byte multiples on a 16-byte aligned base")
    if G > 65535:
        raise ValueError(f"{G} groups exceed the launch grid (65535)")

    width = thread_groups(B, acc)
    T, block = launch_geometry(G, width, N, dev, threads_per_target)
    lib = _build.load()
    out = torch.empty((G, B), dtype=torch.int32, device=dev)
    # (H, F) of a pass's last query row per (group, column, thread group):
    # int32 or float pairs, or int16 pairs of pairs; freed to the caching
    # allocator on return, which reuses it only for work queued after this
    # launch on the same stream
    scratch = torch.empty((G, N, width, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sift4g_sw_grouped(
            q_codes_all.data_ptr(), q_codes_all.shape[0],
            q_offsets.data_ptr(), q_lens.data_ptr(),
            targets.data_ptr(), target_lens.data_ptr(), matrix32.data_ptr(),
            G, B, N, MODE_IDS[mode], int(gap_open), int(gap_extend), ACC_IDS[acc], T, block,
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_grouped kernel launch failed: CUDA error {rc}")
    global kernel_launches, i16_launches, f32_launches
    if acc == "i16":
        i16_launches += 1
    elif acc == "f32":
        f32_launches += 1
    else:
        kernel_launches += 1
    return out


def sw_scores_grouped_resident(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32
    db: torch.Tensor,            # (R,) uint8 resident database
    t_starts: torch.Tensor,      # (G, B) int64 byte starts, 16-byte aligned
    target_lens: torch.Tensor,   # (G, B) int32, each <= n_pad
    matrix32: torch.Tensor,      # (32, 32) int32
    n_pad: int,                  # the window (the length rung)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    threads_per_target: int | None = None,
) -> torch.Tensor:
    """Scores (G, B) int32: group g = query g against the rows of the
    resident database at ``t_starts[g]``, each ``target_lens[g, b]`` long.
    ``threads_per_target`` forces the kernel's T, as for
    :func:`sw_scores_grouped`.

    On a card the starts are checked without a host sync: a start that is
    misaligned, negative or whose ``n_pad`` window leaves the database
    fails a device-side assertion (the kernel also scores such a row as
    empty, so it never reads out of bounds)."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown alignment mode {mode!r}")
    _threads_checked(threads_per_target)
    dev = db.device
    if dev.type == "cpu":
        return scan.align_scores_grouped_resident(
            q_codes_all, q_offsets, q_lens, db, t_starts, target_lens, matrix32, n_pad,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        )
    if dev.type != "cuda":
        raise ValueError(f"sw_scores_grouped_resident runs on cpu or cuda, not {dev}")
    G, B = t_starts.shape
    N = int(n_pad)
    _check("q_codes_all", q_codes_all, torch.int32, (q_codes_all.numel(),), dev)
    _check("q_offsets", q_offsets, torch.int32, (G,), dev)
    _check("q_lens", q_lens, torch.int32, (G,), dev)
    _check("db", db, torch.uint8, (db.numel(),), dev)
    _check("t_starts", t_starts, torch.int64, (G, B), dev)
    _check("target_lens", target_lens, torch.int32, (G, B), dev)
    _check("matrix32", matrix32, torch.int32, (32, 32), dev)
    if N <= 0 or N % 16 or db.data_ptr() % 16:
        raise ValueError("n_pad must be a positive multiple of 16 and db 16-byte aligned")
    if G > 65535:
        raise ValueError(f"{G} groups exceed the launch grid (65535)")
    if G and B:
        torch._assert_async(
            ((t_starts & 15) == 0).all()
            & (t_starts >= 0).all()
            & (t_starts.max() <= db.numel() - N)
        )

    T, block = launch_geometry(G, B, N, dev, threads_per_target)
    lib = _build.load()
    out = torch.empty((G, B), dtype=torch.int32, device=dev)
    scratch = torch.empty((G, N, B, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sift4g_sw_grouped_resident(
            q_codes_all.data_ptr(), q_codes_all.shape[0],
            q_offsets.data_ptr(), q_lens.data_ptr(),
            db.data_ptr(), db.numel(), t_starts.data_ptr(),
            target_lens.data_ptr(), matrix32.data_ptr(),
            G, B, N, MODE_IDS[mode], int(gap_open), int(gap_extend), T, block,
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_grouped_resident kernel launch failed: CUDA error {rc}")
    global resident_launches
    resident_launches += 1
    return out


def _balanced(strips: int, warps: int) -> int:
    """The fewest warps that run ``strips`` strips in as many turns as
    ``warps`` warps do (no turn with idle warps where fewer do)."""
    return -(-strips // -(-strips // warps))


def long_geometry(G: int, B: int, N: int, sm_count: int, warps_per_block=None,
                  cluster=None, targets=None, rows=None):
    """(strips, warps, cluster, blocks) of a K2 launch of G groups of B
    targets on an N-wide rung, on a card of ``sm_count`` SMs: the strips
    of ``LONG_STRIP`` columns that cover N, the warps of a block, the
    blocks of the cluster that scores one target, and the blocks.
    ``targets``: how many of the G x B rows hold a target (all of them by
    default); a row of length 0 ends its cluster at once.  ``rows``: the
    launch's longest query (unknown by default).

    A launch of fewer targets than SMs, of targets wider than one block's
    warps (16 strips), against a query of ``LONG_CLUSTER_ROWS`` rows or
    more, spreads each target over a cluster of blocks, three quarters of
    the SMs a target has to itself (at most ``MAX_LONG_CLUSTER``; a
    cluster of 4 blocks of 8 or 16 warps on 32 targets took twice as long
    as one of 3 on an H100: the card could not place them all at once),
    each block one warp a strip and at most 8 warps; a target of more
    strips than that runs them in balanced turns.  A cluster takes a
    target's strips in fewer turns, or on fewer warps an SM, which pays
    where the query's rows, not the wavefront's lag of 32 steps a strip,
    fill the chain; the ring between blocks publishes its rows in
    batches, and against a shorter query (or an unknown one) one block
    was faster.  Any other launch keeps one block a target, one
    warp a strip (at most ``MAX_LONG_WARPS``).  Only a launch of 6 targets
    an SM or more (1,024 full targets and up on an H100) gives a target 4
    warps, taking its strips in balanced turns (many blocks an SM hide
    each other's wavefronts); the long-tail run's ragged launches of up to
    a few hundred targets ran slower so.  These were the best splits, or
    close to them, on the launches of ``chip_smoke.py`` phases 3b and 4c,
    which print every split at K2's launch shapes, time the cluster
    against one block at several query lengths and time each long-tail
    launch.
    ``warps_per_block`` forces the warps (1 to ``MAX_LONG_WARPS``),
    ``cluster`` the blocks a cluster (1 to ``MAX_LONG_CLUSTER``)."""
    strips = -(-N // LONG_STRIP)
    targets = max(1, G * B if targets is None else min(int(targets), G * B))
    if cluster is None:
        cl = 1
        if (targets < sm_count and strips > MAX_LONG_WARPS and rows is not None
                and rows >= LONG_CLUSTER_ROWS):
            cl = max(1, min(MAX_LONG_CLUSTER, 3 * sm_count // (4 * targets)))
    else:
        if isinstance(cluster, bool) or cluster not in range(1, MAX_LONG_CLUSTER + 1):
            raise ValueError(f"cluster must be 1 to {MAX_LONG_CLUSTER}, got {cluster!r}")
        cl = int(cluster)
    if warps_per_block is None:
        if cl > 1:
            warps = -(-_balanced(strips, 8 * cl) // cl)
        elif targets >= 6 * sm_count:
            warps = _balanced(strips, 4)
        else:
            warps = min(strips, MAX_LONG_WARPS)
    else:
        if isinstance(warps_per_block, bool) or warps_per_block not in range(
                1, MAX_LONG_WARPS + 1):
            raise ValueError(f"warps_per_block must be 1 to {MAX_LONG_WARPS}, got "
                             f"{warps_per_block!r}")
        warps = int(warps_per_block)
    return strips, warps, cl, G * B * cl


def sw_scores_grouped_long(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32, each <= m_cap
    targets: torch.Tensor,       # (G, B, N) int8 codes, N a multiple of n_chunk
    target_lens: torch.Tensor,   # (G, B) int32, each <= N
    matrix32: torch.Tensor,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    n_chunk: int = 512,
    m_cap: int | None = 2048,
    warps_per_block: int | None = None,
    cluster: int | None = None,
    live_targets: int | None = None,
    longest_query: int | None = None,
) -> torch.Tensor:
    """K2, the long-target scorer: scores (G, B) int32 of group g's query
    against its B targets, the function of ``sw_scores_grouped`` (and of
    ``sift4g_tpu/align/pallas_sw.py:sw_scores_pallas_grouped_long``).
    Its plain version is ``scan.align_scores_grouped``.

    The JAX wrapper's contract holds: N a multiple of ``n_chunk`` and
    every query at most ``m_cap`` rows; both size nothing in the kernel.
    An unknown mode or an N off the chunk grid raise before any work, and
    so does a query past ``m_cap`` where the lengths lie on the host (CPU
    tensors).  Lengths on the card are not checked against ``m_cap``: the
    kernel needs no bound, and a check there would cost a host sync or a
    device assertion that ends the process's CUDA context.  ``m_cap=None``
    (the port's callers, which hold no bound) checks nothing.
    ``warps_per_block`` and ``cluster`` force the kernel's warps a block
    and blocks a cluster; ``live_targets`` (the rows of length > 0) and
    ``longest_query`` (the longest of ``q_lens``), which a caller holding
    the lengths on the host knows, inform them (:func:`long_geometry`).
    The plain version ignores all four.  A
    cluster the card cannot place is refused by the launch, and the call
    raises."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown alignment mode {mode!r}")
    G, B, N = targets.shape
    if n_chunk <= 0 or N % n_chunk:
        raise ValueError(f"N = {N} must be a multiple of n_chunk = {n_chunk}")
    dev = targets.device
    # checks the forced geometry on any device; the SM count only matters
    # on the card
    long_geometry(G, B, N, 1, warps_per_block, cluster)
    if dev.type == "cpu":
        if m_cap is not None and G and int(q_lens.max()) > m_cap:
            raise ValueError(f"a query of {int(q_lens.max())} rows exceeds m_cap = {m_cap}")
        return scan.align_scores_grouped(
            q_codes_all, q_offsets, q_lens, targets, target_lens, matrix32,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        )
    if dev.type != "cuda":
        raise ValueError(f"sw_scores_grouped_long runs on cpu or cuda, not {dev}")
    _check("q_codes_all", q_codes_all, torch.int32, (q_codes_all.numel(),), dev)
    _check("q_offsets", q_offsets, torch.int32, (G,), dev)
    _check("q_lens", q_lens, torch.int32, (G,), dev)
    _check("targets", targets, torch.int8, (G, B, N), dev)
    _check("target_lens", target_lens, torch.int32, (G, B), dev)
    _check("matrix32", matrix32, torch.int32, (32, 32), dev)
    if N % 16 or targets.data_ptr() % 16:
        raise ValueError("targets rows must be 16-byte multiples on a 16-byte aligned base")
    if G > 65535:
        raise ValueError(f"{G} groups exceed the launch grid (65535)")
    if gap_open < 0 or gap_extend < 0:
        raise ValueError("gap penalties must be >= 0")

    index = torch.cuda.current_device() if dev.index is None else dev.index
    _, warps, cl, _ = long_geometry(G, B, N, _sm_count(index), warps_per_block, cluster,
                                    live_targets, longest_query)
    lib = _build.load()
    out = torch.empty((G, B), dtype=torch.int32, device=dev)
    # with strips in turn: each strip's bottom (H, F) row between row tiles
    nbytes = lib.sift4g_sw_long_scratch_bytes(G, B, N, warps, cl)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sift4g_sw_grouped_long(
            q_codes_all.data_ptr(), q_codes_all.shape[0],
            q_offsets.data_ptr(), q_lens.data_ptr(),
            targets.data_ptr(), target_lens.data_ptr(), matrix32.data_ptr(),
            G, B, N, MODE_IDS[mode], int(gap_open), int(gap_extend), warps, cl,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_grouped_long kernel launch failed: CUDA error {rc}")
    global long_launches
    long_launches += 1
    return out


def sw_scores_single(
    query_codes: torch.Tensor,   # (m_pad,) int32, PAD_CODE past the query
    query_len,                   # int, or a 1-element int32 tensor
    targets: torch.Tensor,       # (B, N) int32 codes, any N
    target_lens: torch.Tensor,   # (B,) int32, each <= N
    matrix32: torch.Tensor,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
    threads_per_target: int | None = None,
) -> torch.Tensor:
    """Scores (B,) int32 of the query ``query_codes[:query_len]`` against
    each ``targets[b, :target_lens[b]]``.  A tensor ``query_len`` is read
    on the card, so a caller holding it there never waits for the host.
    ``threads_per_target`` forces the kernel's T, as for
    :func:`sw_scores_grouped`."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown alignment mode {mode!r}")
    _threads_checked(threads_per_target)
    dev = targets.device
    if dev.type == "cpu":
        return scan.align_scores(
            query_codes, query_len, targets, target_lens, matrix32,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        )
    if dev.type != "cuda":
        raise ValueError(f"sw_scores_single runs on cpu or cuda, not {dev}")
    if not isinstance(query_len, torch.Tensor):
        query_len = torch.full((1,), int(query_len), dtype=torch.int32, device=dev)
    query_len = query_len.reshape(1)
    B, N = targets.shape
    _check("query_codes", query_codes, torch.int32, (query_codes.numel(),), dev)
    _check("query_len", query_len, torch.int32, (1,), dev)
    _check("targets", targets, torch.int32, (B, N), dev)
    _check("target_lens", target_lens, torch.int32, (B,), dev)
    _check("matrix32", matrix32, torch.int32, (32, 32), dev)

    T, block = launch_geometry(1, B, N, dev, threads_per_target)
    lib = _build.load()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    # the tiled body's [g][j][b] scratch at G = 1
    scratch = torch.empty((N, B, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sift4g_sw_single(
            query_codes.data_ptr(), query_codes.shape[0], query_len.data_ptr(),
            targets.data_ptr(), target_lens.data_ptr(), matrix32.data_ptr(),
            B, N, MODE_IDS[mode], int(gap_open), int(gap_extend), T, block,
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_single kernel launch failed: CUDA error {rc}")
    global single_launches
    single_launches += 1
    return out

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (DIR: another checkout of the port, such as the parent
commit unpacked with ``git archive``) also imports DIR's package under a
name of its own, builds DIR's kernels through DIR's own wrappers and
times its K1, K2, K3, K4 and K5 beside this checkout's, in turns
(parent, this, this, parent) on the same inputs, in phases 3, 3b (the
parent's K2 against this K2 at K2's launch shapes, and this K2 at every
split of its strips), 4c (each K2 launch of the long-tail run against
the parent's K2), 5, 5b, 6 and 9b (and prints, in phase 1, which scorer
kernels' and K6's SASS is the parent's): K1, K3, K4 and K5 must stay
within 3 % of the parent's in phases 3, 5, 5b, 6 and 9b, and K2 no more
than 3 % slower than the parent's in 3b and 4c.

Phases, in order; the first failure ends the run with a non-zero exit:

1. device and build: versions, the card's name and power limit, and the
   build of the CUDA kernels from ``sift4g_tpu_torch/csrc`` (one nvcc per
   source, started together);
2. K1 (target slabs) against its plain PyTorch version on the card,
   exact, in all four alignment modes, at the T (threads per target)
   its geometry rule picks and at every forced T: ragged lengths with
   garbage tails, zero-length rows, a zero-length group, a 4096-wide rung
   and an 8192-residue query; then the pass boundaries of the tiled body
   (query lengths 0, 1, 8192 and T x 16 - 1, T x 16, T x 16 + 1 for every
   T; target lengths 0, 1, 15, 16, 17 and N; gaps 10/1 and 11/2); the
   E-value screen's words must agree too;
2b. K3 (the resident database) against its plain version, exact, in all
   four modes, at its own and at every forced T: ragged lengths,
   zero-length rows, windows that run into the next sequence and past
   the last one, a 4096-wide rung, an 8192-residue query and the pass
   boundaries of phase 2; K3 also against K1 fed the same windows as a
   slab, and the screened words of all three;
3. K1 and its plain version timed with CUDA events at the bench launch
   shape (G=64 groups, B=1024 targets of 512 residues, a 360-residue
   query);
4. the port's CLI at Swiss-Prot scale (570,000 synthetic sequences, about
   200 M residues; 50 queries with 20 substitutions each; default flags
   but ``--overlap off``, where ``--resident-db auto`` keeps the slab path
   at this query count; every CLI run of phases 4, 4b and 9d names
   ``--overlap off``, because ``auto`` may overlap on the host, and an
   overlapped run never takes the resident path)
   with ``--backend cuda``, held byte for byte to ``--backend native``,
   and a matrix-mode pass on 5 queries held the same way.  K1's launch
   counter must show the main path went through it;
4c. the long tail: phase 4's database plus about 2,000 sequences of
   2,049 to 35,213 residues (one in eight holding a mutated query
   segment) and a family of 1,500 long proteins holding the first query,
   the 50-query CLI run with ``--backend cuda`` byte-identical to
   ``--backend native``; K2's launches counted (more than 0), each held
   to its plain version on its own inputs and (under ``--parent``) timed
   against the parent's K2 in turns, and the largest launch of each rung
   timed against K1 on the same inputs in turns; the family's wide
   launch must go to K1, held to its plain version and timed against K2;
   every launch's pick within 1.25x of the other kernel;
4b. the resident path: the same 50-query run with ``--resident-db on``,
   byte-identical to phase 4's ``--backend native`` outputs; then 300
   queries (the 50 and 250 database sequences, 20 substitutions each) at
   default flags, where ``auto`` must pick the resident database, held
   byte for byte to ``--resident-db off`` on the same queries.  The
   300-query runs go off, auto (cold: the upload is made), auto (warm:
   the live upload is reused), off.  Every resident run must launch K3
   and call no plain version on the card; upload time and bytes, the
   phase tables and align GCUPS are printed;
5. every K1 launch of phase 4's run held to the plain version on its own
   inputs (the packed slabs, uninitialized tails included), exact, and the
   largest of them timed, kernel and plain version, with CUDA events,
   beside its design bound ((16 + 1) / (16 T) bytes per cell);
5b. every K3 launch of phase 4b's cold default-flag run held the same
   way, and the largest timed, with K1 on the same windows as a slab;
3b. (run after phase 3) K2, the long-target kernel (a target's strips of
   512 columns over the warps of a thread-block cluster, query rows
   streamed through them), against its plain version, exact, in all four
   modes: at its edges (N of 5 whole strips, of 4.56, of 8 and of 9;
   query lengths 0, 1, 2, 31, 32, 33, 63, 64, 65, 511, 512, 513 and
   1,025; target lengths 0, 1, 15, 16, 17, 511, 512, 513, 1,023, 1,024,
   1,025, N - 1 and N; gaps 10/1, 11/2 and 1/3) at every split of the
   strips over a cluster's blocks and warps (``long_splits``: one block
   of 1 to 16 warps, clusters of 2 to 8 one-warp blocks, 16 one-warp
   blocks, 8 blocks of 16 warps), then at K2's launch shapes (256
   targets of 8,192 residues and 32 Titin-class targets of 35,008, a
   360-residue query each, the Titin-class targets against a 1,500-residue
   query, and one like 4c's largest K2 launch) at every split; timed there against its plain version and this tree's K1 in
   turns and, under --parent, against the parent's K2 (every split
   timed too): K2 must beat K1 and the plain version and stay within 3 %
   of the parent's K2; then the K1/K2 crossover, one group of 64 to
   4,096 full targets at each rung from 3,072 to 8,192 and queries of
   360 and 1,500 rows, K2 equal to K1 on each and timed against it in
   turns: the aligner's route (``batch._long_route``) must pick the
   faster or one within 1.05x of it;
6. K5, the row-engine probe (columns in registers, query rows streamed
   through a lane wavefront), against its plain version, exact: the JAX
   shape B=1024 N=512 at 300 rows and at the bench's 16,000
   (``bench.B1024_ROWS``), B=65,536 at 64 rows, a ragged N=200
   with gaps 11/2, B=2048 N=1100 at 600 rows; then its strip and
   wavefront edges: N in {1, 15, 16, 17, 511, 512, 513, 1100, 6144} x
   rows in {0, 1, 2, 31, 32, 33} x gaps 10/1, 11/2 and 1/3 (go < ge) x
   (B, salt) in {(1, 2^20), (33, -2^20), (33, 5)}, and past one strip
   rows 511, 512, 513 and 1025 around the row tiles.  Then K5 timed at
   the bench's shape (B=65,536 N=512, 360 rows), that launch exact
   against its plain version, beside its operations
   bound, K1's bench-launch rate (phase 3) over K5's, K5 at B=1024 at
   1,000, 4,000 and 16,000 rows, the opcodes of every loop of K5 that
   runs whole step pairs (from ``cuobjdump -sass``; the steady-state loop
   must hold a fused ``VIADDMNMX``), and the bench's marginal rates (B=1024
   over ``bench.B1024_ROWS``, B=65,536 over ``bench.B65536_ROWS``) with
   the card's clocks and power;
7. K6, the int32 probes, against their plain version for 1, 2 and 4
   pairs, exact, and its int16 form (two elements a register, the packed
   DPX forms of K1's int16 accumulator) the same way and where its values
   wrap; then ``bench_ab roofline``,
   ``roofline2``, ``roofline4`` and ``roofline16`` (counted: these are
   K6's path), each rate beside the card's peak int32 rate as a check of
   it (the int16 form's: whether the packed forms issue at the int32
   rate), and the opcodes of each variant's loop from ``cuobjdump -sass``.  The
   operations bound of every kernel divides the max-family instructions
   its work needs (``roofline.MAX_INSTRUCTIONS_PER_CELL`` a DP cell: 4.5
   in SW, 4 in the other modes; 2 per element and round of K6) by the
   card's peak max-family rate (64 a clock per SM x SMs x the maximum SM
   clock), or by K6's measured rate should that be higher;
8. the bench twin end to end (``python -m sift4g_tpu_torch.bench`` in a
   subprocess with JAX and the JAX package unimportable): its record must
   name the card, be within 10 % of phase 3's K1 rate and have
   ``0 < roofline_pct <= 105`` (of the card's operations bound for an SW
   cell); its K5 launches are K5's count;
9. (run after phase 4b, on its database) several devices and K4.  The
   device list is every visible card, or ``[cuda:0, cuda:0]`` (two shards
   of the one card) on a one-card host.
   9a. K4 (one query against int32 rows, on the tiled body) against its
       plain version, exact, in all four modes, at the T its geometry
       rule picks and at every forced T: ragged lengths with zero-length
       rows and int32 garbage from the whole int32 range past every
       length, N=200, B=1 with N=37 (the loader's scalar tail, with no
       row after it), an 8,192-residue query, gaps 11/2, and the pass
       boundaries (queries of 0, 1, 8,192 and T x 16 - 1, T x 16,
       T x 16 + 1 for every T; targets of 0, 1, 15, 16, 17 and N);
   9b. K4 at full width, timed with CUDA events: a 360-residue query
       against 65,536 targets of 512 residues (K5's bench shape, the
       cells and the launch of phase 3's K1), exact against the plain
       version, which is timed too, beside its design bound
       ((16 + 4) / (16 T) bytes per cell);
   9c. every factory of ``parallel/sharded.py`` on the device list, exact
       against the unsharded kernel on the same inputs:
       ``make_sharded_scores``, ``make_sharded_topk_align`` (k=64),
       ``make_grouped_sharded`` with and without the screen,
       ``make_grouped_resident_sharded``, ``make_grouped_long_sharded``
       (G=1, B=256, N=8,192; K2 on every shard) and
       ``make_sharded_pipeline_step`` on a
       (2, 2) grid.  Each factory's launches are counted with the counters
       set to 0 just before it and read just after (its reference is
       computed outside that window); no plain version may run on the
       card; K4's count is the sum over its three factories, the path K4
       runs on;
   9d. the main path across the devices at Swiss-Prot scale, on phase 4's
       50 queries: the CLI with ``--cards`` naming every visible card, at
       default flags and with ``--resident-db on``, and on a one-card host
       ``run_pipeline`` on ``[cuda:0, cuda:0]`` both ways; every output
       byte-identical to phase 4's ``--backend native``.
10. (run after phase 9, on phase 4's database) device predict and the
   overlapped schedule, which launch no kernel of their own.
   10a. the float32 scoring math (``sift/scores_torch.py``) on the card
       against its CPU run and the float64 oracle (rtol 2e-3, atol 2e-4;
       the count of different letters exact) on the reference test's
       shapes and a 64-query chunk of the predict mix; two card runs of
       the chunk bit-identical, and the same bits with TF32 switched on
       around the call;
   10b. the 50-query CLI run with ``--predict-backend device`` (and
       ``--overlap off``), byte-identical to phase 4's host-predict
       outputs, with device predict seen running on the card;
   10c. matrix mode on phase 4's 5 queries with device predict, twice:
       the two runs bit-identical, every printed value within 1.5e-4 (a
       printed digit) of phase 4's host oracle;
   10d. ``--overlap on`` with host and with device predict, each
       byte-identical to phase 4's two-phase outputs, on the slab path;
       and whether ``--overlap auto`` overlaps on this host, with its
       available cores.
11. (run after phase 10, on phase 4's database and 50 queries, every job
   ``--overlap off``) the serve daemon on the card: the port's
   ``--serve SOCK`` in a subprocess (through ``chip_smoke.py --counted``,
   which counts the kernel launches of each job), jobs through the
   port's ``--connect`` client: ``--resident-db on`` twice, then default
   flags, then a bad job (``--kmer-length 7``: status -1, and the daemon
   serves on), then ``--shutdown`` (the daemon exits 0 and its socket is
   gone).  Every job's files byte-identical to phase 4's ``--backend
   native``; the second job must find the first job's resident database
   (the same object in the daemon, no second upload); the cold and warm
   jobs' ``elapsed_s`` are printed beside phase 4's one-shot CLI time;
12. (same data) multi-host on one card: two processes of the port's CLI
   joined over gloo on 127.0.0.1, both on ``cuda:0``, with
   ``--mh-shard db`` at default flags (K1 on each shard, K3 where
   ``auto`` takes it; each host's launches are printed) and ``--mh-shard
   queries``; both byte-identical to phase 4's ``--backend native``; host
   0's phase seconds are printed.
13. (run after phase 3) K1's int16 and float32 accumulators (``acc="i16"``,
   the pair kernel of ``csrc/sw_pair16.cuh``; ``acc="f32"``): each exact
   against its plain version and K1 ``acc="int"`` in all four modes at
   every T, on odd batches (a pair with no partner), pairs of unequal
   lengths (0 and N among them), int8 garbage past every length, queries
   of several passes, the pass boundaries of every T with gaps 10/1 and
   11/2, and the largest admissible bound (623 x 12 + 10 + 513 = 7999);
   an inadmissible or unknown request refused before any launch; int
   against i16 in turns at the bench launch and at a main-like launch
   (G=36 B=4096 N=384, lengths 193-384), int against f32 at the bench
   launch; the packed instructions a cell pair of the int16 SW loop's
   SASS against those it needs; ``bench_ab ab`` (the int16 path, its
   launches counted) and ``make_grouped_sharded`` with ``acc="f32"``
   (the float32 path, counted) and ``"i16"`` on the device list.  The
   CLI's main path (phase 4) must launch neither form.

``python3 chip_smoke.py --counted ARGS`` runs the port's CLI on ARGS in
its process (what ``python -m sift4g_tpu_torch ARGS`` runs), with every
CLI run in it, each daemon job included, counting the scorer kernels'
launches; phases 11 and 12 start their processes so.

Each phase prints its seconds.  The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it the card's name and
power limit, and before that one JSON line with each kernel's launches,
error, times at its path's largest launch and bound.  The script imports
neither JAX nor the JAX package.
"""

import sys

sys.modules["jax"] = None          # the port must run without JAX ...
sys.modules["sift4g_tpu"] = None   # ... and without the JAX package

import contextlib  # noqa: E402
import filecmp  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
MODES = ("SW", "NW", "HW", "OV")
K1 = {
    "name": "sw_grouped",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_grouped.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:200",
}
K3 = {
    "name": "sw_grouped_resident",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_grouped_resident.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:774",
}
K2 = {
    "name": "sw_grouped_long",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_grouped_long.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:457",
}
K5 = {
    "name": "dp_row_probe",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/dp_row_roofline.cu",
    "replaces": "sift4g_tpu/align/roofline.py:44",
}
K4 = {
    "name": "sw_single",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_single.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:98",
}
K6 = {
    "name": "int32_probe",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/int32_roofline.cu",
    "replaces": "tools/bench_ab.py:95",
}
K1_I16 = {
    "name": "sw_grouped_i16",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_pair16.cuh",
    "replaces": "sift4g_tpu/align/pallas_sw.py:200",
}
K1_F32 = {
    "name": "sw_grouped_f32",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_tiled.cuh",
    "replaces": "sift4g_tpu/align/pallas_sw.py:200",
}
# H100 SXM device memory bandwidth from NVIDIA's datasheet
HBM_BYTES_PER_S = 3.35e12
# the int32 max-family instructions a second the operations bounds divide
# by: the card's peak (phase 1), raised in phase 7 to K6's measured rate
# should that be higher
INT32 = {"per_s": None, "src": ""}
# the K1/K3/K4/K5 wrappers of --parent DIR (load_parent), or None
PARENT = {"k": None}
# K1, K3 and K4 (and the kernels of --parent DIR) within this share of
# the parent's time in turns
PARENT_TOLERANCE = 0.03


def tiled_bytes_per_cell(T, code_bytes=1):
    """Device-memory bytes per cell of the tiled body: per column and pass
    of T x TILE_ROWS rows, 16 bytes of (H, F) scratch and the target's
    code (1 byte in K1/K3, 4 in K4's int32 rows)."""
    from sift4g_tpu_torch.align.sw_grouped import TILE_ROWS

    return (16 + code_bytes) / (T * TILE_ROWS)


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def random_matrix(rng) -> np.ndarray:
    """A symmetric (26, 26) substitution table in BLOSUM's range."""
    m = rng.integers(-4, 12, (26, 26))
    return np.triu(m) + np.triu(m, 1).T


def query_inputs(rng, qlens):
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    return q_all, offs, qlens


def grouped_inputs(rng, G, B, N, qlens, dev, zero_len=True):
    """Ragged grouped scorer inputs on the card: random int8 garbage past
    every target length and, with ``zero_len``, zero-length rows."""
    import torch

    q_all, offs, qlens = query_inputs(rng, qlens)
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(0 if zero_len else N, N + 1, size=(G, B)).astype(np.int32)
    if zero_len:
        lens[:, -1] = 0
        lens[0, 0] = N
    mask = np.arange(N)[None, None, :] < lens[..., None]
    targets[mask] = rng.integers(0, 26, int(mask.sum()))
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets, lens)]


def resident_inputs(rng, G, B, N, qlens, dev):
    """A resident database of G*B+9 ragged sequences (zero-length ones
    included, the last but one N long, the last 5 long) and (G, B) rows
    drawn from it in ascending order, the last sequence among them: its
    window runs past the data into the tail pad, and every shorter row's
    into the next sequences."""
    import torch
    from sift4g_tpu_torch.align.resident import ResidentDB

    n_seq = G * B + 9
    lens_seq = rng.integers(0, N + 1, n_seq).astype(np.int64)
    lens_seq[rng.integers(0, n_seq, 5)] = 0
    lens_seq[-2:] = (N, 5)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, dev)
    ids = np.sort(rng.choice(n_seq - 1, G * B, replace=False))
    ids[-1] = n_seq - 1
    ids = ids.reshape(G, B)
    host = query_inputs(rng, qlens) + (rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a).to(dev) for a in host]
    return q, o, ql, rdb.dev, st, tl


def phase_build():
    import torch

    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, ROOT)
    import sift4g_tpu_torch

    check(
        os.path.dirname(os.path.abspath(sift4g_tpu_torch.__file__)).startswith(ROOT),
        f"sift4g_tpu_torch imported from outside {ROOT}",
    )
    card = card_line()
    say(f"card: {card}  ({torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible)")
    from sift4g_tpu_torch.align import _build

    t0 = time.perf_counter()
    _build.load()
    sources = ", ".join(os.path.relpath(p, ROOT) for p in _build._sources())
    say(f"[1] built {sources} with nvcc in "
        f"{_build.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[1]   ptxas: {line.strip()}")
    from sift4g_tpu_torch.align import roofline

    rate, how = roofline.int32_max_rate()
    INT32.update(per_s=rate, src=f"peak, {how}")
    say(f"[1] int32 max-family rate of the operations bounds: {INT32['src']}")
    from sift4g_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    say(f"[1] native host library {os.path.relpath(native.library_path(), ROOT)} "
        f"ready in {time.perf_counter() - t0:.2f} s")
    return card


def _screen_equal(a, b, G, B):
    import torch
    from sift4g_tpu_torch.align import scan

    smin = torch.full((G,), 25, dtype=torch.int32, device=a.device)
    k = min(B, 400)
    return torch.equal(scan.screen_topk_words(a, smin, k), scan.screen_topk_words(b, smin, k))


def all_T():
    """The geometry's own T (None) and every forced T."""
    from sift4g_tpu_torch.align.sw_grouped import GROUP_THREADS

    return (None, *GROUP_THREADS)


EDGE = {}


def edge_set(dev):
    """The tiled body's pass boundaries, built once for phases 2 and 2b: a
    resident database whose rows in every group have lengths 0, 1, 15, 16,
    17 and N beside random ones (the last sequence, 5 long, among them:
    its window runs past the data), one group per query length (0, 1,
    8192, and T x 16 - 1, T x 16, T x 16 + 1 for every T), and K1's slab
    of the same windows."""
    import torch
    from sift4g_tpu_torch.align.resident import ResidentDB
    from sift4g_tpu_torch.align.sw_grouped import GROUP_THREADS, TILE_ROWS

    if EDGE:
        return EDGE
    rng = np.random.default_rng(2)
    N, B = 512, 32
    qlens = sorted({0, 1, 8192} | {T * TILE_ROWS + d for T in GROUP_THREADS for d in (-1, 0, 1)})
    G = len(qlens)
    lens_seq = rng.integers(0, N + 1, G * B).astype(np.int64)
    ids = np.arange(G * B).reshape(G, B)
    lens_seq[ids[:, :6]] = (0, 1, 15, 16, 17, N)
    lens_seq[-1] = 5
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, dev)
    host = query_inputs(rng, qlens) + (rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a).to(dev) for a in host]
    slab = rdb.dev[st[..., None] + torch.arange(N, device=dev)].view(torch.int8).contiguous()
    m32 = {}
    from sift4g_tpu_torch.align import scan

    for gaps in ((10, 1), (11, 2)):
        m32[gaps] = scan.matrix32_from_scorer(
            SimpleNamespace(matrix=random_matrix(rng)), dev)
    EDGE.update(args=(q, o, ql, rdb.dev, st, tl), slab=slab, N=N, B=B, qlens=qlens, m32=m32,
                refs={})
    return EDGE


def edge_ref(dev, mode, gaps):
    """The plain version on the edge set (cached per mode and gaps)."""
    from sift4g_tpu_torch.align import scan

    e = edge_set(dev)
    key = (mode, gaps)
    if key not in e["refs"]:
        q, o, ql, _, _, tl = e["args"]
        e["refs"][key] = scan.align_scores_grouped(
            q, o, ql, e["slab"], tl, e["m32"][gaps], mode=mode, gap_open=gaps[0],
            gap_extend=gaps[1])
    return e["refs"][key]


def phase_parity(dev):
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    rng = np.random.default_rng(0)
    cases = [
        # name, G, B, N, query lengths, gaps
        ("ragged", 6, 300, 512, (361, 0, 17, 128, 255, 1), (10, 1)),
        ("long rung", 2, 64, 4096, (300, 77), (11, 2)),
        ("8192-aa query", 1, 32, 512, (8192,), (10, 1)),
    ]
    max_err = 0
    for name, G, B, N, qlens, (go, ge) in cases:
        m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
        args = grouped_inputs(rng, G, B, N, qlens, dev)
        auto = sw_grouped.launch_geometry(G, B, N, dev)
        for mode in MODES:
            t0 = time.perf_counter()
            ref = scan.align_scores_grouped(*args, m32, mode=mode, gap_open=go, gap_extend=ge)
            for T in all_T():
                got = sw_grouped.sw_scores_grouped(*args, m32, mode=mode, gap_open=go,
                                                   gap_extend=ge, threads_per_target=T)
                torch.cuda.synchronize()
                err = int((got.long() - ref.long()).abs().max())
                max_err = max(max_err, err)
                check(got.shape == (G, B) and got.dtype == torch.int32,
                      f"{name} {mode} T={T}: shape/dtype")
                check(err == 0, f"{name} {mode} T={T}: kernel differs from twin by up to {err}")
                if T is None:
                    check(_screen_equal(got, ref, G, B), f"{name} {mode}: screened words differ")
            torch.cuda.synchronize()
            say(f"[2] {name:14s} {mode}: G={G} B={B} N={N} qlens={qlens}: kernel == twin at "
                f"its own (T, block) = {auto} and at every forced T (max |diff| 0, "
                f"{time.perf_counter() - t0:.2f} s)")
    e = edge_set(dev)
    q, o, ql, _, _, tl = e["args"]
    for gaps in ((10, 1), (11, 2)):
        for mode in MODES:
            t0 = time.perf_counter()
            ref = edge_ref(dev, mode, gaps)
            for T in all_T():
                got = sw_grouped.sw_scores_grouped(q, o, ql, e["slab"], tl, e["m32"][gaps],
                                                   mode=mode, gap_open=gaps[0],
                                                   gap_extend=gaps[1], threads_per_target=T)
                torch.cuda.synchronize()
                err = int((got.long() - ref.long()).abs().max())
                max_err = max(max_err, err)
                check(err == 0, f"pass boundaries {mode} gaps {gaps} T={T}: kernel differs "
                                f"from twin by up to {err}")
            say(f"[2] pass boundaries {mode} gaps {gaps[0]}/{gaps[1]}: G={len(e['qlens'])} "
                f"B={e['B']} N={e['N']} qlens={tuple(e['qlens'])}, target lengths 0, 1, 15, "
                f"16, 17, N and random: kernel == twin at every T (max |diff| 0, "
                f"{time.perf_counter() - t0:.2f} s)")
    return max_err


def phase_resident_parity(dev):
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    rng = np.random.default_rng(1)
    cases = [
        ("ragged", 6, 300, 512, (361, 0, 17, 128, 255, 1), (10, 1)),
        ("long rung", 2, 64, 4096, (300, 77), (11, 2)),
        ("8192-aa query", 1, 32, 512, (8192,), (10, 1)),
    ]
    max_err = 0
    for name, G, B, N, qlens, (go, ge) in cases:
        m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
        q, o, ql, db, st, tl = resident_inputs(rng, G, B, N, qlens, dev)
        # the tail pad is N bytes (the largest rung of this database)
        check(int(st.max()) + N > int(db.numel()) - N, f"{name}: no window reaches the tail pad")
        slab = db[st[..., None] + torch.arange(N, device=dev)].view(torch.int8).contiguous()
        for mode in MODES:
            t0 = time.perf_counter()
            kw = dict(mode=mode, gap_open=go, gap_extend=ge)
            ref = scan.align_scores_grouped_resident(q, o, ql, db, st, tl, m32, N, **kw)
            for T in all_T():
                got = sw_grouped.sw_scores_grouped_resident(q, o, ql, db, st, tl, m32, N,
                                                            threads_per_target=T, **kw)
                k1 = sw_grouped.sw_scores_grouped(q, o, ql, slab, tl, m32, threads_per_target=T,
                                                  **kw)
                torch.cuda.synchronize()
                err = int((got.long() - ref.long()).abs().max())
                max_err = max(max_err, err, int((got.long() - k1.long()).abs().max()))
                check(got.shape == (G, B) and got.dtype == torch.int32,
                      f"{name} {mode} T={T}: shape/dtype")
                check(err == 0, f"K3 {name} {mode} T={T}: differs from its plain version by up "
                                f"to {err}")
                check(torch.equal(got, k1), f"K3 {name} {mode} T={T}: differs from K1 on the "
                                            f"same windows")
                if T is None:
                    check(_screen_equal(got, ref, G, B) and _screen_equal(got, k1, G, B),
                          f"K3 {name} {mode}: screened words differ")
            say(f"[2b] {name:14s} {mode}: G={G} B={B} N={N} qlens={qlens}: K3 == plain == K1 "
                f"on the same windows at every T (max |diff| 0, {time.perf_counter() - t0:.2f} s)")
    e = edge_set(dev)
    q, o, ql, db, st, tl = e["args"]
    for gaps in ((10, 1), (11, 2)):
        for mode in MODES:
            t0 = time.perf_counter()
            ref = edge_ref(dev, mode, gaps)
            kw = dict(mode=mode, gap_open=gaps[0], gap_extend=gaps[1])
            for T in all_T():
                got = sw_grouped.sw_scores_grouped_resident(q, o, ql, db, st, tl, e["m32"][gaps],
                                                            e["N"], threads_per_target=T, **kw)
                k1 = sw_grouped.sw_scores_grouped(q, o, ql, e["slab"], tl, e["m32"][gaps],
                                                  threads_per_target=T, **kw)
                torch.cuda.synchronize()
                err = int((got.long() - ref.long()).abs().max())
                max_err = max(max_err, err)
                check(err == 0, f"K3 pass boundaries {mode} gaps {gaps} T={T}: differs from "
                                f"its plain version by up to {err}")
                check(torch.equal(got, k1), f"K3 pass boundaries {mode} gaps {gaps} T={T}: "
                                            f"differs from K1 on the same windows")
            say(f"[2b] pass boundaries {mode} gaps {gaps[0]}/{gaps[1]}: K3 == plain == K1 on "
                f"the same windows at every T (max |diff| 0, {time.perf_counter() - t0:.2f} s)")
    EDGE.clear()
    return max_err


def _time_ms(fn, iters, warmup):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parent_turns(tag, what, this, parent, iters, card, cells=None):
    """``this`` and ``parent`` (the kernels of --parent DIR) on the same
    inputs: equal outputs, then timed in turns (parent, this, this,
    parent).  Returns (parent ms, this ms), each the better of its two."""
    import torch

    check(torch.equal(parent(), this()), f"{what}: the parent's kernel gives other scores")
    t = {"parent": [], "this": []}
    for name, fn in (("parent", parent), ("this", this), ("this", this), ("parent", parent)):
        t[name].append(_time_ms(fn, iters, warmup=1))
    rate = (lambda ms: f" ({cells / ms / 1e6:.2f} GCUPS)") if cells else (lambda ms: "")
    say(f"[{tag}] {what}, {card}, in turns: parent {t['parent'][0]:.3f} then "
        f"{t['parent'][1]:.3f} ms{rate(min(t['parent']))}; this {t['this'][0]:.3f} then "
        f"{t['this'][1]:.3f} ms{rate(min(t['this']))}; speed-up "
        f"{min(t['parent']) / min(t['this']):.2f}x")
    return min(t["parent"]), min(t["this"])


def check_unmoved(what, parent_ms, this_ms):
    """A kernel whose algorithm this tree leaves alone stays within
    ``PARENT_TOLERANCE`` of the parent's time in turns."""
    moved = this_ms / parent_ms - 1
    check(abs(moved) <= PARENT_TOLERANCE,
          f"{what} moved {100 * moved:+.2f} % from the parent's (limit "
          f"{100 * PARENT_TOLERANCE:g} %)")


def load_parent(root):
    """The K1, K3, K4 and K5 wrappers of another checkout of the port at
    ``root``, its package imported under a name of its own: they build
    that checkout's kernels into its own build directory, bind them with
    its own C signatures and count launches in its own counters."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "sift4g_tpu_torch")
    init = os.path.join(pkg, "__init__.py")
    check(os.path.exists(init), f"--parent {root}: not a checkout of the port")
    name = "sift4g_tpu_torch_parent"
    spec = importlib.util.spec_from_file_location(name, init, submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    sw = importlib.import_module(f"{name}.align.sw_grouped")
    probes = importlib.import_module(f"{name}.align.roofline")
    build = importlib.import_module(f"{name}.align._build")
    build.load()
    return SimpleNamespace(k1=sw.sw_scores_grouped, k2=sw.sw_scores_grouped_long,
                           k3=sw.sw_scores_grouped_resident,
                           k4=sw.sw_scores_single, k5=probes.dp_row_probe,
                           library=build.library_path())


def sass_against_parent():
    """Each scorer kernel and K6 of this tree's library and of the
    parent's, its SASS instruction count, and whether it is the parent's
    instruction for instruction (a kernel whose source this tree leaves
    alone keeps it)."""
    from sift4g_tpu_torch.align import roofline

    this, par = roofline.library_sass(), roofline.library_sass(PARENT["k"].library)
    if this is None or par is None:
        say("[1] SASS: cuobjdump not found; not compared with the parent's")
        return
    # a kernel in an anonymous namespace (K6) is mangled with a hash that
    # differs from build to build
    anon = re.compile(r"\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
    this, par = ({anon.sub("_GLOBAL__N_", k): v for k, v in roofline.sass_instructions(x).items()}
                 for x in (this, par))
    for name in sorted(n for n in set(this) | set(par) if "sw_" in n or "int32_probe" in n):
        if name not in this:
            say(f"[1] SASS {name}: only in the parent's library")
        elif name not in par:
            say(f"[1] SASS {name}: {len(this[name])} instructions, not in the parent's library")
        else:
            same = "identical to" if this[name] == par[name] else "differs from"
            say(f"[1] SASS {name}: {len(this[name])} instructions, {same} the parent's "
                f"({len(par[name])})")


def phase_timing(dev, card):
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    G, B, N, m = 64, 1024, 512, 360
    rng = np.random.default_rng(42)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    args = grouped_inputs(rng, G, B, N, (m,) * G, dev, zero_len=False)

    def kernel():
        return sw_grouped.sw_scores_grouped(*args, m32)

    def twin():
        return scan.align_scores_grouped(*args, m32)

    err = int((kernel().long() - twin().long()).abs().max())
    check(err == 0, f"bench shape: kernel differs from twin by up to {err}")
    ms = _time_ms(kernel, iters=10, warmup=2)
    plain_ms = _time_ms(twin, iters=2, warmup=1)
    cells = G * B * N * m
    say(f"[3] bench shape G={G} B={B} N={N} m={m} ({cells / 1e9:.2f} G cells), {card}: "
        f"kernel {ms:.3f} ms = {cells / ms / 1e6:.2f} GCUPS at (T, block) = "
        f"{sw_grouped.launch_geometry(G, B, N, dev)}; twin {plain_ms:.3f} ms = "
        f"{cells / plain_ms / 1e6:.2f} GCUPS")
    if PARENT["k"]:
        check_unmoved("K1 at the bench launch", *parent_turns(
            "3", "K1 at the bench launch", kernel, lambda: PARENT["k"].k1(*args, m32), 10,
            card, cells))
    torch.cuda.synchronize()
    return err, cells / ms / 1e6


# K2's edges (tests/test_torch_gpu.py holds the same): target lengths on
# lane (16), strip (512) and N edges, 0 and 1; query lengths around the
# 32-lane wavefront (of row pairs: 64 rows), odd and even, and the 512-row
# tiles of strips in turn; N a whole number of strips, one that cuts the
# last, and 8 and 9 strips (a cluster's warps exactly, and one strip past
# them: strips in turn); gaps with go < ge
LONG_EDGE_QLENS = (0, 1, 2, 31, 32, 33, 63, 64, 65, 511, 512, 513, 1025)
LONG_EDGE_TLENS = (0, 1, 15, 16, 17, 511, 512, 513, 1023, 1024, 1025)
LONG_EDGE_N = (2560, 2336, 4096, 4608)
LONG_EDGE_GAPS = ((10, 1), (11, 2), (1, 3))
# the K1/K2 crossover grid of phase 3b: the long rungs up to 8,192,
# launches of 64 to 4,096 full targets (one group), a query of the CLI's
# mean length and one of three K1 passes
LONG_GRID_N = (3072, 4096, 6144, 8192)
LONG_GRID_B = (64, 256, 1024, 4096)
LONG_GRID_M = (360, 1500)
# the aligner's pick between K1 and K2 may take this much longer than the
# other kernel: on the grid's full launches (near the crossover the two
# are within it of each other), and on the long-tail run's launches, whose
# mixed query and target lengths the route weighs more coarsely
ROUTE_SLACK = 1.05
TAIL_ROUTE_SLACK = 1.25
# K2's launch shapes (phase 3b; name, G, B, N, query rows): 256 targets
# of 8,192 residues, 32 Titin-class targets (and the same against a query
# of three K1 passes, where a cluster's shorter steps count for more
# rows), and one like phase 4c's largest K2 launch (11 groups of 256 slots
# on the 24,576 rung, 387 targets of 2,049-24,576 residues, queries of
# 180-330 residues)
LONG_SHAPES = (("long-target", 1, 256, 8192, 360), ("Titin-class", 1, 32, 35008, 360),
               ("Titin-class, 1,500 rows", 1, 32, 35008, 1500),
               ("4c-like", 11, 256, 24576, None))


# the cluster against one block a target (phase 3b): launches of fewer
# targets than SMs, of Titin-class targets and of the 16,384 and 24,576
# rungs, where the geometry's cluster spans 2 to 8 blocks, against queries
# from half the CLI's mean length to four K1 passes, around
# LONG_CLUSTER_ROWS and the kernel's 512-row tiles
CLUSTER_ROWS_N = (16384, 24576, 35008)
CLUSTER_ROWS_B = (4, 16, 24, 32, 48)
CLUSTER_ROWS_M = (180, 256, 360, 420, 512, 640, 768, 1024, 1500, 2048)
# K2's keywords that only inform its geometry (the parent's K2 takes none)
K2_HINTS = ("live_targets", "longest_query")


def _geometry_of(sms, args, kw):
    """K2's geometry on a recorded launch, from the hints it was given."""
    from sift4g_tpu_torch.align import sw_grouped

    G, B, N = args[3].shape
    return sw_grouped.long_geometry(G, B, N, sms, targets=kw.get("live_targets"),
                                    rows=kw.get("longest_query"))


def _cluster_against_one_block(rng, m32, sms, dev, card):
    """3b: at each launch and query length of the CLUSTER_ROWS grid, the
    cluster K2's geometry spreads a target over against one block a
    target, in turns, both equal; the geometry's pick (it reads the
    longest query) must be the faster or within ROUTE_SLACK of it."""
    import torch
    from sift4g_tpu_torch.align import sw_grouped

    points = []
    for N in CLUSTER_ROWS_N:
        for B in CLUSTER_ROWS_B:
            _, w_cl, cl, _ = sw_grouped.long_geometry(1, B, N, sms, rows=1 << 30)
            _, w_one, _, _ = sw_grouped.long_geometry(1, B, N, sms, rows=0)
            for m in CLUSTER_ROWS_M:
                args = grouped_inputs(rng, 1, B, N, (m,), dev, zero_len=False)

                def one():
                    return sw_grouped.sw_scores_grouped_long(*args, m32, n_chunk=64, m_cap=None,
                                                             cluster=1, warps_per_block=w_one)

                def many():
                    return sw_grouped.sw_scores_grouped_long(*args, m32, n_chunk=64, m_cap=None,
                                                             cluster=cl, warps_per_block=w_cl)

                check(torch.equal(one(), many()), f"K2 on one block and on a cluster differ at "
                                                  f"B={B} N={N} m={m}")
                one_ms, cl_ms = _turns(one, many, 3)
                picks_cl = sw_grouped.long_geometry(1, B, N, sms, rows=m)[2] > 1
                points.append((N, B, m, one_ms, cl_ms, picks_cl))
                say(f"[3b] cluster G=1 B={B} N={N} m={m} (full targets), {card}: one block of "
                    f"{w_one} warps {one_ms:.3f} ms, a cluster of {cl} x {w_cl} warps "
                    f"{cl_ms:.3f} ms in turns ({one_ms / cl_ms:.2f}x); the geometry picks "
                    f"{'the cluster' if picks_cl else 'one block'}")
                del args
    for picks_cl in (True, False):
        gains = [one_ms / cl_ms for _, _, _, one_ms, cl_ms, p in points if p == picks_cl]
        say(f"[3b] cluster grid: the geometry picks {'the cluster' if picks_cl else 'one block'} "
            f"at {len(gains)} of {len(points)} launches, where one block's time over the "
            f"cluster's is {min(gains, default=0):.2f}-{max(gains, default=0):.2f}x")
    for N, B, m, one_ms, cl_ms, picks_cl in points:
        picked, other = (cl_ms, one_ms) if picks_cl else (one_ms, cl_ms)
        check(picked <= ROUTE_SLACK * other,
              f"the geometry's {'cluster' if picks_cl else 'one block'} at B={B} N={N} m={m} "
              f"takes {picked:.3f} ms against {other:.3f} ms")


def long_splits(N):
    """(cluster, warps a block) of K2 at every split of N's strips: the
    geometry's own, one block of 1 to min(strips, 16) warps and of 16
    (idle warps), clusters of 2 to 8 one-warp blocks (every ring between
    blocks; strips in turn past the cluster's warps), 2 blocks of 2 and 4
    of 4 warps, and 8 blocks of 16 (idle blocks)."""
    from sift4g_tpu_torch.align import sw_grouped

    strips = -(-N // sw_grouped.LONG_STRIP)
    top = min(strips, sw_grouped.MAX_LONG_WARPS)
    return ((None, None), *((1, w) for w in range(1, top + 1)),
            *(((1, sw_grouped.MAX_LONG_WARPS),) if top < sw_grouped.MAX_LONG_WARPS else ()),
            *((c, 1) for c in range(2, sw_grouped.MAX_LONG_CLUSTER + 1)),
            (2, 2), (4, 4), (sw_grouped.MAX_LONG_CLUSTER, sw_grouped.MAX_LONG_WARPS))


def _k2_against_plain(what, args, m32, ref, splits, **kw):
    """K2 at each forced (cluster, warps) on ``args``, each launch equal to
    ``ref``."""
    import torch
    from sift4g_tpu_torch.align import sw_grouped

    for cl, w in splits:
        got = sw_grouped.sw_scores_grouped_long(*args, m32, cluster=cl, warps_per_block=w, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max()) if ref.numel() else 0
        check(err == 0, f"K2 {what}, cluster={cl} warps={w}: differs from its plain version by "
                        f"{err}")


def _turns(a, b, iters):
    """``a`` and ``b`` timed in turns (a, b, b, a); each its better time."""
    ta, tb = [], []
    for fn, out in ((a, ta), (b, tb), (b, tb), (a, ta)):
        out.append(_time_ms(fn, iters, warmup=1))
    return min(ta), min(tb)


def _long_shape_inputs(rng, G, B, N, m, dev):
    """K2's launch shapes: full targets and queries of m residues, or
    (m None: the 4c-like shape) 387 ragged targets among G x B slots and
    queries of 180-330 residues."""
    import torch

    if m is not None:
        return grouped_inputs(rng, G, B, N, (m,) * G, dev, zero_len=False)
    q_all, offs, qlens = query_inputs(rng, rng.integers(180, 331, G))
    lens = np.zeros((G, B), np.int32)
    live = rng.choice(G * B, 387, replace=False)
    lens.flat[live] = np.exp(rng.uniform(np.log(2049), np.log(N + 1), 387)).astype(np.int32)
    targets = np.zeros((G, B, N), np.int8)
    for i in live:
        g, b = divmod(int(i), B)
        targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets, lens)]


def phase_long_rungs(dev, card):
    """3b: K2, the long-target kernel, against its plain version at its
    edges at every split of their strips over a cluster's blocks and
    warps, then at its launch shapes (every split again), timed there
    beside its plain version and this tree's K1 in turns (under --parent,
    against the parent's K2 too, and every split timed), then the K1/K2
    grid and the aligner's route on it."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    rng = np.random.default_rng(3)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    t0 = time.perf_counter()
    n_launch = 0
    for N in LONG_EDGE_N:
        lens = rng.integers(0, N + 1, (len(LONG_EDGE_QLENS), 16))
        lens[:, : len(LONG_EDGE_TLENS)] = LONG_EDGE_TLENS
        lens[:, -2:] = (N - 1, N)
        q_all, offs, qlens = query_inputs(rng, LONG_EDGE_QLENS)
        targets = rng.integers(-128, 128, (*lens.shape, N)).astype(np.int8)
        mask = np.arange(N)[None, None, :] < lens[..., None]
        targets[mask] = rng.integers(0, 26, int(mask.sum()))
        args = [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets,
                                                      lens.astype(np.int32))]
        for mode in MODES:
            for go, ge in LONG_EDGE_GAPS:
                kw = dict(mode=mode, gap_open=go, gap_extend=ge)
                ref = scan.align_scores_grouped(*args, m32, **kw)
                _k2_against_plain(f"edges N={N} {mode} gaps {go}/{ge}", args, m32, ref,
                                  long_splits(N), n_chunk=16, m_cap=max(LONG_EDGE_QLENS), **kw)
                n_launch += len(long_splits(N))
    say(f"[3b] K2 == plain at its edges: N in {LONG_EDGE_N} x queries {LONG_EDGE_QLENS} x "
        f"targets {LONG_EDGE_TLENS}, N - 1, N x gaps {LONG_EDGE_GAPS} x four modes x (cluster, "
        f"warps) {long_splits(LONG_EDGE_N[0])}: {n_launch} launches, max |diff| 0 "
        f"({time.perf_counter() - t0:.1f} s)")

    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, G, B, N, m in LONG_SHAPES:
        args = _long_shape_inputs(rng, G, B, N, m, dev)
        ref = scan.align_scores_grouped(*args, m32)
        _k2_against_plain(f"at the {name} shape", args, m32, ref, long_splits(N), n_chunk=64,
                          m_cap=None)

        # as the aligner counts them
        live, longest = int((args[4] > 0).sum()), int(args[2].max())

        def k2():
            return sw_grouped.sw_scores_grouped_long(*args, m32, n_chunk=64, m_cap=None,
                                                     live_targets=live, longest_query=longest)

        def k1():
            return sw_grouped.sw_scores_grouped(*args, m32)

        k1_ms, ms = _turns(k1, k2, 3)
        plain_ms = _time_ms(lambda: scan.align_scores_grouped(*args, m32), iters=1, warmup=0)
        nbytes, insns, true = _work("slab", args, {"mode": "SW"})
        strips, warps, cl, blocks = sw_grouped.long_geometry(G, B, N, sms, targets=live,
                                                             rows=longest)
        say(f"[3b] {name} G={G} B={B} N={N} ({true / 1e9:.3f} G cells, {live} targets), {card}: K2 "
            if m is None else
            f"[3b] {name} G={G} B={B} N={N} m={m} ({true / 1e9:.3f} G cells), {card}: K2 "
            f"{ms:.3f} ms = {true / ms / 1e6:.3f} GCUPS ({strips} strips on clusters of {cl} "
            f"blocks of {warps} warps, {blocks} blocks); this tree's K1 {k1_ms:.3f} ms in turns "
            f"({k1_ms / ms:.2f}x); plain {plain_ms:.3f} ms; K2 == plain at every split "
            f"(max |diff| 0)")
        check(ms < k1_ms, f"K2 at the {name} shape ({ms:.3f} ms) loses to this tree's K1 "
                          f"({k1_ms:.3f} ms)")
        check(ms < plain_ms, f"K2 at the {name} shape ({ms:.3f} ms) loses to its plain version "
                             f"({plain_ms:.3f} ms)")
        par_ms = None
        if PARENT["k"]:
            par_ms, this_ms = parent_turns(
                "3b", f"the parent's K2 against this K2 at the {name} shape", k2,
                lambda: PARENT["k"].k2(*args, m32, n_chunk=64, m_cap=None), 3, card, true)
            check(this_ms <= (1 + PARENT_TOLERANCE) * par_ms,
                  f"K2 at the {name} shape is slower than the parent's K2")
            splits = {}
            for cl_w in long_splits(N)[1:]:
                splits[cl_w] = _time_ms(lambda cw=cl_w: sw_grouped.sw_scores_grouped_long(
                    *args, m32, n_chunk=64, m_cap=None, cluster=cw[0], warps_per_block=cw[1]),
                    iters=3, warmup=1)
            say(f"[3b]   {name}: K2 at forced (cluster, warps) " + ", ".join(
                f"{c}x{w}: {t:.3f} ms" for (c, w), t in splits.items()))
        rows.append(dict(name=name, G=G, B=B, N=N, ms=ms, k1_ms=k1_ms, plain_ms=plain_ms,
                         par_ms=par_ms, work=(nbytes, insns)))
        del args, ref
    _cluster_against_one_block(rng, m32, sms, dev, card)
    # the K1/K2 crossover: one group of B full targets at each long rung
    # and query length; K2 == K1 on every launch, K2 == plain on the widest
    # of the lowest rung; the aligner's route must pick the faster kernel
    # or one within ROUTE_SLACK of it
    from sift4g_tpu_torch.align.batch import _long_route

    grid = []
    for m in LONG_GRID_M:
        for N in LONG_GRID_N:
            for B in LONG_GRID_B:
                args = grouped_inputs(rng, 1, B, N, (m,), dev, zero_len=False)
                if (m, N, B) == (LONG_GRID_M[0], LONG_GRID_N[0], LONG_GRID_B[-1]):
                    ref = scan.align_scores_grouped(*args, m32)
                    _k2_against_plain(f"on the launch B={B} N={N}", args, m32, ref,
                                      ((None, None),))
                    del ref

                def k2():
                    return sw_grouped.sw_scores_grouped_long(*args, m32)

                def k1():
                    return sw_grouped.sw_scores_grouped(*args, m32)

                check(torch.equal(k1(), k2()), f"K1 and K2 differ at B={B} N={N} m={m}")
                k1_ms, ms = _turns(k1, k2, 2)
                on_k2 = _long_route([(m, np.full(B, N))])
                grid.append((m, N, B, ms, k1_ms, on_k2))
                _, warps, cl, _ = sw_grouped.long_geometry(1, B, N, sms)
                say(f"[3b] crossover G=1 B={B} N={N} m={m} (full targets), {card}: K2 "
                    f"{ms:.3f} ms ({B * N * m / ms / 1e9:.3f} T cells/s, clusters of {cl} x "
                    f"{warps} warps), K1 {k1_ms:.3f} ms in turns ({k1_ms / ms:.2f}x); the route "
                    f"picks {'K2' if on_k2 else 'K1'}")
                del args
    for m in LONG_GRID_M:
        for B in LONG_GRID_B:
            wins = [N for mm, N, b, ms, k1_ms, _ in grid if (mm, b) == (m, B) and ms < k1_ms]
            say(f"[3b] m={m}, B={B} full targets: K2 wins at rungs {wins or 'none'} of "
                f"{LONG_GRID_N}")
    for m, N, B, ms, k1_ms, on_k2 in grid:
        picked, other = (ms, k1_ms) if on_k2 else (k1_ms, ms)
        check(picked <= ROUTE_SLACK * other,
              f"the route's {'K2' if on_k2 else 'K1'} at B={B} N={N} m={m} takes {picked:.3f} "
              f"ms against {other:.3f} ms")
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def recorded_launches(name):
    """Keep each call's device inputs and output of the scorer wrapper
    ``name`` (references only: nothing is copied or synchronised), so that
    the main path's own launches can be held to the plain version
    afterwards.  The aligner reaches the wrappers through
    ``parallel/sharded.py``, which looks them up at each call."""
    from sift4g_tpu_torch.align import sw_grouped

    real, launches = getattr(sw_grouped, name), []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        launches.append((args, kw, out))
        return out

    setattr(sw_grouped, name, recorded)
    try:
        yield launches
    finally:
        setattr(sw_grouped, name, real)


def _run_cli(args, metrics=None):
    from sift4g_tpu_torch.cli import main

    rc = main(args, metrics=metrics)
    check(rc == 0, f"CLI {' '.join(args)} exited {rc}")


def _counts():
    from sift4g_tpu_torch.align import sw_grouped

    return {"kernel_launches": sw_grouped.kernel_launches,
            "i16_launches": sw_grouped.i16_launches,
            "f32_launches": sw_grouped.f32_launches,
            "resident_launches": sw_grouped.resident_launches,
            "long_launches": sw_grouped.long_launches,
            "twin_calls_on_cuda": sw_grouped.twin_calls_on_cuda}


def _same_tree(a, b, what, hidden=True):
    """Every file of ``a`` and ``b`` byte-identical (``hidden=False``: not
    the run manifest, which only ``run_pipeline`` writes)."""
    names = sorted(n for n in os.listdir(a) if hidden or not n.startswith("."))
    check(names == sorted(n for n in os.listdir(b) if hidden or not n.startswith(".")),
          f"{what}: different output file sets")
    preds = [n for n in names if n.endswith(".SIFTprediction")]
    check(bool(preds), f"{what}: no .SIFTprediction written")
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    check(not mismatch and not errors, f"{what}: files differ: {mismatch + errors}")
    return len(preds)


def _counted_run(args, tag, record=None):
    """One CLI run with ``--timings``: the counters are set to 0 just
    before it and read just after.  Returns (wall s, metrics, counters,
    recorded launches)."""
    from sift4g_tpu_torch.align import sw_grouped
    from sift4g_tpu_torch.utils import PhaseMetrics

    metrics = PhaseMetrics(log=sys.stderr, enabled=True)
    ctx = recorded_launches(record) if record else contextlib.nullcontext([])
    with ctx as recorded:
        sw_grouped.reset_counters()
        t0 = time.perf_counter()
        _run_cli([*args, "--timings"], metrics)
        wall = time.perf_counter() - t0
        counts = _counts()
    for name, d in metrics.phases.items():
        extra = " ".join(f"{k}={v:g}" for k, v in d.items() if k != "seconds")
        say(f"[{tag}]   phase {name:16s} {d.get('seconds', 0.0):9.3f} s  {extra}")
    align = metrics.phases["align"]
    say(f"[{tag}] {wall:.2f} s wall, align {align['cells'] / 1e9:.2f} G cells, "
        f"{align['cells'] / align['seconds'] / 1e9:.2f} GCUPS over the align phase, "
        + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return wall, metrics, counts, list(recorded)


def phase_main_path(tmp):
    from sift4g_tpu_torch.synthetic import main as make_db

    data = os.path.join(tmp, "swissprot-scale")
    t0 = time.perf_counter()
    make_db([data, "--n-db", "570000", "--n-q", "50", "--subst-per-query", "20", "--seed", "0"])
    say(f"[4] synthetic database: 570000 sequences, 50 queries ({time.perf_counter() - t0:.1f} s)")
    os.environ["SIFT4G_TPU_CACHE_DIR"] = os.path.join(tmp, "cache")
    q, db = os.path.join(data, "queries.fa"), os.path.join(data, "db.fa")

    outs = {b: os.path.join(tmp, f"out-{b}") for b in ("native", "cuda")}
    for o in outs.values():
        os.mkdir(o)
    # native first: it also builds the parse cache both runs then read
    t0 = time.perf_counter()
    _run_cli(["--backend", "native", "--overlap", "off", "-q", q, "-d", db, "--subst", data,
              "--out", outs["native"]])
    native_s = time.perf_counter() - t0

    cuda_s, _, counts, recorded = _counted_run(
        ["--backend", "cuda", "--overlap", "off", "-q", q, "-d", db, "--subst", data,
         "--out", outs["cuda"]],
        "4", record="sw_scores_grouped",
    )
    launches = counts["kernel_launches"]
    check(launches > 0, "the main path launched K1 no time")
    check(counts["resident_launches"] == 0, "phase 4 left the slab path")
    check(counts["i16_launches"] == 0 and counts["f32_launches"] == 0,
          "the main path left K1's int32 accumulator")
    check(counts["twin_calls_on_cuda"] == 0,
          f"the main path called the twin on CUDA {counts['twin_calls_on_cuda']} times")
    n_pred = _same_tree(outs["cuda"], outs["native"], "subst mode")
    say(f"[4] --backend native: {native_s:.2f} s wall; {n_pred} .SIFTprediction files "
        f"byte-identical")

    with open(q) as fh:
        records = fh.read().split(">")[1:6]
    q5 = os.path.join(tmp, "queries5.fa")
    with open(q5, "w") as fh:
        fh.write("".join(">" + r for r in records))
    for b in ("native", "cuda"):
        os.mkdir(outs[b] + "-matrix")
        _run_cli(["--backend", b, "--overlap", "off", "-q", q5, "-d", db,
                  "--out", outs[b] + "-matrix"])
    n_mat = _same_tree(outs["cuda"] + "-matrix", outs["native"] + "-matrix", "matrix mode")
    say(f"[4] matrix mode, 5 queries: {n_mat} files byte-identical to --backend native")
    check(len(recorded) == launches, f"{len(recorded)} launches recorded, {launches} counted")
    return SimpleNamespace(data=data, q=q, db=db, native_out=outs["native"], q5=q5, cuda_s=cuda_s,
                           native_matrix_out=outs["native"] + "-matrix",
                           launches=launches, recorded=recorded,
                           long_launches=counts["long_launches"])


def _write_query_set(main, tmp, n_extra, seed):
    """The 50 generated queries plus ``n_extra`` database sequences (100 to
    1,000 residues) as queries, each with 20 random substitutions."""
    from sift4g_tpu_torch.io.fasta import FastaStream

    rng = np.random.default_rng(seed)
    subst = os.path.join(tmp, f"subst-{50 + n_extra}")
    os.mkdir(subst)
    for f in os.listdir(main.data):
        if f.endswith(".subst"):
            shutil.copy(os.path.join(main.data, f), subst)
    std = np.array([ord(c) - ord("A") for c in "ACDEFGHIKLMNPQRSTVWY"])
    path = os.path.join(tmp, f"queries{50 + n_extra}.fa")
    with FastaStream(main.db) as fs, open(path, "w") as out:
        with open(main.q) as fh:
            out.write(fh.read())
        lens = np.diff(fs._offsets)
        pick = np.flatnonzero((lens >= 100) & (lens <= 1000))
        for i in np.sort(rng.choice(pick, n_extra, replace=False)):
            codes = fs.codes_at(int(i))
            name = fs.name_at(int(i))
            seq = "".join(chr(int(c) + ord("A")) for c in codes)
            out.write(f">{name}\n{seq}\n")
            with open(os.path.join(subst, name + ".subst"), "w") as sf:
                for p in np.sort(rng.choice(len(codes), 20, replace=False)):
                    sf.write(f"{seq[p]}{p + 1}{chr(int(rng.choice(std)) + ord('A'))}\n")
    return path, subst


def phase_resident_path(main, tmp):
    from sift4g_tpu_torch.align.resident import _RESIDENT_CACHE, drop_resident_db

    # 4b.1: the 50-query run with --resident-db on
    out_on = os.path.join(tmp, "out-resident-on")
    os.mkdir(out_on)
    drop_resident_db()
    _, m_on, c_on, _ = _counted_run(
        ["--backend", "cuda", "--overlap", "off", "--resident-db", "on", "-q", main.q,
         "-d", main.db, "--subst", main.data, "--out", out_on], "4b on")
    check(c_on["resident_launches"] > 0, "--resident-db on launched K3 no time")
    check(c_on["kernel_launches"] == 0, "--resident-db on still launched K1")
    check(c_on["twin_calls_on_cuda"] == 0, "--resident-db on called a plain version on CUDA")
    n_on = _same_tree(out_on, main.native_out, "--resident-db on")
    rdb = _RESIDENT_CACHE["db"]
    say(f"[4b] --resident-db on, 50 queries: {n_on} files byte-identical to --backend native; "
        f"upload {rdb.nbytes} bytes slotted ({rdb.host_slotted.nbytes} with the tail pad) in "
        f"{rdb.upload_seconds * 1e3:.1f} ms after {rdb.pack_seconds * 1e3:.1f} ms of slot "
        f"packing")

    # 4b.2: 300 queries at default flags (auto) against --resident-db off;
    # their candidates (about 1.5 MB a query) outweigh the 0.2 GB slotted
    # database, so auto must take the resident path
    q300, subst300 = _write_query_set(main, tmp, 250, seed=7)
    base = ["--backend", "cuda", "--overlap", "off", "-q", q300, "-d", main.db, "--subst", subst300]
    runs, outs = {}, {}
    for tag in ("off", "auto cold", "auto warm", "off again"):
        out = outs[tag] = os.path.join(tmp, "out-300-" + tag.replace(" ", "-"))
        os.mkdir(out)
        flags = ["--resident-db", "off"] if tag.startswith("off") else []
        if tag == "auto cold":
            drop_resident_db()   # auto decides on the candidate bytes, not a live upload
        record = "sw_scores_grouped_resident" if tag == "auto cold" else None
        _, m, c, rec = _counted_run([*base, *flags, "--out", out], f"4b {tag}", record=record)
        if tag.startswith("off"):
            check(c["resident_launches"] == 0 and c["kernel_launches"] > 0,
                  "--resident-db off left the slab path")
        else:
            check(c["resident_launches"] > 0, f"{tag}: auto did not pick the resident database")
            check(c["kernel_launches"] == 0, f"{tag}: the resident run still launched K1")
            check(c["twin_calls_on_cuda"] == 0, f"{tag}: a plain version ran on CUDA")
        n = _same_tree(out, outs["off"], f"300 queries {tag} vs off")
        runs[tag] = (m, c, rec, n)
    m_cold, c_cold, recorded, n_cold = runs["auto cold"]
    check(len(recorded) == c_cold["resident_launches"],
          f"{len(recorded)} K3 launches recorded, {c_cold['resident_launches']} counted")
    check("align.upload" not in runs["auto warm"][0].phases or
          runs["auto warm"][0].phases["align.upload"]["seconds"] < 0.05,
          "the warm run uploaded the database again")
    up = m_cold.phases["align.upload"]
    say(f"[4b] 300 queries: auto chose the resident database ({c_cold['resident_launches']} K3 "
        f"launches, 0 K1); {n_cold} files of every run byte-identical to the first "
        f"--resident-db off run; cold upload phase {up['seconds']:.3f} s for {up['bytes']:g} "
        f"bytes")
    cols = ("search", "align.upload", "align", "align.dispatch", "align.fetch",
            "align.traceback", "select", "predict")
    say("[4b] phase seconds, 300 queries: " + " | ".join(cols) + " | align GCUPS")
    for tag, (m, _, _, _) in runs.items():
        secs = [m.phases.get(c, {}).get("seconds", 0.0) for c in cols]
        a = m.phases["align"]
        say(f"[4b]   {tag:10s} " + " | ".join(f"{x:.3f}" for x in secs)
            + f" | {a['cells'] / a['seconds'] / 1e9:.2f}")
    return c_cold["resident_launches"], recorded


# the long tail added to phase 4's database: about 2,000 sequences of
# 2,049 (past the 2,048 rung, the last one below LONG_RUNG) to 35,213
# residues (Swiss-Prot's longest, titin), log-uniform (a spread over every
# long rung, not a fit to Swiss-Prot's length histogram), one in eight a
# random flank around a mutated copy of a query segment, so that it
# becomes a candidate; and a family of 1,500 long proteins of 2,049 to
# 3,072 residues that share the first query as a domain (a random flank
# around a mutated copy of it), whose launch at the 3,072 rung holds more
# cells than K2 can take before K1 would be done
LONG_TAIL = dict(n=2000, lo=2049, hi=35213, homolog_every=8, family=1500,
                 family_lo=2049, family_hi=3072, seed=11)


def _long_tail_db(main, tmp):
    """Phase 4's database plus the long tail and the family, written to a
    directory of its own with phase 4's queries and substitution files."""
    from sift4g_tpu_torch.synthetic import STD, _freqs

    data = os.path.join(tmp, "long-tail")
    os.mkdir(data)
    for f in os.listdir(main.data):
        if f.endswith(".subst"):
            shutil.copy(os.path.join(main.data, f), data)
    shutil.copy(main.q, os.path.join(data, "queries.fa"))
    db = os.path.join(data, "db.fa")
    shutil.copy(main.db, db)
    rng = np.random.default_rng(LONG_TAIL["seed"])
    letters = np.frombuffer(bytes(bytearray((STD + ord("A")).astype(np.uint8))), dtype="S1")
    with open(main.q) as fh:
        queries = [r.split("\n", 1)[1].replace("\n", "") for r in fh.read().split(">")[1:]]
    lens = np.exp(rng.uniform(np.log(LONG_TAIL["lo"]), np.log(LONG_TAIL["hi"] + 1),
                              LONG_TAIL["n"])).astype(np.int64)
    lens[:2] = (LONG_TAIL["lo"], LONG_TAIL["hi"])
    pool = rng.choice(letters, size=int(lens.sum()), p=_freqs()).tobytes().decode("ascii")
    pos, n_hom = 0, 0
    with open(db, "a") as fh:
        for i, n in enumerate(lens):
            seq = pool[pos : pos + n]
            pos += n
            if i % LONG_TAIL["homolog_every"] == 0:
                src = queries[int(rng.integers(len(queries)))]
                a = int(rng.integers(0, max(1, len(src) - 100)))
                seg = np.array(list(src[a : a + int(rng.integers(100, 400))]))
                mut = rng.random(len(seg)) < 0.15
                seg[mut] = rng.choice(letters.astype(str), int(mut.sum()))
                at = int(rng.integers(0, n - len(seg)))
                seq = seq[:at] + "".join(seg) + seq[at + len(seg) :]
                n_hom += 1
            fh.write(f">LONG_{i}\n{seq}\n")
        dom = np.array(list(queries[0]))
        fam = rng.integers(LONG_TAIL["family_lo"], LONG_TAIL["family_hi"] + 1, LONG_TAIL["family"])
        for i, n in enumerate(fam):
            seg = dom.copy()
            mut = rng.random(len(seg)) < 0.15
            seg[mut] = rng.choice(letters.astype(str), int(mut.sum()))
            flank = rng.choice(letters, size=int(n) - len(seg), p=_freqs()).tobytes().decode()
            at = int(rng.integers(0, len(flank) + 1))
            fh.write(f">FAMILY_{i}\n{flank[:at]}{''.join(seg)}{flank[at:]}\n")
    return data, int(lens.sum() + fam.sum()), n_hom


def phase_long_tail(main, tmp, card):
    """4c: the 50-query CLI on phase 4's database plus the long tail and
    the family, with --backend cuda against --backend native
    (byte-identical); K2's launches counted, each held to its plain
    version on its own inputs, and timed with this tree's K1 on the same
    inputs in turns (the largest launch of each rung); K1's launches at
    long rungs held to plain and timed against K2 the same way."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped
    from sift4g_tpu_torch.align.batch import LONG_RUNG

    t0 = time.perf_counter()
    data, residues, n_hom = _long_tail_db(main, tmp)
    q, db = os.path.join(data, "queries.fa"), os.path.join(data, "db.fa")
    say(f"[4c] database: phase 4's plus {LONG_TAIL['n']} sequences of {LONG_TAIL['lo']}-"
        f"{LONG_TAIL['hi']} residues ({n_hom} holding a mutated query segment) and a family of "
        f"{LONG_TAIL['family']} of {LONG_TAIL['family_lo']}-{LONG_TAIL['family_hi']} holding "
        f"the first query ({residues} residues) ({time.perf_counter() - t0:.1f} s)")
    outs = {b: os.path.join(tmp, f"out-long-{b}") for b in ("native", "cuda")}
    for o in outs.values():
        os.mkdir(o)
    t0 = time.perf_counter()
    _run_cli(["--backend", "native", "--overlap", "off", "-q", q, "-d", db, "--subst", data,
              "--out", outs["native"]])
    native_s = time.perf_counter() - t0
    with recorded_launches("sw_scores_grouped") as k1_rec:
        wall, _, c, recorded = _counted_run(
            ["--backend", "cuda", "--overlap", "off", "-q", q, "-d", db, "--subst", data,
             "--out", outs["cuda"]], "4c", record="sw_scores_grouped_long")
    wide = [r for r in k1_rec if r[0][3].shape[2] >= LONG_RUNG]
    k1_rec.clear()
    check(c["long_launches"] > 0, "the long-tail run launched K2 no time")
    check(bool(wide), "no launch at a rung of LONG_RUNG or more went to K1")
    check(len(recorded) == c["long_launches"],
          f"{len(recorded)} K2 launches recorded, {c['long_launches']} counted")
    check(c["twin_calls_on_cuda"] == 0, "the long-tail run called a plain version on the card")
    n = _same_tree(outs["cuda"], outs["native"], "long tail")
    say(f"[4c] --backend cuda {wall:.2f} s, --backend native {native_s:.2f} s; {n} "
        f".SIFTprediction files byte-identical; K2 {c['long_launches']} launches, K1 "
        f"{c['kernel_launches']}")

    max_err, by_rung, n_at = 0, {}, {}
    for args, kw, out in recorded:
        N = args[3].shape[2]
        check(N >= LONG_RUNG, f"K2 launched at rung {N}, under LONG_RUNG {LONG_RUNG}")
        ref = scan.align_scores_grouped(*args[:6], mode=kw["mode"], gap_open=kw["gap_open"],
                                        gap_extend=kw["gap_extend"])
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max()) if out.numel() else 0
        max_err = max(max_err, err)
        G, B = args[4].shape
        padded = int(args[2].long().sum()) * B * N
        true = int((args[2].long() * args[4].long().sum(dim=1)).sum())
        check(err == 0, f"K2 launch G={G} B={B} N={N}: differs from plain by {err}")
        del ref
        n_at[N] = n_at.get(N, 0) + 1
        if N not in by_rung or padded > by_rung[N][0]:
            by_rung[N] = (padded, true, args, kw)
    say(f"[4c] every K2 launch == plain on its own inputs (max |diff| {max_err})")
    sms = torch.cuda.get_device_properties(args[3].device).multi_processor_count
    if PARENT["k"]:
        for i, (args, kw, out) in enumerate(recorded):
            G, B = args[4].shape
            N = args[3].shape[2]
            true = int((args[2].long() * args[4].long().sum(dim=1)).sum())
            par_ms, this_ms = parent_turns(
                "4c", f"the parent's K2 against this K2 on launch {i} (G={G} B={B} N={N}, "
                f"{int((args[4] > 0).sum())} targets, geometry "
                f"{_geometry_of(sms, args, kw)})",
                lambda: sw_grouped.sw_scores_grouped_long(*args, **kw),
                lambda: PARENT["k"].k2(*args, **{k: v for k, v in kw.items()
                                                 if k not in K2_HINTS}), 2, card, true)
            check(this_ms <= (1 + PARENT_TOLERANCE) * par_ms,
                  f"K2 on launch {i} (G={G} B={B} N={N}) is slower than the parent's K2")
    rows, largest = [], None
    for N in sorted(by_rung):
        padded, true, args, kw = by_rung[N]
        G, B = args[4].shape
        k1_kw = {k: v for k, v in kw.items() if k in ("mode", "gap_open", "gap_extend")}

        def k2():
            return sw_grouped.sw_scores_grouped_long(*args, **kw)

        def k1():
            return sw_grouped.sw_scores_grouped(*args[:6], **k1_kw)

        check(torch.equal(k1(), k2()), f"K1 and K2 differ on the rung-{N} launch")
        k1_ms, ms = _turns(k1, k2, 2)
        strips, warps, cl, _ = _geometry_of(sms, args, kw)
        live = int((args[4] > 0).sum())
        say(f"[4c] rung {N}: {n_at[N]} launches; largest G={G} B={B} ({padded / 1e9:.3f} G padded, "
            f"{true / 1e9:.3f} G true cells, {live} targets), {card}: K2 "
            f"{ms:.3f} ms ({true / ms / 1e6:.2f} true GCUPS, clusters of {cl} blocks of {warps} "
            f"warps) against K1 {k1_ms:.3f} ms in turns ({k1_ms / ms:.2f}x)")
        per_w = {cw: _time_ms(lambda cw=cw: sw_grouped.sw_scores_grouped_long(
            *args, **dict(kw, cluster=cw[0], warps_per_block=cw[1])), iters=2, warmup=1)
            for cw in ((1, 4), (1, 16), (2, 8), (4, 4), (4, 16), (8, 2))}
        say(f"[4c]   rung {N}: K2 at forced (cluster, warps) " + ", ".join(
            f"{c}x{w}: {t:.3f} ms" for (c, w), t in per_w.items()))
        rows.append((N, ms, k1_ms))
        check(ms <= TAIL_ROUTE_SLACK * k1_ms, f"the route's K2 at rung {N} takes {ms:.3f} ms "
                                              f"against K1's {k1_ms:.3f} ms")
        if largest is None or padded > largest[0]:
            largest = (padded, true, args, kw, k1_ms, ms)
    for args, kw, out in wide:
        G, B = args[4].shape
        N = args[3].shape[2]
        gaps = {k: v for k, v in kw.items() if k in ("mode", "gap_open", "gap_extend")}
        ref = scan.align_scores_grouped(*args[:6], **gaps)
        check(torch.equal(out, ref), f"K1's launch G={G} B={B} N={N}: differs from plain")
        del ref

        def k2():
            return sw_grouped.sw_scores_grouped_long(*args[:6], **gaps)

        def k1():
            return sw_grouped.sw_scores_grouped(*args[:6], **gaps)

        check(torch.equal(k2(), out), f"K2 differs from K1 on the launch G={G} B={B} N={N}")
        k1_ms, k2_ms = _turns(k1, k2, 2)
        true = int((args[2].long() * args[4].long().sum(dim=1)).sum())
        say(f"[4c] rung {N}: K1's launch G={G} B={B} ({true / 1e9:.3f} G true cells, "
            f"{int((args[4] > 0).sum())} targets) == plain, {card}: K1 {k1_ms:.3f} ms against "
            f"K2 {k2_ms:.3f} ms in turns ({k2_ms / k1_ms:.2f}x)")
        check(k1_ms <= TAIL_ROUTE_SLACK * k2_ms, f"the route's K1 at rung {N} takes {k1_ms:.3f} "
                                                 f"ms against K2's {k2_ms:.3f} ms")
    padded, true, args, kw, k1_ms, ms = largest
    plain_ms = _time_ms(lambda: scan.align_scores_grouped(
        *args[:6], mode=kw["mode"], gap_open=kw["gap_open"], gap_extend=kw["gap_extend"]),
        iters=1, warmup=0)
    work = _work("slab", args, kw)[:2]
    say(f"[4c] largest K2 launch G={args[4].shape[0]} B={args[4].shape[1]} "
        f"N={args[3].shape[2]}, {card}: K2 {ms:.3f} ms, K1 {k1_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms")
    losing = [N for N, k2_ms, k1_ms in rows if k2_ms >= k1_ms]
    say(f"[4c] rungs where K1 beats K2 on K2's largest launch: {losing or 'none'}; K1 took "
        f"{len(wide)} launches at rungs of LONG_RUNG ({LONG_RUNG}) or more")
    recorded.clear()
    wide.clear()
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, work=work,
                launches=c["long_launches"], rungs=rows)


def _bound(nbytes, insns):
    """(bound_ms, bound_by): the larger of ``nbytes`` at the memory rate
    and ``insns`` max-family instructions at the int32 rate in force."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = insns / INT32["per_s"] * 1e3
    return max(ms_bytes, ms_ops), ("bytes" if ms_bytes >= ms_ops else "operations")


def _work(kind, args, kw):
    """(bytes, max-family instructions, true cells) of one K1/K3 launch
    from its inputs: each input byte read once and the output written
    once, and the true cells' max-family instructions."""
    q_all, q_lens = args[0], args[2]
    if kind == "slab":
        targets, lens = args[3], args[4]
        G, B, _ = targets.shape
        row_bytes = targets.numel()
    else:
        starts, lens = args[4], args[5]
        G, B = starts.shape
        row_bytes = int(lens.long().sum()) + 8 * starts.numel()
    true = int((q_lens.long() * lens.long().sum(dim=1)).sum())
    nbytes = row_bytes + 4 * (q_all.numel() + 2 * G + 2 * G * B) + 4 * 32 * 32
    from sift4g_tpu_torch.align.roofline import MAX_INSTRUCTIONS_PER_CELL

    return nbytes, true * MAX_INSTRUCTIONS_PER_CELL[kw["mode"]], true


def phase_main_launches(recorded, card, kind, tag):
    """The main path's own launches against the plain version on the same
    device inputs; the launch with the most padded cells is then timed."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    if kind == "slab":
        kernel, plain = sw_grouped.sw_scores_grouped, scan.align_scores_grouped
    else:
        kernel, plain = sw_grouped.sw_scores_grouped_resident, scan.align_scores_grouped_resident
    max_err, largest = 0, None
    for args, kw, out in recorded:
        q_lens, lens = args[2], (args[4] if kind == "slab" else args[5])
        G, B = lens.shape
        N = args[3].shape[2] if kind == "slab" else args[7]
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max()) if out.numel() else 0
        max_err = max(max_err, err)
        padded = int(q_lens.long().sum()) * B * N
        true = int((q_lens.long() * lens.long().sum(dim=1)).sum())
        say(f"[{tag}] launch {kw['mode']} G={G} B={B} N={N} qmax={int(q_lens.max())}: "
            f"{padded / 1e9:.3f} G padded cells, {true / 1e9:.3f} G true; kernel == plain "
            f"(max |diff| {err})")
        check(err == 0, f"main-path launch G={G} B={B} N={N}: kernel differs from plain by {err}")
        del ref
        if largest is None or padded > largest[0]:
            largest = (padded, true, args, kw, (G, B, N))
    padded, true, args, kw, (G, B, N) = largest
    ms = _time_ms(lambda: kernel(*args, **kw), iters=5, warmup=1)
    plain_ms = _time_ms(lambda: plain(*args, **kw), iters=1, warmup=0)
    work = _work(kind, args, kw)[:2]
    bound_ms, bound_by = _bound(*work)
    T, block = sw_grouped.launch_geometry(G, B, N, args[0].device)
    per_cell = tiled_bytes_per_cell(T)
    say(f"[{tag}] largest main-path launch G={G} B={B} N={N}, {card}: kernel {ms:.3f} ms = "
        f"{padded / ms / 1e6:.2f} GCUPS padded, {true / ms / 1e6:.2f} true, at (T, block) = "
        f"({T}, {block}); plain {plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}, at the "
        f"peak max-family rate; recomputed at the end after phase 7's check); design bound "
        f"({per_cell:.4f} B/cell at 3.35 TB/s) {true * per_cell / HBM_BYTES_PER_S * 1e3:.3f} ms")
    if PARENT["k"]:
        par = PARENT["k"].k1 if kind == "slab" else PARENT["k"].k3
        what = f"{'K1' if kind == 'slab' else 'K3'}'s largest main-path launch G={G} B={B} N={N}"
        # the main path's int32 accumulator: the parent's K1 takes no acc
        check(kw.get("acc", "int") == "int", f"{what}: the main path ran acc={kw.get('acc')!r}")
        par_kw = {k: v for k, v in kw.items() if k not in ("max_qlen", "max_sub", "acc")}
        check_unmoved(what, *parent_turns(tag, what, lambda: kernel(*args, **kw),
                                          lambda: par(*args, **par_kw), 3, card, true))
    if kind == "resident":
        # K1 on the same windows as a slab, timed between K3's turns
        q, o, ql, db, st, tl = args[:6]
        slab = db[st[..., None] + torch.arange(N, device=db.device)].view(torch.int8).contiguous()
        k1_ms = _time_ms(lambda: sw_grouped.sw_scores_grouped(q, o, ql, slab, tl, args[6], **kw),
                         iters=5, warmup=1)
        ms2 = _time_ms(lambda: kernel(*args, **kw), iters=5, warmup=1)
        say(f"[{tag}] same launch, {card}: K3 {ms:.3f} then {ms2:.3f} ms; K1 on the same "
            f"windows as a slab {k1_ms:.3f} ms ({true / k1_ms / 1e6:.2f} true GCUPS)")
        del slab
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, work=work, T=T)


# K5's strip and wavefront edges (tests/test_torch_gpu.py holds the same):
# widths around one lane's 16 columns, one strip of 512 and several, rows
# around the wavefront's 32 lanes, gaps with go < ge, salts at the
# argument limit (small M keeps every value inside int32), B = 1 and 33
DP_ROW_EDGE_N = (1, 15, 16, 17, 511, 512, 513, 1100, 6144)
DP_ROW_EDGE_M = (0, 1, 2, 31, 32, 33)
DP_ROW_EDGE_GAPS = ((10, 1), (11, 2), (1, 3))
DP_ROW_EDGE_RUNS = ((1, 1 << 20), (33, -(1 << 20)), (33, 5))
# rows around the row tiles (512) of a row wider than one strip
DP_ROW_TILE_M = (511, 512, 513, 1025)


def dp_row_edge_cases(N):
    """(B, N, M, go, ge, salt) of K5's edges at width N."""
    cases = [(B, N, M, go, ge, salt) for M in DP_ROW_EDGE_M for go, ge in DP_ROW_EDGE_GAPS
             for B, salt in DP_ROW_EDGE_RUNS]
    if N > 512:
        cases += [(5, N, M, go, ge, 3) for M in DP_ROW_TILE_M for go, ge in ((10, 1), (1, 3))]
    return cases


def phase_dp_row(dev, card, k1_gcups):
    """K5 against its plain version, exact, at its strip and wavefront
    edges; then timed at the bench's shape (against the parent's K5 under
    --parent), its loop's opcodes, and its marginal rates."""
    import torch
    from sift4g_tpu_torch import bench
    from sift4g_tpu_torch.align import roofline

    max_err, n = 0, 0
    t0 = time.perf_counter()
    cases = [(1024, 512, 300, 10, 1, 3), (65536, 512, 64, 10, 1, -7), (1024, 200, 150, 11, 2, 5),
             (2048, 1100, 600, 11, 2, 9)]
    # the bench's B=1024 probe at its most rows (B=65,536 is held below, where it is timed)
    cases.append((1024, 512, bench.B1024_ROWS[1], 10, 1, 11))
    cases += [c for N in DP_ROW_EDGE_N for c in dp_row_edge_cases(N)]
    for B, N, M, go, ge, salt in cases:
        got = roofline.dp_row_probe(M, salt, B=B, N=N, go=go, ge=ge, device=dev)
        ref = roofline.dp_row_probe_plain(M, salt, B=B, N=N, go=go, ge=ge, device=dev)
        torch.cuda.synchronize()
        what = f"K5 B={B} N={N} M={M} gaps {go}/{ge} salt {salt}"
        check(got.shape == (B,) and got.dtype == torch.int32, f"{what}: shape/dtype")
        err = int((got.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"{what}: differs from its plain version by {err}")
        check(bool((got == got[0]).all()), f"{what}: rows differ")
        if n < 4:
            say(f"[6] {what}: kernel == plain (max |diff| 0, best cell {int(got[0])})")
        n += 1
    say(f"[6] K5 == plain (max |diff| 0) on {n} launches: N in {DP_ROW_EDGE_N}, M in "
        f"{DP_ROW_EDGE_M} (and {DP_ROW_TILE_M} past one strip), gaps {DP_ROW_EDGE_GAPS}, "
        f"(B, salt) in {DP_ROW_EDGE_RUNS}; {time.perf_counter() - t0:.2f} s")
    # the bench's shape: the bench launch's cells a query row, its rows
    B, N, M = 65536, 512, bench.B65536_ROWS[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def kernel():
        return roofline.dp_row_probe(M, 11, B=B, N=N, device=dev)

    ms = _time_ms(kernel, iters=5, warmup=1)
    ref = []
    plain_ms = _time_ms(lambda: ref.append(roofline.dp_row_probe_plain(M, 11, B=B, N=N,
                                                                       device=dev)),
                        iters=1, warmup=0)
    got = kernel()
    torch.cuda.synchronize()
    err = int((got.long() - ref[0].long()).abs().max())
    max_err = max(max_err, err)
    check(err == 0, f"K5 B={B} N={N} M={M}: the timed launch differs from its plain version "
                    f"by {err}")
    del ref
    cells = B * N * M
    insns = cells * roofline.MAX_INSTRUCTIONS_PER_CELL["SW"]
    bound_ms, bound_by = _bound(4 * B, insns)
    gcups = cells / ms / 1e6
    say(f"[6] K5 B={B} N={N} M={M} ({cells / 1e9:.2f} G cells), {card}: kernel {ms:.3f} ms = "
        f"{gcups:.2f} GCUPS at (T, C, block, strips) = {roofline.dp_row_geometry(B, N, sms)}, "
        f"== plain (max |diff| 0); plain {plain_ms:.3f} ms; bound {bound_ms:.3f} ms "
        f"({bound_by}: {insns / 1e9:.2f} G max-family instructions at "
        f"{INT32['per_s'] / 1e12:.3f} T/s; the kernel at {100 * bound_ms / ms:.1f} % of it); "
        f"design bound 0 bytes per cell (the (B,) output only)")
    say(f"[6] K1 at the bench launch (phase 3) over K5 at its shape: {k1_gcups:.2f} / "
        f"{gcups:.2f} GCUPS = {k1_gcups / gcups:.3f}")
    if PARENT["k"]:
        check_unmoved(f"K5 at B={B} N={N} M={M}", *parent_turns(
            "6", f"K5 at B={B} N={N} M={M}", kernel,
            lambda: PARENT["k"].k5(M, 11, B=B, N=N, device=dev), 3, card, cells))
    for rows in (1000, 4000, bench.B1024_ROWS[1]):
        t = _time_ms(lambda: roofline.dp_row_probe(rows, 11, B=1024, N=N, device=dev), iters=5,
                     warmup=1)
        say(f"[6] K5 B=1024 N={N} M={rows}: {t:.4f} ms = {1024 * N * rows / t / 1e6:.2f} GCUPS")
    sass = roofline.dp_row_probe_sass()
    if sass is None:
        say("[6] SASS: cuobjdump not found; loop opcodes not read")
    for fn, loops in sorted((sass or {}).items()):
        check(loops and loops[0][0].get("VIADDMNMX", 0) > 0,
              f"K5 {fn}: the steady-state loop has no fused VIADDMNMX")
        for k, (opcodes, per) in enumerate(loops):
            say(f"[6] SASS loop {k} of K5 {'wide' if 'ILb1E' in fn else 'one strip'}: "
                f"{per:.3f} instructions per cell, {dict(opcodes)}")
    for rows, (lo, hi) in ((1024, bench.B1024_ROWS), (B, bench.B65536_ROWS)):
        r = roofline.dp_row_roofline(B=rows, N=N, lo=lo, hi=hi, device=dev)
        say(f"[6] dp_row_roofline B={rows} N={N} rows {lo} -> {hi}: {r['gcups']:.3f} GCUPS "
            f"marginal, t_lo {r['t_lo_s']:.6f} s, t_hi {r['t_hi_s']:.6f} s; card "
            f"{roofline.gpu_state()}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, work=(4 * B, insns))


def phase_int32(dev, card):
    """K6 against its plain version, exact; then ``bench_ab roofline*``,
    the path K6 runs on, with its launches counted."""
    import torch
    from sift4g_tpu_torch.align import roofline
    from sift4g_tpu_torch.tools import bench_ab

    B, N, M = 1024, 512, 1000
    max_err = 0
    # the int32 form, then the int16 one, also past 32,767 where it wraps
    cases = [(False, B, N, M), (True, B, N, M), (True, 6, 70, 32_760)]
    for packed, b, n, m in cases:
        for pairs in roofline.INT32_PAIRS:
            what = f"K6{' int16' if packed else ''} B={b} N={n} M={m} pairs={pairs}"
            ref = roofline.int32_probe_plain(m, 3, B=b, N=n, pairs=pairs, packed=packed,
                                             device=dev)
            check(m > M or int(ref.unique().numel()) > 1, f"{what}: every row equal")
            got = roofline.int32_probe(m, 3, B=b, N=n, pairs=pairs, packed=packed, device=dev)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{what}: differs from plain by {err}")
            say(f"[7] {what}: kernel == plain (max |diff| 0)")
    M = 25_000
    ms = _time_ms(lambda: roofline.int32_probe(M, 5, B=B, N=N, device=dev), iters=3, warmup=1)
    plain_ms = _time_ms(lambda: roofline.int32_probe_plain(M, 5, B=B, N=N, device=dev),
                        iters=1, warmup=0)
    say(f"[7] K6 pairs=1 plain B={B} N={N} M={M}, {card}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms")

    roofline.reset_counters()
    records = [bench_ab.run_roofline(pairs=pairs, device=dev) for pairs in roofline.INT32_PAIRS]
    packed = bench_ab.COMMANDS["roofline16"]()
    launches = roofline.int32_launches
    check(launches > 0, "bench_ab roofline launched K6 no time")
    # K6's loop is all fused VIADDMNMX: 2 operations a max-family instruction
    peak = roofline.OPS_PER_FUSED_INSTRUCTION * INT32["per_s"]
    for rec in records:
        ips = rec["instr_per_s"]
        say(f"[7] bench_ab {rec['metric']}: {rec['tops']:.3f} T int32 ops/s "
            f"({100 * rec['tops'] * 1e12 / peak:.1f} % of the peak {peak / 1e12:.3f}), "
            f"{'not measured' if ips is None else f'{ips / 1e12:.3f} T instructions/s'}, "
            f"t_lo {rec['t_lo_s']:.6f} s, t_hi {rec['t_hi_s']:.6f} s; {rec['card']}, "
            f"{rec['power_limit']}; clocks {rec['clocks']}")
        check(rec["t_hi_s"] - rec["t_lo_s"] > 1e-3, f"{rec['metric']}: t_hi - t_lo under 1 ms")
    sass = roofline.int32_probe_sass()
    if sass is None:
        say("[7] SASS: cuobjdump not found; loop opcodes not read")
    for pairs, (ops, rounds, per) in sorted((sass or {}).items()):
        check(ops.get("VIADDMNMX", 0) > 0, f"K6 pairs={pairs}: the loop has no fused VIADDMNMX")
        say(f"[7] SASS loop of K6 pairs={pairs}: {dict(ops)}; {rounds:g} rounds per pass, "
            f"{per:.4f} instructions per element and round")
    # the int16 form: two elements an instruction, 4 operations each
    ips = packed["tops"] * 1e12 / (2 * roofline.OPS_PER_FUSED_INSTRUCTION)
    say(f"[7] bench_ab {packed['metric']} (roofline16): {packed['tops']:.3f} T int16 ops/s, "
        f"{ips / 1e12:.3f} T VIADDMNMX.S16x2/s = {100 * ips / INT32['per_s']:.1f} % of the "
        f"int32 max-family rate {INT32['per_s'] / 1e12:.3f} T/s; t_lo {packed['t_lo_s']:.6f} "
        f"s, t_hi {packed['t_hi_s']:.6f} s; {packed['card']}, {packed['power_limit']}; clocks "
        f"{packed['clocks']}")
    check(packed["t_hi_s"] - packed["t_lo_s"] > 1e-3, "roofline16: t_hi - t_lo under 1 ms")
    for pairs, (ops, rounds, per) in sorted((roofline.int32_probe_sass(packed=True)
                                             or {}).items()):
        say(f"[7] SASS loop of K6's int16 form pairs={pairs}: {dict(ops)}; {rounds:g} rounds "
            f"per pass, {per:.4f} instructions per element and round")
    best = max(records, key=lambda r: r["tops"])
    say(f"[7] check of the peak: K6's best, {best['metric']}, {best['tops']:.3f} T ops/s, is "
        f"{100 * best['tops'] * 1e12 / peak:.1f} % of the peak {peak / 1e12:.3f} T ops/s")
    if best["tops"] * 1e12 > peak:
        INT32.update(per_s=best["tops"] * 1e12 / roofline.OPS_PER_FUSED_INSTRUCTION,
                     src=f"K6 measured, {best['metric']} at {best['tops']:.3f} T ops/s, above "
                         f"the peak {peak / 1e12:.3f} T")
    say(f"[7] int32 max-family rate of the operations bounds: {INT32['per_s'] / 1e12:.3f} T/s, "
        f"{INT32['src']}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, work=(4 * B, 2 * B * N * M),
                launches=launches)


def _acc_cases(dev):
    """The cases of phase 13: (name, inputs, matrix32, gaps, max_qlen).
    Every batch is odd (its last pair has no partner); pairs of unequal
    lengths, 0 and N among them; int8 garbage past every length."""
    import torch
    from sift4g_tpu_torch.align import scan
    from sift4g_tpu_torch.align.sw_grouped import GROUP_THREADS, TILE_ROWS

    rng = np.random.default_rng(13)
    N = 512
    cases = []
    # ragged, with queries of several passes at every T (600 > 32 x 16)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    args = grouped_inputs(rng, 6, 301, N, (600, 0, 17, 128, 513, 1), dev)
    args[4][1:, -1] = N                  # an unpaired last target, N long
    args[4][2, :8] = torch.tensor((0, N, N, 0, 1, N, 17, 16))
    cases.append(("ragged", args, m32, (10, 1), 600))
    # the pass boundaries of every T, and target lengths 0, 1, 15, 16, 17, N
    qlens = sorted({0, 1} | {T * TILE_ROWS + d for T in GROUP_THREADS for d in (-1, 0, 1)})
    for gaps in ((10, 1), (11, 2)):
        m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
        args = grouped_inputs(rng, len(qlens), 33, N, qlens, dev)
        args[4][:, :8] = torch.tensor((0, N, 1, 17, 15, 16, N, 0))
        cases.append((f"pass boundaries {gaps[0]}/{gaps[1]}", args, m32, gaps, max(qlens)))
    # the largest admissible bound: 623 x 12 + 10 + 513 x 1 = 7999 < 8000,
    # with targets cut from the queries so that the best cells near 6,144
    m = random_matrix(rng)
    np.fill_diagonal(m, 12)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=m), dev)
    args = grouped_inputs(rng, 4, 33, N, (623, 622, 600, 1), dev)
    q_all, offs, ql, targets, lens = args
    for g in range(3):
        for b in range(0, 33, 3):
            n = int(lens[g, b])
            k = int(rng.integers(0, int(ql[g]) - n + 1)) if n <= int(ql[g]) else 0
            n = min(n, int(ql[g]))
            lens[g, b] = n
            targets[g, b, :n] = q_all[int(offs[g]) + k:int(offs[g]) + k + n].to(torch.int8)
    cases.append(("largest bound", args, m32, (10, 1), 623))
    return cases


def _acc_timing(dev, card, tag, G, B, N, m, lens_range, acc, seed):
    """K1 int and K1 ``acc`` on one launch, equal, then timed in turns
    (int, acc, acc, int) with CUDA events; the plain version of ``acc``
    timed once.  Returns (int ms, acc ms, plain ms, work, cells)."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    rng = np.random.default_rng(seed)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    args = grouped_inputs(rng, G, B, N, (m,) * G, dev, zero_len=False)
    if lens_range:
        args[4].copy_(torch.from_numpy(rng.integers(*lens_range, (G, B)).astype(np.int32)))
    kw = dict(max_qlen=-(-m // 64) * 64, max_sub=int(m32.max()), acc=acc)

    def k_int():
        return sw_grouped.sw_scores_grouped(*args, m32)

    def k_acc():
        return sw_grouped.sw_scores_grouped(*args, m32, **kw)

    check(torch.equal(k_int(), k_acc()), f"{tag}: K1 {acc} differs from K1 int")
    t = {"int": [], acc: []}
    for name, fn in (("int", k_int), (acc, k_acc), (acc, k_acc), ("int", k_int)):
        t[name].append(_time_ms(fn, iters=10, warmup=1))
    ref = []
    plain_ms = _time_ms(lambda: ref.append(scan.align_scores_grouped(*args, m32, **kw)),
                        iters=1, warmup=0)
    check(torch.equal(ref[0], k_acc()), f"{tag}: K1 {acc} differs from its plain version")
    del ref
    nbytes, _, true = _work("slab", args, {"mode": "SW"})
    cells = G * B * N * m
    ti, ta = min(t["int"]), min(t[acc])
    say(f"[13] {tag} G={G} B={B} N={N} m={m}, {card}, in turns: int {t['int'][0]:.3f} then "
        f"{t['int'][1]:.3f} ms ({cells / ti / 1e6:.2f} GCUPS padded, {true / ti / 1e6:.2f} "
        f"true); {acc} {t[acc][0]:.3f} then {t[acc][1]:.3f} ms ({cells / ta / 1e6:.2f} padded, "
        f"{true / ta / 1e6:.2f} true); {acc} over int {ti / ta:.3f}x; plain {acc} "
        f"{plain_ms:.3f} ms; geometry int {sw_grouped.launch_geometry(G, B, N, dev)}, "
        f"{acc} {sw_grouped.launch_geometry(G, (B + 1) // 2 if acc == 'i16' else B, N, dev)}")
    torch.cuda.empty_cache()
    return ti, ta, plain_ms, (nbytes, true), cells


# packed instructions a cell pair of the int16 SW loop: F, G and E one
# VIADDMNMX.S16x2 each (G's .RELU), H one VIMNMX.S16x2, the best one
# VIMNMX3.S16x2 every second row, two VIADD.16x2 (H - go, G - go) and one
# PRMT (the score pair)
I16_LOOP_EXPECTED = {"VIADDMNMX.S16x2": 2, "VIADDMNMX.S16x2.RELU": 1, "VIMNMX.S16x2": 1,
                     "VIMNMX3.S16x2": 0.5, "VIADD.16x2": 2, "PRMT": 1}


def phase_acc(dev, card):
    """K1's int16 and float32 accumulators: exact against their plain
    versions and K1 int, refused where the JAX wrapper refuses, timed in
    turns against K1 int, their SASS loops, and their paths (``bench_ab
    ab`` for int16, ``make_grouped_sharded(acc="f32")`` for float32) with
    the launches counted."""
    import io
    import torch
    from sift4g_tpu_torch.align import roofline, scan, sw_grouped
    from sift4g_tpu_torch.parallel import sharded
    from sift4g_tpu_torch.tools import bench_ab

    max_err, n = {"i16": 0, "f32": 0}, 0
    for name, args, m32, (go, ge), max_qlen in _acc_cases(dev):
        t0 = time.perf_counter()
        N = args[3].shape[2]
        bounds = dict(max_qlen=max_qlen, max_sub=int(m32.max()))
        check(scan.i16_admissible(max_qlen, bounds["max_sub"], go, ge, N), f"{name}: refused")
        best = 0
        for mode in MODES:
            kw = dict(mode=mode, gap_open=go, gap_extend=ge)
            ref = sw_grouped.sw_scores_grouped(*args, m32, **kw)
            best = max(best, int(ref.max()))
            for acc in ("i16", "f32"):
                plain = scan.align_scores_grouped(*args, m32, acc=acc, **bounds, **kw)
                check(torch.equal(plain, ref), f"{name} {mode}: plain {acc} differs from K1 int")
                for T in all_T():
                    got = sw_grouped.sw_scores_grouped(*args, m32, acc=acc, threads_per_target=T,
                                                       **bounds, **kw)
                    torch.cuda.synchronize()
                    err = int((got.long() - plain.long()).abs().max())
                    max_err[acc] = max(max_err[acc], err)
                    check(err == 0, f"{name} {mode} T={T}: K1 {acc} differs from its plain "
                                    f"version by up to {err}")
                    n += 1
        G, B, _ = args[3].shape
        say(f"[13] {name:22s} G={G} B={B} N={N} qlens<={max_qlen} gaps {go}/{ge} (bound "
            f"{max_qlen * bounds['max_sub'] + go + (N + 1) * ge} < 8000; best SW cell {best}): "
            f"K1 i16 == plain i16 == K1 f32 == plain f32 == K1 int in all four modes at every "
            f"T ({time.perf_counter() - t0:.2f} s)")
    say(f"[13] K1 i16 and f32 exact on {n} launches")

    # refusals: before any launch
    q, o, ql, tg, tl = grouped_inputs(np.random.default_rng(5), 2, 9, 512, (100, 7), dev)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(
        np.random.default_rng(5))), dev)
    before = _counts()
    for bad in (dict(max_qlen=624, max_sub=12, acc="i16"), dict(acc="i16"), dict(acc="i8")):
        try:
            sw_grouped.sw_scores_grouped(q, o, ql, tg, tl, m32, **bad)
        except ValueError as exc:
            say(f"[13] refused {bad}: {exc}")
        else:
            check(False, f"K1 accepted {bad}")
    check(_counts() == before, "a refused request launched a kernel")

    # timing in turns
    ti, ta, plain_i16, work_i16, cells = _acc_timing(dev, card, "bench launch i16", 64, 1024, 512,
                                                     360, None, "i16", 42)
    bound_ms, bound_by = _bound(work_i16[0], work_i16[1] * roofline.MAX_INSTRUCTIONS_PER_CELL_I16)
    say(f"[13] i16 at the bench launch, {card}: {ta:.3f} ms, {cells / ta / 1e6:.2f} GCUPS; its "
        f"bound {bound_ms:.3f} ms ({bound_by}: {roofline.MAX_INSTRUCTIONS_PER_CELL_I16} "
        f"max-family instructions a SW cell at {INT32['per_s'] / 1e12:.3f} T/s; "
        f"{100 * bound_ms / ta:.1f} % of it); K1 int {ti:.3f} ms")
    i16 = dict(ms=ta, plain_ms=plain_i16, work=(work_i16[0],
                                               work_i16[1] * roofline.MAX_INSTRUCTIONS_PER_CELL_I16))
    _acc_timing(dev, card, "main-like i16", 36, 4096, 384, 360, (193, 385), "i16", 7)
    ti, tf, plain_f32, work_f32, _ = _acc_timing(dev, card, "bench launch f32", 64, 1024, 512,
                                                 360, None, "f32", 42)
    f32 = dict(ms=tf, plain_ms=plain_f32, work=(work_f32[0], work_f32[1]
                                                * roofline.MAX_INSTRUCTIONS_PER_CELL["SW"]))

    # the SASS of K1's three SW loops
    sass = roofline.k1_sw_loop_sass()
    if sass is None:
        say("[13] SASS: cuobjdump not found; loop opcodes not read")
    for name, (ops, cells, per) in sorted((sass or {}).items()):
        unit = "cell pair" if name == "sw_pair16_kernel" else "cell"
        check(per is not None, f"{name}: no column loop found in the SASS")
        say(f"[13] SASS column loop of {name} (SW, slabs): {cells} {unit}s of code, {per:.3f} "
            f"instructions a {unit}, {dict(ops.most_common())}")
    if sass and "sw_pair16_kernel" in sass:
        ops, cells, per = sass["sw_pair16_kernel"]
        got = {op: ops.get(op, 0) / cells for op in I16_LOOP_EXPECTED}
        forms = sorted(op for op in ops if ".S16x2" in op or ".16x2" in op)
        emulated = [op for op, want in I16_LOOP_EXPECTED.items() if got[op] < want]
        say(f"[13] int16 loop, packed forms present: {forms}; a cell pair: "
            + ", ".join(f"{op} {got[op]:g} (needed {want:g})"
                        for op, want in I16_LOOP_EXPECTED.items())
            + f"; {per:.3f} instructions a cell pair ({per / 2:.3f} a cell); "
            + (f"fewer than needed, so emulated or merged: {emulated}" if emulated
               else "no packed add or max emulated"))
        check(got["VIADDMNMX.S16x2.RELU"] > 0 and got["VIMNMX3.S16x2"] > 0,
              "the int16 SW loop has no fused packed add-max")

    # the int16 path: bench_ab ab, counted
    sw_grouped.reset_counters()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_ab.main(["ab"])
    i16["launches"] = sw_grouped.i16_launches
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        say(f"[13] bench_ab ab: {line}")
    check(rc == 0 and json.loads(lines[-1]).get("parity") == "ok", "bench_ab ab: no parity line")
    check(i16["launches"] > 0, "bench_ab ab launched the int16 kernel no time")
    say(f"[13] bench_ab ab: {i16['launches']} int16 launches, {sw_grouped.kernel_launches} int32")

    # the float32 path: make_grouped_sharded(acc="f32") on the device list, counted
    name, args, m32, (go, ge), max_qlen = _acc_cases(dev)[0]
    mesh = shard_devices()
    G = args[3].shape[0]
    want = sw_grouped.sw_scores_grouped(*args, m32, mode="OV", gap_open=go, gap_extend=ge)
    for acc in ("f32", "i16"):
        fn = sharded.make_grouped_sharded(mesh, mode="OV", gap_open=go, gap_extend=ge,
                                          max_qlen=max_qlen, max_sub=int(m32.max()), acc=acc)
        sw_grouped.reset_counters()
        got = fn(*args, m32)
        _sync_all()
        counts = _counts()
        check(torch.equal(torch.cat([x.to(dev) for x in got]), want),
              f"make_grouped_sharded acc={acc} differs from K1 int")
        check(counts[f"{acc}_launches"] == len(mesh) and counts["twin_calls_on_cuda"] == 0,
              f"make_grouped_sharded acc={acc}: {counts}")
        if acc == "f32":
            f32["launches"] = counts["f32_launches"]
        say(f"[13] make_grouped_sharded(acc={acc!r}) on {len(mesh)} shards, G={G}: == K1 int; "
            f"{counts}")
    i16["max_abs_err"], f32["max_abs_err"] = max_err["i16"], max_err["f32"]
    return i16, f32


_BENCH_RUN = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["sift4g_tpu"] = None
sys.argv = ["sift4g_tpu_torch.bench"]
runpy.run_module("sift4g_tpu_torch.bench", run_name="__main__", alter_sys=True)
"""


def phase_bench(card, k1_gcups):
    """The bench twin end to end, in a process of its own."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_RUN], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    check(proc.returncode == 0,
          f"python -m sift4g_tpu_torch.bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    say(f"[8] python -m sift4g_tpu_torch.bench ({time.perf_counter() - t0:.1f} s): "
        f"record {json.dumps(rec)}")
    name, power_limit = (v.strip() for v in card.split(","))
    check(rec["card"] == name and rec["power_limit"] == power_limit,
          f"the bench record names {rec['card']!r}, {rec['power_limit']!r}, not {card!r}")
    check(rec["metric"] == "sw_score_gcups[cuda-grouped]", f"metric {rec['metric']!r}")
    check(abs(rec["value"] - k1_gcups) <= 0.10 * k1_gcups,
          f"bench value {rec['value']:.3f} GCUPS is not within 10 % of phase 3's "
          f"{k1_gcups:.3f}")
    check(0 < rec["roofline_pct"] <= 105, f"roofline_pct {rec['roofline_pct']:.2f}")
    check(rec["launches"]["sw_grouped"] > 0 and rec["launches"]["dp_row_probe"] > 0,
          f"the bench launched K1/K5 no time: {rec['launches']}")
    say(f"[8] bench: {rec['value']:.3f} GCUPS (phase 3: {k1_gcups:.3f}), marginal "
        f"{rec.get('marginal_gcups')}; roofline_pct {rec['roofline_pct']:.2f} of the operations "
        f"bound {rec['roofline_ops_gcups']:.3f} GCUPS, marginal "
        f"{rec.get('marginal_roofline_pct')}; K5 {rec['roofline_gcups']:.3f} GCUPS at B=65536 "
        f"({rec['roofline_gcups_b1024']:.3f} at B=1024); CPU scalar "
        f"{rec['baseline_gcups']:.3f}, SIMD {rec['cpu_simd_gcups']:.3f} GCUPS; {card}")
    return rec


def single_inputs(rng, B, N, m_pad, qlen, dev, zero_len=True):
    """K4's inputs on the card: one query (PAD_CODE past ``qlen``) and B
    int32 rows of width N, codes from the whole int32 range past every
    length (a read past a length changes a score) and, with ``zero_len``,
    ragged lengths with zero-length rows (else full rows); the first row
    is N long."""
    import torch

    targets = rng.integers(-2**31, 2**31, (B, N), dtype=np.int64).astype(np.int32)
    lens = rng.integers(0 if zero_len else N, N + 1, B).astype(np.int32)
    if zero_len:
        lens[-1] = 0
    lens[0] = N
    mask = np.arange(N)[None, :] < lens[:, None]
    targets[mask] = rng.integers(0, 26, int(mask.sum()))
    q = np.full(m_pad, 31, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    return [torch.from_numpy(a).to(dev) for a in (q, targets, lens)]


def shard_devices():
    """Every visible card, or two shards of the one card."""
    import torch

    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else [torch.device("cuda", 0)] * 2


def _sync_all():
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_single_parity(dev):
    """9a: K4 against its plain version, exact, in all four modes, at its
    own T and at every forced T."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped
    from sift4g_tpu_torch.align.sw_grouped import GROUP_THREADS, TILE_ROWS

    rng = np.random.default_rng(9)
    cases = [
        # name, B, N, m_pad, query length, gaps
        ("ragged", 300, 512, 384, 361, (10, 1)),
        ("N=200", 257, 200, 64, 50, (11, 2)),
        ("B=1 N=37", 1, 37, 32, 9, (10, 1)),
        ("8192-aa query", 32, 512, 8192, 8192, (11, 2)),
    ]
    max_err = 0
    for name, B, N, m_pad, qlen, (go, ge) in cases:
        m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
        q, t, tl = single_inputs(rng, B, N, m_pad, qlen, dev)
        ql = torch.tensor([qlen], dtype=torch.int32, device=dev)
        auto = sw_grouped.launch_geometry(1, B, N, dev)
        for mode in MODES:
            t0 = time.perf_counter()
            kw = dict(mode=mode, gap_open=go, gap_extend=ge)
            ref = scan.align_scores(q, qlen, t, tl, m32, **kw)
            for T in all_T():
                got = sw_grouped.sw_scores_single(q, ql, t, tl, m32, threads_per_target=T, **kw)
                torch.cuda.synchronize()
                err = int((got.long() - ref.long()).abs().max())
                max_err = max(max_err, err)
                check(got.shape == (B,) and got.dtype == torch.int32,
                      f"K4 {name} {mode} T={T}: shape/dtype")
                check(err == 0, f"K4 {name} {mode} T={T}: differs from its plain version by up "
                                f"to {err}")
            say(f"[9a] {name:14s} {mode}: B={B} N={N} qlen={qlen} gaps {go}/{ge}: K4 == plain "
                f"at its own (T, block) = {auto} and at every forced T (max |diff| 0, "
                f"{time.perf_counter() - t0:.2f} s)")
    # the tiled body's pass boundaries, for every T
    N = 200
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    q, t, tl = single_inputs(rng, 64, N, 8192, 8192, dev)
    tl[:6] = torch.tensor([0, 1, 15, 16, 17, N], dtype=torch.int32, device=dev)
    qlens = sorted({0, 1, 8192} | {T * TILE_ROWS + d for T in GROUP_THREADS for d in (-1, 0, 1)})
    for mode in MODES:
        t0 = time.perf_counter()
        kw = dict(mode=mode, gap_open=11, gap_extend=2)
        for qlen in qlens:
            ref = scan.align_scores(q, qlen, t, tl, m32, **kw)
            for T in all_T():
                got = sw_grouped.sw_scores_single(q, qlen, t, tl, m32, threads_per_target=T, **kw)
                torch.cuda.synchronize()
                err = int((got.long() - ref.long()).abs().max())
                max_err = max(max_err, err)
                check(err == 0, f"K4 pass boundaries {mode} qlen={qlen} T={T}: differs from its "
                                f"plain version by up to {err}")
        say(f"[9a] pass boundaries {mode}: B=64 N={N} qlens={tuple(qlens)}, target lengths 0, "
            f"1, 15, 16, 17, N and random, gaps 11/2: K4 == plain at every T (max |diff| 0, "
            f"{time.perf_counter() - t0:.2f} s)")
    return max_err


def phase_single_timing(dev, card):
    """9b: K4 at full width (K5's bench shape), kernel and plain version
    timed with CUDA events."""
    from sift4g_tpu_torch.align import scan, sw_grouped
    from sift4g_tpu_torch.align.roofline import MAX_INSTRUCTIONS_PER_CELL

    B, N, m = 65536, 512, 360
    rng = np.random.default_rng(44)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    q, t, tl = single_inputs(rng, B, N, 384, m, dev, zero_len=False)

    def kernel():
        return sw_grouped.sw_scores_single(q, m, t, tl, m32)

    def plain():
        return scan.align_scores(q, m, t, tl, m32)

    err = int((kernel().long() - plain().long()).abs().max())
    check(err == 0, f"K4 at B={B} N={N}: differs from its plain version by up to {err}")
    ms = _time_ms(kernel, iters=10, warmup=2)
    plain_ms = _time_ms(plain, iters=2, warmup=1)
    cells = int(tl.long().sum()) * m
    nbytes = 4 * (t.numel() + tl.numel() + q.numel() + B + 32 * 32)
    insns = cells * MAX_INSTRUCTIONS_PER_CELL["SW"]
    bound_ms, bound_by = _bound(nbytes, insns)
    T, block = sw_grouped.launch_geometry(1, B, N, dev)
    per_cell = tiled_bytes_per_cell(T, code_bytes=4)
    say(f"[9b] K4 B={B} N={N} m={m} ({cells / 1e9:.2f} G cells), {card}: kernel {ms:.3f} ms = "
        f"{cells / ms / 1e6:.2f} GCUPS at (T, block) = ({T}, {block}); plain {plain_ms:.3f} ms; "
        f"bound {bound_ms:.3f} ms ({bound_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s, "
        f"{insns / 1e9:.2f} G max-family instructions at {INT32['per_s'] / 1e12:.3f} T/s; the "
        f"kernel at {100 * bound_ms / ms:.1f} % of it); design bound ({per_cell:.4f} B/cell at "
        f"3.35 TB/s) "
        f"{cells * per_cell / HBM_BYTES_PER_S * 1e3:.3f} ms; kernel == plain (max |diff| 0)")
    if PARENT["k"]:
        check_unmoved(f"K4 at B={B} N={N} m={m}", *parent_turns(
            "9b", f"K4 at B={B} N={N} m={m}", kernel, lambda: PARENT["k"].k4(q, m, t, tl, m32),
            10, card, cells))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, work=(nbytes, insns))


def _top(x, k):
    """The k best along the last axis, ties by ascending index (the
    factories' order)."""
    import torch

    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def phase_factories(dev, card):
    """9c: every factory of parallel/sharded.py on the device list against
    the unsharded kernel; each factory's launches counted alone."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped
    from sift4g_tpu_torch.parallel import sharded

    mesh = shard_devices()
    n = len(mesh)
    rng = np.random.default_rng(12)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    counts, max_err = {}, 0

    def run(name, fn, *args):
        sw_grouped.reset_counters()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync_all()
        secs = time.perf_counter() - t0
        c = counts[name] = dict(K4=sw_grouped.single_launches, K1=sw_grouped.kernel_launches,
                                K2=sw_grouped.long_launches, K3=sw_grouped.resident_launches,
                                twin=sw_grouped.twin_calls_on_cuda)
        check(c["twin"] == 0, f"{name}: a plain version ran on the card {c['twin']} times")
        check(c["K4"] + c["K1"] + c["K2"] + c["K3"] >= n,
              f"{name}: launched fewer kernels than shards")
        return out, secs

    def same(name, got, want, secs, of=None):
        """``got`` equal to ``want``; ``of`` names the counted run."""
        nonlocal max_err
        got = got.to(want.device)
        check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) if want.numel() else 0
        max_err = max(max_err, err)
        check(err == 0, f"{name}: differs from the unsharded kernel by up to {err}")
        say(f"[9c] {name} on {n} shards ({', '.join(str(d) for d in mesh)}): == unsharded "
            f"(max |diff| 0; {secs:.3f} s; launches {counts[of or name]})")

    # one query against B int32 targets: K4 per shard
    B, N, m = 8192 - 8192 % n, 512, 360
    q, t, tl = single_inputs(rng, B, N, 384, m, dev)
    ql = torch.tensor(m, dtype=torch.int32)
    want = sw_grouped.sw_scores_single(q, m, t, tl, m32)
    got, secs = run("make_sharded_scores", sharded.make_sharded_scores(mesh), q, ql, t, tl, m32)
    same("make_sharded_scores", torch.cat([s.to(dev) for s in got]), want, secs)
    k = 64
    (scores, top_s, top_i), secs = run(
        "make_sharded_topk_align", sharded.make_sharded_topk_align(mesh, k=k), q, ql, t, tl, m32)
    ws, wi = _top(want, k)
    same("make_sharded_topk_align", torch.cat([s.to(dev) for s in scores]), want, secs)
    same("make_sharded_topk_align top-k scores", top_s, ws, secs, "make_sharded_topk_align")
    same("make_sharded_topk_align top-k indices", top_i.long(), wi, secs,
         "make_sharded_topk_align")

    # grouped launches: K1 per shard on the group axis, with and without
    # the screen
    G = 4 * n
    args = grouped_inputs(rng, G, 1024, 512, (360, 0, 17, 128) * n, dev)
    want = sw_grouped.sw_scores_grouped(*args, m32)
    smin = torch.full((G,), 25, dtype=torch.int32, device=dev)
    for screen_k in (0, 400):
        name = f"make_grouped_sharded screen_k={screen_k}"
        extra = (smin,) if screen_k else ()
        ref = scan.screen_topk_words(want, smin, screen_k) if screen_k else want
        got, secs = run(name, sharded.make_grouped_sharded(mesh, screen_k=screen_k),
                        *args, m32, *extra)
        same(name, torch.cat([s.to(dev) for s in got]), ref, secs)

    # resident launches: K3 per shard, the database on every device
    q3, o3, ql3, db, st, tl3 = resident_inputs(rng, G, 300, 512, (361, 0, 17, 255) * n, dev)
    want = sw_grouped.sw_scores_grouped_resident(q3, o3, ql3, db, st, tl3, m32, 512)
    dbs = sharded.replicate_to_mesh(mesh, db)
    got, secs = run("make_grouped_resident_sharded",
                    sharded.make_grouped_resident_sharded(mesh, n_pad=512),
                    q3, o3, ql3, dbs, st, tl3, m32)
    same("make_grouped_resident_sharded", torch.cat([s.to(dev) for s in got]), want, secs)

    # long targets: one group, rows on the batch axis (K2's launch shape),
    # K2 on every shard
    B_long = 256 - 256 % n
    args = grouped_inputs(rng, 1, B_long, 8192, (360,), dev, zero_len=False)
    want = sw_grouped.sw_scores_grouped_long(*args, m32)
    got, secs = run("make_grouped_long_sharded", sharded.make_grouped_long_sharded(mesh),
                    *args, m32)
    check(counts["make_grouped_long_sharded"]["K2"] == n,
          "make_grouped_long_sharded did not launch K2 on every shard")
    same("make_grouped_long_sharded", torch.cat([s.to(dev) for s in got], dim=1), want, secs)

    # batched queries on a (2, 2) grid: query blocks x database shards
    devs = mesh if n >= 4 and n % 2 == 0 else (mesh * 4)[:4]
    grid = [devs[: len(devs) // 2], devs[len(devs) // 2 :]]
    Q, B2 = 4, 4096 - 4096 % len(grid[0])
    queries = torch.full((Q, 384), 31, dtype=torch.int32, device=dev)
    qlens = torch.tensor([360, 200, 17, 301], dtype=torch.int32, device=dev)
    for j in range(Q):
        queries[j, : int(qlens[j])] = torch.from_numpy(rng.integers(0, 26, int(qlens[j])))
    _, t2, tl2 = single_inputs(rng, B2, 512, 8, 1, dev)
    want = torch.stack([sw_grouped.sw_scores_single(queries[j], int(qlens[j]), t2, tl2, m32)
                        for j in range(Q)])
    ws, wi = _top(want, k)
    (top_s, top_i), secs = run("make_sharded_pipeline_step",
                               sharded.make_sharded_pipeline_step(grid, k=k),
                               queries, qlens, t2, tl2, m32)
    of = "make_sharded_pipeline_step"
    same(of + " top-k scores", torch.cat([s.to(dev) for s in top_s]), ws, secs, of)
    same(of + " top-k indices", torch.cat([s.to(dev) for s in top_i]).long(), wi, secs, of)
    k4 = sum(c["K4"] for c in counts.values())
    check(k4 > 0, "the sharded factories launched K4 no time")
    say(f"[9c] K4 launches on its path (make_sharded_scores, make_sharded_topk_align, "
        f"make_sharded_pipeline_step): {k4}; K1 {sum(c['K1'] for c in counts.values())}, "
        f"K2 {sum(c['K2'] for c in counts.values())}, "
        f"K3 {sum(c['K3'] for c in counts.values())}; plain versions on the card 0")
    torch.cuda.empty_cache()
    return max_err, k4


def _counted_pipeline(devices, flags, main, out, tag):
    """``run_pipeline`` at the CLI's defaults on ``devices``, counted and
    timed as :func:`_counted_run` counts a CLI run."""
    from sift4g_tpu_torch.align import sw_grouped
    from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from sift4g_tpu_torch.utils import PhaseMetrics

    metrics = PhaseMetrics(log=sys.stderr, enabled=True)
    cfg = PipelineConfig(query_path=main.q, database_path=main.db, subst_path=main.data,
                         out_path=out, align_backend="cuda", timings=True, overlap="off",
                         metrics=metrics, log=sys.stderr, **flags)
    sw_grouped.reset_counters()
    t0 = time.perf_counter()
    run_pipeline(cfg, devices)
    wall = time.perf_counter() - t0
    counts = _counts()
    align = metrics.phases["align"]
    say(f"[{tag}] {wall:.2f} s wall, align {align['seconds']:.3f} s, "
        f"{align['cells'] / align['seconds'] / 1e9:.2f} GCUPS over the align phase, "
        + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return counts


def phase_sharded_main_path(main, tmp):
    """9d: the main path across the devices, byte-identical to phase 4's
    ``--backend native`` outputs."""
    import torch
    from sift4g_tpu_torch.align.resident import drop_resident_db

    cards = "".join(str(i) for i in range(torch.cuda.device_count()))
    runs = [(f"CLI --cards {cards}", ["--cards", cards], None),
            (f"CLI --cards {cards} --resident-db on", ["--cards", cards, "--resident-db", "on"],
             None)]
    if len(cards) == 1:
        two = shard_devices()
        runs += [("run_pipeline [cuda:0, cuda:0]", {}, two),
                 ("run_pipeline [cuda:0, cuda:0] --resident-db on", {"resident_db": "on"}, two)]
    for i, (tag, flags, devices) in enumerate(runs):
        out = os.path.join(tmp, f"out-9d-{i}")
        os.mkdir(out)
        resident = "on" in (flags if devices is None else flags.values())
        drop_resident_db()
        t0 = time.perf_counter()
        if devices is None:
            _, _, c, _ = _counted_run(["--backend", "cuda", "--overlap", "off", "-q", main.q,
                                       "-d", main.db, "--subst", main.data, "--out", out,
                                       *flags], "9d")
        else:
            c = _counted_pipeline(devices, flags, main, out, "9d")
        if resident:
            check(c["resident_launches"] > 0 and c["kernel_launches"] == 0,
                  f"{tag}: left the resident path")
        else:
            check(c["kernel_launches"] > 0 and c["resident_launches"] == 0,
                  f"{tag}: left the slab path")
        check(c["twin_calls_on_cuda"] == 0, f"{tag}: a plain version ran on the card")
        n = _same_tree(out, main.native_out, tag)
        say(f"[9d] {tag}: {n} files byte-identical to --backend native "
            f"({time.perf_counter() - t0:.2f} s)")
    drop_resident_db()


def phase_sharded(dev, card, main, tmp):
    t0 = time.perf_counter()
    err_a = phase_single_parity(dev)
    say(f"[9a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k4 = phase_single_timing(dev, card)
    say(f"[9b] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    err_c, k4_launches = phase_factories(dev, card)
    say(f"[9c] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_sharded_main_path(main, tmp)
    say(f"[9d] took {time.perf_counter() - t0:.1f} s")
    k4["max_abs_err"] = max(k4["max_abs_err"], err_a, err_c)
    k4["launches"] = k4_launches
    return k4


def _alignment_rows(rng, n, L):
    """``tests/test_sift_jax.py``'s random alignment: a quarter of the
    cells 'X', the query row standard letters."""
    rows = rng.integers(0, 26, size=(n, L)).astype(np.uint8)
    rows[rng.random((n, L)) < 0.25] = ord("X") - ord("A")
    rows[0] = rng.integers(0, 20, size=L)
    return rows


def phase_scores_torch(dev):
    """10a: the float32 scoring math of device predict on the card against
    its CPU run and the float64 oracle, bit-identical between card runs,
    and not in TF32."""
    import torch
    from sift4g_tpu_torch.sift import scores as S
    from sift4g_tpu_torch.sift import scores_torch as ST

    worst_oracle = worst_cpu = 0.0
    for n, L in ((5, 40), (40, 120), (2, 8)):
        rows = _alignment_rows(np.random.default_rng(9), n, L)
        raw = S.create_matrix(rows, np.ones(n))[0]
        want, _, want_nd = S.calc_sift_scores(rows, raw)
        r, rw = torch.from_numpy(rows)[None], torch.from_numpy(raw.astype(np.float32))[None]
        got, _, got_nd = ST.calc_sift_scores(r.to(dev), rw.to(dev))
        cpu, _, _ = ST.calc_sift_scores(r, rw)
        got = got[0].cpu().numpy()
        check(np.array_equal(got_nd[0].cpu().numpy(), want_nd), f"ndiff differs at {n}x{L}")
        check(np.allclose(got, want, rtol=2e-3, atol=2e-4), f"card vs oracle at {n}x{L}")
        check(np.allclose(got, cpu[0].numpy(), rtol=2e-3, atol=2e-4), f"card vs CPU at {n}x{L}")
        worst_oracle = max(worst_oracle, float(np.abs(got - want).max()))
        worst_cpu = max(worst_cpu, float(np.abs(got - cpu[0].numpy()).max()))
    # a full chunk of the predict mix, padded to its (L_pad, n_pad) bucket
    from sift4g_tpu_torch.tools.bench_predict import make_inputs

    _, prepared = make_inputs(64, seed=11)
    L_pad = max(-(-r.shape[1] // 128) * 128 for r in prepared)
    n_pad = max(-(-r.shape[0] // 64) * 64 for r in prepared)
    packed = np.full((64, n_pad, L_pad), ord("X") - ord("A"), dtype=np.int8)
    for j, r in enumerate(prepared):
        packed[j, : r.shape[0], : r.shape[1]] = r
    nv = torch.tensor([r.shape[0] for r in prepared], dtype=torch.int32)
    rows_d, nv_d = torch.from_numpy(packed).to(dev), nv.to(dev)
    first = ST.sift_scores_from_rows_batch(rows_d, nv_d)
    second = ST.sift_scores_from_rows_batch(rows_d, nv_d)
    check(torch.equal(first, second), "two card runs of one chunk differ")
    # TF32 switched on around the call must change nothing: no product of
    # the math goes through cuBLAS
    torch.set_float32_matmul_precision("high")
    try:
        third = ST.sift_scores_from_rows_batch(rows_d, nv_d)
    finally:
        torch.set_float32_matmul_precision("highest")
    check(torch.equal(first, third), "the chunk's scores changed with TF32 switched on")
    first = first.cpu().numpy()
    for j in range(0, 64, 9):
        r = prepared[j]
        raw = S.create_matrix(r, np.ones(r.shape[0]))[0]
        want = S.calc_sift_scores(r, raw)[0]
        got = first[j, : r.shape[1]]
        check(np.allclose(got, want, rtol=2e-3, atol=2e-4), f"chunk query {j} vs oracle")
        worst_oracle = max(worst_oracle, float(np.abs(got - want).max()))
    ms = _time_ms(lambda: ST.sift_scores_from_rows_batch(rows_d, nv_d), iters=5, warmup=1)
    plain = ST.sift_scores_from_rows_batch(torch.from_numpy(packed[:8]), nv[:8])
    check(np.allclose(first[:8], plain.numpy(), rtol=2e-3, atol=2e-4), "chunk card vs CPU")
    say(f"[10a] scores_torch on the card: max |card - f64 oracle| {worst_oracle:.3g}, "
        f"|card - CPU| {worst_cpu:.3g} (rtol 2e-3, atol 2e-4); one chunk of 64 queries at "
        f"(L_pad, n_pad) = ({L_pad}, {n_pad}) {ms:.3f} ms, bit-identical across runs and "
        f"with TF32 switched on around the call")


def phase_device_predict(main, tmp):
    """10b-10d: device predict and the overlapped schedule through the CLI
    at Swiss-Prot scale, each run held byte for byte to phase 4's
    ``--backend native`` (host predict, two-phase) outputs; matrix mode
    within a printed digit of the host oracle and bit-identical between
    two card runs; and whether ``auto`` overlaps on this host."""
    import torch
    from sift4g_tpu_torch import pipeline as tpipe
    from sift4g_tpu_torch.sift import predict_batch

    real, seen = predict_batch.predict_matrix_batch, []

    def recorded(*args, **kw):
        seen.append(torch.device(kw.get("device")))
        return real(*args, **kw)

    predict_batch.predict_matrix_batch = recorded
    try:
        runs = [("10b", "overlap off, device predict",
                 ["--overlap", "off", "--predict-backend", "device"]),
                ("10d", "overlap on, host predict", ["--overlap", "on"]),
                ("10d", "overlap on, device predict",
                 ["--overlap", "on", "--predict-backend", "device"])]
        for i, (tag, what, flags) in enumerate(runs):
            out = os.path.join(tmp, f"out-10-{i}")
            os.mkdir(out)
            del seen[:]
            wall, m, c, _ = _counted_run(["--backend", "cuda", *flags, "-q", main.q, "-d",
                                          main.db, "--subst", main.data, "--out", out], tag)
            check(c["kernel_launches"] > 0 and c["resident_launches"] == 0,
                  f"{what}: left the slab path")
            check(c["twin_calls_on_cuda"] == 0, f"{what}: a plain version ran on the card")
            device = "--predict-backend" in flags
            check(device == bool(seen), f"{what}: device predict ran {len(seen)} times")
            check(all(d.type == "cuda" for d in seen), f"{what}: device predict left the card")
            overlapped = "overlapped" in m.phases["search"]
            check(overlapped == ("on" in flags), f"{what}: overlapped={overlapped}")
            n = _same_tree(out, main.native_out, what)
            sub = " ".join(f"{k}={v['seconds']:.3f}s" for k, v in m.phases.items()
                           if k.startswith("predict"))
            say(f"[{tag}] {what}: {n} files byte-identical to --backend native (host "
                f"predict, two-phase); {wall:.2f} s wall; {sub}")

        # 10c: matrix mode, twice on the card
        outs = []
        for k in range(2):
            out = os.path.join(tmp, f"out-10c-{k}")
            os.mkdir(out)
            _run_cli(["--backend", "cuda", "--overlap", "off", "--predict-backend", "device",
                      "-q", main.q5, "-d", main.db, "--out", out])
            outs.append(out)
        check(bool(seen) and all(d.type == "cuda" for d in seen), "matrix mode left the card")
    finally:
        predict_batch.predict_matrix_batch = real
    n_mat = _same_tree(outs[0], outs[1], "matrix mode, two card runs")
    worst = 0.0
    for name in sorted(os.listdir(main.native_matrix_out)):
        if not name.endswith(".SIFTprediction"):
            continue
        want = _matrix_values(os.path.join(main.native_matrix_out, name))
        got = _matrix_values(os.path.join(outs[0], name))
        check(want.shape == got.shape and want.size > 0, f"matrix {name}: shapes differ")
        check(np.allclose(got, want, rtol=0, atol=1.5e-4),
              f"matrix {name}: beyond a printed digit of the host oracle")
        worst = max(worst, float(np.abs(got - want).max()))
    say(f"[10c] matrix mode, 5 queries: {n_mat} files bit-identical between two card runs; "
        f"max |device - host| {worst:.4g} over the printed values (atol 1.5e-4)")

    cfg = tpipe.PipelineConfig(database_path=main.db, align_backend="cuda", overlap="auto",
                               log=sys.stderr)
    chosen = tpipe._overlap_cache(cfg, 50, [torch.device("cuda", 0)]) is not None
    say(f"[10d] --overlap auto on this host: {'overlap' if chosen else 'two-phase'} "
        f"({tpipe._available_cores()} available cores; auto needs 8)")


def _matrix_values(path):
    """The score rows of a matrix-mode ``.SIFTprediction`` file."""
    vals = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if parts and parts[0] not in ("ID", "AC", "DE", "MA", "//") \
                    and not parts[0].isalpha():
                vals.append([float(x) for x in parts])
    return np.asarray(vals)


def phase_predict(dev, main, tmp):
    t0 = time.perf_counter()
    phase_scores_torch(dev)
    say(f"[10a] took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_device_predict(main, tmp)
    say(f"[10b-d] took {time.perf_counter() - t0:.1f} s")


COUNTS_TAG = "SMOKE_COUNTS "


def counted_cli(argv) -> int:
    """``--counted ARGS``: the port's CLI on ARGS in this process.  Every
    CLI run it makes (each daemon job included: the daemon calls
    ``cli.main`` per job) sets the kernel counters to 0 just before it and
    writes them just after, as one ``SMOKE_COUNTS {...}`` line on stderr
    (a daemon job's stderr is its log, relayed to its client), with the
    resident databases built in the run (``uploads``: calls of
    ``get_resident_db`` that did not return the live one), the seconds
    spent in the resident rule and in ``get_resident_db``, in the garbage
    collector, and the card's allocated bytes after the run."""
    import gc

    import torch
    from sift4g_tpu_torch import cli, pipeline
    from sift4g_tpu_torch.align import resident, sw_grouped

    real, stats = cli.main, {}

    def timed(mod, name):
        fn = getattr(mod, name)

        def wrapper(*args, **kw):
            before = resident._RESIDENT_CACHE.get("db")
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                stats[name + "_s"] = stats.get(name + "_s", 0.0) + time.perf_counter() - t0
                if name == "get_resident_db" and resident._RESIDENT_CACHE.get("db") is not before:
                    stats["uploads"] += 1

        setattr(mod, name, wrapper)

    timed(pipeline, "_resident_refusal")
    timed(resident, "get_resident_db")

    def on_gc(phase, _info):
        if phase == "start":
            stats["gc_t0"] = time.perf_counter()
        elif "gc_t0" in stats:
            stats["gc_s"] += time.perf_counter() - stats.pop("gc_t0")

    gc.callbacks.append(on_gc)

    def counted(args=None, metrics=None):
        sw_grouped.reset_counters()
        stats.clear()
        stats.update(uploads=0, gc_s=0.0)
        try:
            return real(args, metrics)
        finally:
            stats.pop("gc_t0", None)
            rec = dict(_counts(), **stats, allocated=torch.cuda.memory_allocated(0)
                       if torch.cuda.is_initialized() else 0)
            print(COUNTS_TAG + json.dumps(rec), file=sys.stderr, flush=True)

    cli.main = counted
    return real(argv) if "--serve" in argv else counted(argv)


def _counts_lines(text):
    return [json.loads(line[len(COUNTS_TAG):]) for line in text.splitlines()
            if line.startswith(COUNTS_TAG)]


def _wait_socket(path, proc, log, timeout=180.0):
    import socket

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if proc.poll() is not None:
            with open(log) as fh:
                raise SystemExit(f"FAIL: the daemon exited {proc.returncode}:\n{fh.read()[-3000:]}")
        if os.path.exists(path):
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                try:
                    c.connect(path)
                    return
                except OSError:
                    pass
        time.sleep(0.2)
    raise SystemExit("FAIL: the daemon's socket never came up")


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, 9)
            p.wait()


def phase_daemon(main, tmp):
    """11: the serve daemon on the card, jobs through ``--connect``."""
    import re

    sock = os.path.join(tmp, "daemon.sock")
    log = os.path.join(tmp, "daemon.err")
    with open(log, "w") as fh:
        daemon = subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                                   "--counted", "--serve", sock], stderr=fh, cwd=ROOT,
                                  start_new_session=True)
    try:
        t0 = time.perf_counter()
        _wait_socket(sock, daemon, log)
        say(f"[11] daemon listening after {time.perf_counter() - t0:.1f} s")

        def job(flags, out=None):
            args = ["--backend", "cuda", "--overlap", "off", "--timings", *flags, "-q", main.q,
                    "-d", main.db, "--subst", main.data]
            if out is not None:
                os.mkdir(out)
                args += ["--out", out]
            proc = subprocess.run([sys.executable, "-m", "sift4g_tpu_torch", "--connect", sock,
                                   *args], capture_output=True, text=True, cwd=ROOT, timeout=900)
            m = re.search(r"\*\* job (\d+) done in ([\d.]+)s \(status (-?\d+)\) \*\*",
                          proc.stderr)
            check(m is not None, f"daemon job {flags}: no status line:\n{proc.stderr[-3000:]}")
            up = re.search(r"align\.upload\s+([\d.]+)s", proc.stderr)
            counts = _counts_lines(proc.stderr)
            check(len(counts) == 1, f"daemon job {flags}: {len(counts)} counter lines")
            return SimpleNamespace(job=int(m.group(1)), elapsed=float(m.group(2)),
                                   status=int(m.group(3)), rc=proc.returncode,
                                   counts=counts[0], stderr=proc.stderr,
                                   resident="HBM-resident database" in proc.stderr,
                                   upload_s=float(up.group(1)) if up else None)

        runs = [("cold, --resident-db on", ["--resident-db", "on"]),
                ("warm, --resident-db on", ["--resident-db", "on"]),
                ("default flags", [])]
        done = []
        for i, (what, flags) in enumerate(runs):
            r = job(flags, os.path.join(tmp, f"out-11-{i}"))
            check(r.status == 0 and r.rc == 0, f"daemon job {what}: status {r.status}:\n"
                  + r.stderr[-3000:])
            check(r.job == i + 1, f"daemon job {what}: job number {r.job}, expected {i + 1}")
            c = r.counts
            check(c["twin_calls_on_cuda"] == 0, f"daemon job {what}: a plain version ran on the card")
            if flags:
                check(r.resident and c["resident_launches"] > 0 and c["kernel_launches"] == 0,
                      f"daemon job {what}: left the resident path ({c})")
            check(c["resident_launches"] + c["kernel_launches"] > 0,
                  f"daemon job {what}: launched no kernel")
            n = _same_tree(os.path.join(tmp, f"out-11-{i}"), main.native_out, f"daemon job {what}")
            kernel = "K3 (resident)" if c["resident_launches"] else "K1 (slabs)"
            say(f"[11] job {r.job} ({what}): {r.elapsed:.3f} s elapsed_s, {kernel}: K1 "
                f"{c['kernel_launches']}, K3 {c['resident_launches']} launches; resident "
                f"databases built {c['uploads']}; align.upload {r.upload_s} s (resident rule "
                f"{c.get('_resident_refusal_s', 0.0):.3f} s, get_resident_db "
                f"{c.get('get_resident_db_s', 0.0):.3f} s); garbage collector {c['gc_s']:.3f} s; "
                f"{c['allocated']} bytes allocated on the card after it; {n} files "
                f"byte-identical to --backend native")
            done.append(r)
        cold, warm, dflt = done
        check(cold.counts["uploads"] == 1, "the cold job built no resident database")
        check(warm.counts["uploads"] == 0 and dflt.counts["uploads"] == 0,
              "a later job built the resident database again")
        say(f"[11] the warm and default-flags jobs reused the cold job's resident database "
            f"(get_resident_db returned the live one; align.upload {warm.upload_s} and "
            f"{dflt.upload_s} s against {cold.upload_s} s cold); allocated after each job: "
            f"{cold.counts['allocated']}, {warm.counts['allocated']}, "
            f"{dflt.counts['allocated']} bytes")
        say(f"[11] elapsed_s: cold {cold.elapsed:.3f} s, warm {warm.elapsed:.3f} s, default flags "
            f"{dflt.elapsed:.3f} s; phase 4's one-shot CLI run (in process, --backend cuda) "
            f"{main.cuda_s:.3f} s")

        bad = job(["--kmer-length", "7"])
        check(bad.status == -1 and bad.job == 4 and "kmer_length possible values" in bad.stderr,
              f"the bad job: status {bad.status}, job {bad.job}")
        check(daemon.poll() is None, "the bad job ended the daemon")
        shut = subprocess.run([sys.executable, "-m", "sift4g_tpu_torch", "--connect", sock,
                               "--shutdown"], capture_output=True, text=True, cwd=ROOT,
                              timeout=120)
        check(shut.returncode == 0, f"--shutdown exited {shut.returncode}: {shut.stderr[-2000:]}")
        check(daemon.wait(timeout=120) == 0, f"the daemon exited {daemon.returncode}")
        check(not os.path.exists(sock), "the daemon left its socket behind")
        say("[11] the bad job returned status -1 and the daemon served on; --shutdown: the "
            "daemon exited 0 and removed its socket")
    finally:
        _stop([daemon])


def phase_multihost(main, tmp):
    """12: two processes of the CLI joined over gloo, both on cuda:0."""
    import socket

    for mode in ("db", "queries"):
        out = os.path.join(tmp, f"out-12-{mode}")
        os.mkdir(out)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs, logs = [], []
        t0 = time.perf_counter()
        try:
            for pid in range(2):
                env = dict(os.environ, SIFT4G_COORDINATOR=f"127.0.0.1:{port}",
                           SIFT4G_NUM_PROCESSES="2", SIFT4G_PROCESS_ID=str(pid))
                logs.append(os.path.join(tmp, f"host{pid}-{mode}.err"))
                with open(logs[-1], "w") as fh:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--counted",
                         "--backend", "cuda", "--overlap", "off", "--mh-shard", mode,
                         "--timings", "-q", main.q, "-d", main.db, "--subst", main.data,
                         "--out", out], stderr=fh, env=env, cwd=ROOT, start_new_session=True))
            for p in procs:
                p.wait(timeout=900)
        finally:
            _stop(procs)
        wall = time.perf_counter() - t0
        texts = []
        for pid, (p, path) in enumerate(zip(procs, logs)):
            with open(path) as fh:
                texts.append(fh.read())
            check(p.returncode == 0, f"--mh-shard {mode}: host {pid} exited {p.returncode}:\n"
                  + texts[-1][-3000:])
        n = _same_tree(out, main.native_out, f"--mh-shard {mode}", hidden=mode == "queries")
        for pid, text in enumerate(texts):
            c = _counts_lines(text)
            check(len(c) == 1, f"--mh-shard {mode}: host {pid} wrote {len(c)} counter lines")
            c = c[0]
            check(c["twin_calls_on_cuda"] == 0, f"--mh-shard {mode}: a plain version ran")
            check(c["kernel_launches"] + c["resident_launches"] > 0,
                  f"--mh-shard {mode}: host {pid} launched no kernel")
            span = [ln for ln in text.splitlines() if "this is host" in ln]
            kernel = "K3 (resident)" if c["resident_launches"] else "K1 (slabs)"
            say(f"[12] --mh-shard {mode}, host {pid}: {kernel}: K1 {c['kernel_launches']}, K3 "
                f"{c['resident_launches']} launches; {span[0].strip('* ') if span else 'its log goes to os.devnull'}")
        lines = texts[0].splitlines()
        table = lines[lines.index("** Phase timings **") + 1:] if "** Phase timings **" in lines else []
        for ln in table:
            if ln.startswith("*   "):
                say(f"[12]   host 0 {ln[4:]}")
        say(f"[12] --mh-shard {mode}: two processes on one card, {wall:.2f} s wall; {n} files "
            f"byte-identical to --backend native")


def run_phase(tag, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--counted"]:
        return counted_cli(argv[1:])
    parent = None
    if argv[:1] == ["--parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    card = run_phase("1", phase_build)
    import torch

    if parent:
        t0 = time.perf_counter()
        PARENT["k"] = load_parent(parent)
        say(f"[1] the parent's kernels from {parent} built in {time.perf_counter() - t0:.2f} s")
        sass_against_parent()

    dev = torch.device("cuda", 0)
    err_k1 = run_phase("2", phase_parity, dev)
    err_k3 = run_phase("2b", phase_resident_parity, dev)
    err_t, k1_gcups = run_phase("3", phase_timing, dev, card)
    err_k1 = max(err_k1, err_t)
    k1_i16, k1_f32 = run_phase("13", phase_acc, dev, card)
    long_rungs = run_phase("3b", phase_long_rungs, dev, card)
    tmp = tempfile.mkdtemp(prefix="sift4g-smoke-")
    try:
        main_path = run_phase("4", phase_main_path, tmp)
        k2 = run_phase("4c", phase_long_tail, main_path, tmp, card)
        k3_launches, k3_recorded = run_phase("4b", phase_resident_path, main_path, tmp)
        k4 = run_phase("9", phase_sharded, dev, card, main_path, tmp)
        run_phase("10", phase_predict, dev, main_path, tmp)
        run_phase("11", phase_daemon, main_path, tmp)
        run_phase("12", phase_multihost, main_path, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k1 = run_phase("5", phase_main_launches, main_path.recorded, card, "slab", "5")
    k3 = run_phase("5b", phase_main_launches, k3_recorded, card, "resident", "5b")
    from sift4g_tpu_torch.align.batch import LONG_RUNG, _long_route

    above = [args for args, _, _ in main_path.recorded if args[3].shape[2] >= LONG_RUNG]
    for args in above:
        groups = zip(args[2].tolist(), args[4].cpu().numpy())
        check(not _long_route(groups), f"K1 launched at rung {args[3].shape[2]}, where the "
                                       f"route gives the launch to K2")
    say(f"[5] K1 launches at rungs >= LONG_RUNG ({LONG_RUNG}) in phase 4's run: {len(above)} of "
        f"{main_path.launches}, each one the route gives K1; K2 launches there: "
        f"{main_path.long_launches}")
    k5 = run_phase("6", phase_dp_row, dev, card, k1_gcups)
    k6 = run_phase("7", phase_int32, dev, card)
    bench = run_phase("8", phase_bench, card, k1_gcups)
    k1["max_abs_err"] = max(k1["max_abs_err"], err_k1)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_k3)
    k5["launches"] = bench["launches"]["dp_row_probe"]
    for row in long_rungs:
        bound_ms, bound_by = _bound(*row["work"])
        par = f", the parent's K2 {row['par_ms']:.3f} ms" if row["par_ms"] else ""
        say(f"[3b] {row['name']} G={row['G']} B={row['B']} N={row['N']}, {card}: K2 "
            f"{row['ms']:.3f} ms ({100 * bound_ms / row['ms']:.1f} % of its bound){par}, K1 "
            f"{row['k1_ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}); design bound (the target's byte a column and the output) "
            f"{row['work'][0] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    kernels = []
    for meta, k, launches in ((K1, k1, main_path.launches), (K2, k2, k2["launches"]),
                              (K3, k3, k3_launches),
                              (K4, k4, k4["launches"]), (K5, k5, k5["launches"]),
                              (K6, k6, k6["launches"]), (K1_I16, k1_i16, k1_i16["launches"]),
                              (K1_F32, k1_f32, k1_f32["launches"])):
        bound_ms, bound_by = _bound(*k["work"])
        kernels.append(dict(meta, launches=launches, max_abs_err=k["max_abs_err"], ms=k["ms"],
                            plain_ms=k["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None))
    say(f"[bound] int32 max-family rate {INT32['per_s'] / 1e12:.3f} T/s ({INT32['src']}); "
        f"memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

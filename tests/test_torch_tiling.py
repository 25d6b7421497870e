"""The launch geometry of the tiled K1/K3/K4 body (``align/sw_grouped.py``
``tile_geometry``) and the wrappers' ``threads_per_target`` keyword, on the
CPU.

The kernel itself runs only on a card (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here the host-side rule is checked on the shapes the
card sees (the bench launch, the main path's largest launches, the
long-target shapes of K2), the keyword's validation, the CPU dispatch to
the plain versions, and the plain version against the Pallas kernel in
interpret mode at the query and target lengths where the kernel's passes
and vector loads change (tolerance: exact int32 equality)."""

import numpy as np
import pytest
import torch

from sift4g_tpu_torch.align import scan, sw_grouped
from sift4g_tpu_torch.align.sw_grouped import GROUP_THREADS, TILE_ROWS, tile_geometry

torch.set_num_threads(1)

H100_SMS = 132
WANT = H100_SMS * sw_grouped.WARPS_PER_SM * 32
MODES = ["SW", "NW", "HW", "OV"]

# (G, B, N): the bench launch, the 50- and 300-query runs' largest K1/K3
# launches at Swiss-Prot scale, a quarter of the bench launch (one card's
# share over four), K2's two shapes, small and narrow launches
SHAPES = {
    "bench": (64, 1024, 512),
    "main-k1": (36, 4096, 384),
    "main-k3": (170, 4096, 384),
    "bench-quarter": (16, 1024, 512),
    "k2-long": (1, 256, 8192),
    "k2-titin": (1, 32, 35008),
    "small": (6, 300, 512),
    "one-row": (1, 1, 512),
    "narrow-rung": (2, 64, 16),
    "empty": (0, 0, 16),
}


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_geometry_is_a_valid_launch(shape):
    G, B, N = shape
    T, block = tile_geometry(G, B, N, H100_SMS)
    assert T in GROUP_THREADS and T & (T - 1) == 0 and T <= 32
    assert block in (32, 64, 128) and block % T == 0
    assert T <= max(1, N // 8)


@pytest.mark.parametrize("shape", [SHAPES["k2-long"], SHAPES["k2-titin"]],
                         ids=["256x8192", "32x35008"])
def test_geometry_gives_k2_shapes_a_warp_per_target_on_separate_sms(shape):
    G, B, N = shape
    T, block = tile_geometry(G, B, N, H100_SMS)
    assert T == 32
    blocks = G * -(-B * T // block)
    assert blocks >= min(H100_SMS, G * B)


@pytest.mark.parametrize("name", ["bench", "main-k1", "main-k3", "bench-quarter", "small"])
def test_geometry_fills_the_card_with_the_fewest_threads(name):
    G, B, N = SHAPES[name]
    T, _ = tile_geometry(G, B, N, H100_SMS)
    assert T >= sw_grouped.MIN_GROUP_THREADS
    assert G * B * T >= WANT or T == 32
    assert T == sw_grouped.MIN_GROUP_THREADS or G * B * (T // 2) < WANT


def test_geometry_values_at_the_main_shapes():
    assert tile_geometry(64, 1024, 512, H100_SMS) == (8, 128)
    assert tile_geometry(36, 4096, 384, H100_SMS) == (8, 128)
    assert tile_geometry(170, 4096, 384, H100_SMS) == (8, 128)
    assert tile_geometry(16, 1024, 512, H100_SMS) == (8, 128)
    assert tile_geometry(1, 256, 8192, H100_SMS) == (32, 32)
    assert tile_geometry(1, 32, 35008, H100_SMS) == (32, 32)
    # a narrow rung caps T at N / 8
    assert tile_geometry(2, 64, 16, H100_SMS) == (2, 32)


def test_geometry_gives_k4_the_bench_launch_of_k1():
    """K4's timed shape (one query, 65,536 targets of 512) has the cells of
    K1's bench launch and gets the same launch; one row of 37 codes gets
    T = 4 in one warp."""
    assert tile_geometry(1, 65536, 512, H100_SMS) == tile_geometry(64, 1024, 512, H100_SMS)
    assert tile_geometry(1, 65536, 512, H100_SMS) == (8, 128)
    assert tile_geometry(1, 1, 37, H100_SMS) == (4, 32)


def test_geometry_grows_with_the_card():
    """The same shape on a card with more SMs gets at least as many
    threads per target."""
    for G, B, N in SHAPES.values():
        small, _ = tile_geometry(G, B, N, 16)
        big, _ = tile_geometry(G, B, N, H100_SMS)
        assert small <= big


@pytest.mark.parametrize("T", GROUP_THREADS)
def test_forced_threads_per_target(T):
    got, block = tile_geometry(64, 1024, 512, H100_SMS, threads_per_target=T)
    assert got == T and block % T == 0
    # the design's rows per pass
    assert T * TILE_ROWS in (16, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("bad", [0, 3, 64, -4, 2.5, True, "4"])
def test_forced_threads_per_target_is_validated(bad):
    with pytest.raises(ValueError, match="threads_per_target"):
        tile_geometry(64, 1024, 512, H100_SMS, threads_per_target=bad)
    args = _grouped(1, (5,), 2, 32)
    m32 = _matrix()
    with pytest.raises(ValueError, match="threads_per_target"):
        sw_grouped.sw_scores_grouped(*args, m32, threads_per_target=bad)
    q, o, ql, db, st, tl = _resident(2, (5,), 2, 32)
    with pytest.raises(ValueError, match="threads_per_target"):
        sw_grouped.sw_scores_grouped_resident(q, o, ql, db, st, tl, m32, 32,
                                              threads_per_target=bad)
    q, t, tl = _single(6, 5, 2, 32)
    with pytest.raises(ValueError, match="threads_per_target"):
        sw_grouped.sw_scores_single(q, 5, t, tl, m32, threads_per_target=bad)


def _matrix():
    from sift4g_tpu_torch.core.scorers import create_scorer

    return scan.matrix32_from_scorer(create_scorer("BLOSUM_62", 10, 1), torch.device("cpu"))


def _edge_lens(rng, G, B, N):
    """Target lengths 0, 1, 15, 16, 17 and N first, then random ones."""
    lens = rng.integers(0, N + 1, size=(G, B)).astype(np.int32)
    fixed = np.array([0, 1, 15, 16, 17, N], dtype=np.int32)
    lens[:, : min(B, 6)] = fixed[: min(B, 6)]
    return lens


def _queries(rng, qlens):
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, scan.PAD_CODE, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    return q_all, offs, qlens


def _grouped(seed, qlens, B, N):
    rng = np.random.default_rng(seed)
    q_all, offs, qlens = _queries(rng, qlens)
    G = len(qlens)
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = _edge_lens(rng, G, B, N)
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return [torch.from_numpy(a) for a in (q_all, offs, qlens, targets, lens)]


def _resident(seed, qlens, B, N):
    from sift4g_tpu_torch.align.resident import ResidentDB

    rng = np.random.default_rng(seed)
    G = len(qlens)
    lens_seq = rng.integers(0, N + 1, G * B + 6).astype(np.int64)
    lens_seq[:6] = [0, 1, 15, 16, 17, N]
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, torch.device("cpu"))
    ids = np.sort(rng.choice(G * B + 6, G * B, replace=False)).reshape(G, B)
    q_all, offs, qlens = _queries(rng, qlens)
    host = (q_all, offs, qlens, rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a) for a in host]
    return q, o, ql, rdb.dev, st, tl


def _single(seed, qlen, B, N):
    """K4's inputs: one query and B int32 rows of width N, target lengths
    0, 1, 15, 16, 17 and N first, codes from the whole int32 range past
    every length."""
    rng = np.random.default_rng(seed)
    q = np.full(qlen + 3, scan.PAD_CODE, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    targets = rng.integers(-2**31, 2**31, (B, N), dtype=np.int64).astype(np.int32)
    lens = _edge_lens(rng, 1, B, N)[0]
    for b in range(B):
        targets[b, : lens[b]] = rng.integers(0, 26, lens[b])
    return [torch.from_numpy(a) for a in (q, targets, lens)]


# query lengths at the pass boundaries of T = 1 and T = 2 (16 and 32 rows
# a pass), an empty query and one row
EDGE_QLENS = (0, 1, 15, 16, 17, 33)


@pytest.mark.parametrize("T", GROUP_THREADS)
def test_single_on_cpu_accepts_every_threads_per_target(T):
    """K4's wrapper takes every forced T; on CPU tensors it runs the plain
    version, which ignores it, and launches nothing."""
    sw_grouped.reset_counters()
    m32 = _matrix()
    q, t, tl = _single(7, 33, 8, 37)
    for mode in MODES:
        got = sw_grouped.sw_scores_single(q, 33, t, tl, m32, mode=mode, threads_per_target=T)
        assert torch.equal(got, scan.align_scores(q, 33, t, tl, m32, mode=mode))
    assert sw_grouped.single_launches == 0 and sw_grouped.twin_calls_on_cuda == 0


def test_k4_runs_on_the_tiled_body():
    """The serial body is gone: sw_grouped.cuh holds the row policies and
    no kernel, and K4's C entry launches the tiled body."""
    import os

    from sift4g_tpu_torch.align import _build

    with open(os.path.join(_build.CSRC, "sw_grouped.cuh")) as fh:
        policies = fh.read()
    with open(os.path.join(_build.CSRC, "sw_single.cu")) as fh:
        single = fh.read()
    assert "__global__" not in policies
    assert all(f"struct {p}" in policies for p in ("SlabRows", "ResidentRows", "Int32Rows"))
    assert "launch_sw_tiled(" in single and '#include "sw_tiled.cuh"' in single


@pytest.mark.parametrize("T", [None, 1, 8, 32])
def test_cpu_tensors_go_to_the_plain_versions(T):
    sw_grouped.reset_counters()
    m32 = _matrix()
    args = _grouped(3, EDGE_QLENS, 8, 32)
    for mode in MODES:
        got = sw_grouped.sw_scores_grouped(*args, m32, mode=mode, threads_per_target=T)
        assert torch.equal(got, scan.align_scores_grouped(*args, m32, mode=mode))
    q, o, ql, db, st, tl = _resident(4, EDGE_QLENS, 8, 32)
    got = sw_grouped.sw_scores_grouped_resident(q, o, ql, db, st, tl, m32, 32,
                                                threads_per_target=T)
    assert torch.equal(got, scan.align_scores_grouped_resident(q, o, ql, db, st, tl, m32, 32))
    assert sw_grouped.kernel_launches == 0 and sw_grouped.resident_launches == 0
    assert sw_grouped.twin_calls_on_cuda == 0


@pytest.mark.parametrize("mode", MODES)
def test_plain_version_matches_pallas_at_pass_boundaries(mode):
    """The plain version (the kernel's reference on the card) against the
    Pallas kernel in interpret mode at the query and target lengths where
    the tiled kernel's passes and 16-column loads change, gaps 11/2."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped
    from sift4g_tpu.align.xla import _extend_matrix
    from sift4g_tpu.core.scorers import create_scorer

    q_all, offs, qlens, targets, lens = (a.numpy() for a in _grouped(5, EDGE_QLENS, 8, 128))
    m32 = _extend_matrix(create_scorer("BLOSUM_62", 11, 2).matrix)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sw_scores_pallas_grouped(
            q_all, offs, qlens, targets, lens, m32, mode=mode, gap_open=11, gap_extend=2,
            unroll=1))
    got = sw_grouped.sw_scores_grouped(
        *(torch.from_numpy(a) for a in (q_all, offs, qlens, targets, lens, m32)),
        mode=mode, gap_open=11, gap_extend=2)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("T", GROUP_THREADS)
def test_bench_tiled_pass_lengths_are_whole_passes(T):
    """``tools/bench_tiled.py profile`` times queries of 1..6 whole passes;
    at the geometry's T = 8 one pass starts at the profile's 512-row
    boundary and the others do not."""
    from sift4g_tpu_torch.tools.bench_tiled import pass_lengths

    lens = pass_lengths(T)
    assert lens == [k * T * TILE_ROWS for k in range(1, 7)]
    if T == 8:
        assert [m for m in lens[:-1] if m % 512 == 0] == [512]


@pytest.mark.parametrize("argv, rc", [([], 2), (["variants"], 2), (["threads", "x"], 2),
                                      (["threads"], 1), (["profile"], 1)])
def test_bench_tiled_usage_and_no_card(argv, rc, monkeypatch):
    from sift4g_tpu_torch.tools import bench_tiled

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_tiled.main(argv) == rc

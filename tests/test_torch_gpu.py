"""The CUDA kernels (K1 on slabs, with its int32, int16 and float32
accumulators, K2 on long targets, K3 on the resident database, K4 on
int32 rows, the probes K5 and K6) against their plain PyTorch versions,
and the sharded factories on two shards of the card, on the card.  K1, K3
and K4 run at every forced ``threads_per_target`` of the tiled body, at
the query lengths where its passes change and the target lengths where
its column loads change; K2 at every split of its strips over warps, at
the lengths where its strips, lanes and row tiles change.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run on a GPU host that has none:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Tolerance: exact int32 equality (the scores are integers)."""

import numpy as np
import pytest
import torch

from sift4g_tpu_torch.align import scan, sw_grouped
from sift4g_tpu_torch.align.sw_grouped import GROUP_THREADS, TILE_ROWS

MODES = ["SW", "NW", "HW", "OV"]
# an empty query, one row, every pass boundary (T * TILE_ROWS rows, one
# less and one more) of every T, and an 8,192-residue query
EDGE_QLENS = tuple(sorted({0, 1, 8192} | {T * TILE_ROWS + d for T in GROUP_THREADS
                                          for d in (-1, 0, 1)}))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _blosum62():
    from sift4g_tpu_torch.core.scorers import create_scorer

    return create_scorer("BLOSUM_62", 10, 1)


def _inputs(seed, G, B, N, qlens, dev):
    """Ragged lengths, a zero-length group, zero-length rows and int8
    garbage past every length, as device tensors."""
    rng = np.random.default_rng(seed)
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(0, N + 1, size=(G, B)).astype(np.int32)
    lens[0, 0], lens[0, -1] = N, 0
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets, lens)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape",
    [(5, 200, 256, (51, 17, 0, 64, 300)), (2, 40, 4096, (120, 33))],
    ids=["ragged", "long-rung"],
)
def test_kernel_matches_twin(cuda, mode, shape):
    G, B, N, qlens = shape
    args = _inputs(7, G, B, N, qlens, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    launches = sw_grouped.kernel_launches
    got = sw_grouped.sw_scores_grouped(*args, m32, mode=mode)
    ref = scan.align_scores_grouped(*args, m32, mode=mode)
    torch.cuda.synchronize()
    assert sw_grouped.kernel_launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (G, B)
    assert torch.equal(got, ref)
    smin = torch.full((G,), 20, dtype=torch.int32, device=cuda)
    assert torch.equal(
        scan.screen_topk_words(got, smin, 16), scan.screen_topk_words(ref, smin, 16)
    )


@pytest.mark.gpu
def test_kernel_refuses_unaligned_rows(cuda):
    args = _inputs(1, 1, 4, 24, (10,), cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    with pytest.raises(ValueError, match="16-byte"):
        sw_grouped.sw_scores_grouped(*args, m32)


def _resident_inputs(seed, G, B, N, qlens, dev):
    """A resident database of ragged sequences (16-byte slots, tail pad),
    rows drawn from it in ascending order, zero-length rows, and the last
    sequence (5 residues) among them: its window runs past the data."""
    from sift4g_tpu_torch.align.resident import ResidentDB

    rng = np.random.default_rng(seed)
    lens_seq = rng.integers(0, N + 1, G * B + 7).astype(np.int64)
    lens_seq[-2:] = (N, 5)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, dev)
    ids = np.sort(rng.choice(G * B + 6, G * B, replace=False)).reshape(G, B)
    ids[-1, -1] = G * B + 6
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    host = (q_all, offs, qlens, rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a).to(dev) for a in host]
    return rdb, (q, o, ql, rdb.dev, st, tl)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape",
    [(5, 200, 256, (51, 17, 0, 64, 300)), (2, 40, 4096, (120, 33))],
    ids=["ragged", "long-rung"],
)
def test_resident_kernel_matches_plain_and_slab_kernel(cuda, mode, shape):
    G, B, N, qlens = shape
    rdb, args = _resident_inputs(11, G, B, N, qlens, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    launches = sw_grouped.resident_launches
    got = sw_grouped.sw_scores_grouped_resident(*args, m32, N, mode=mode)
    ref = scan.align_scores_grouped_resident(*args, m32, N, mode=mode)
    torch.cuda.synchronize()
    assert sw_grouped.resident_launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (G, B)
    assert torch.equal(got, ref)
    # K1 fed the same windows as a slab
    st = args[4]
    slab = args[3][st[..., None] + torch.arange(N, device=cuda)].view(torch.int8).contiguous()
    k1 = sw_grouped.sw_scores_grouped(*args[:3], slab, args[5], m32, mode=mode)
    assert torch.equal(got, k1)


def _edge_inputs(seed, qlens, B, N, dev):
    """K3's inputs with target lengths 0, 1, 15, 16, 17 and N in every
    group beside random ones, and K1's slab of the same windows."""
    from sift4g_tpu_torch.align.resident import ResidentDB

    rng = np.random.default_rng(seed)
    G = len(qlens)
    lens_seq = rng.integers(0, N + 1, G * B + 1).astype(np.int64)
    ids = np.sort(rng.choice(G * B + 1, G * B, replace=False)).reshape(G, B)
    fixed = np.array([0, 1, 15, 16, 17, N])
    # give each group's first six rows the edge lengths
    lens_seq[ids[:, :6]] = fixed
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, dev)
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    host = (q_all, offs, qlens, rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a).to(dev) for a in host]
    slab = rdb.dev[st[..., None] + torch.arange(N, device=dev)].view(torch.int8).contiguous()
    return (q, o, ql, rdb.dev, st, tl), slab


@pytest.mark.gpu
@pytest.mark.parametrize("gaps", [(10, 1), (11, 2)], ids=["gaps10-1", "gaps11-2"])
@pytest.mark.parametrize("mode", MODES)
def test_tiled_kernels_at_every_T_and_pass_boundary(cuda, mode, gaps):
    """K1 and K3 at the geometry's own T and at every forced T, against
    the plain version, and K3 against K1 on the same windows."""
    go, ge = gaps
    N = 256
    (q, o, ql, db, st, tl), slab = _edge_inputs(17, EDGE_QLENS, 24, N, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    kw = dict(mode=mode, gap_open=go, gap_extend=ge)
    ref = scan.align_scores_grouped(q, o, ql, slab, tl, m32, **kw)
    for T in (None, *GROUP_THREADS):
        k1 = sw_grouped.sw_scores_grouped(q, o, ql, slab, tl, m32, threads_per_target=T, **kw)
        k3 = sw_grouped.sw_scores_grouped_resident(q, o, ql, db, st, tl, m32, N,
                                                   threads_per_target=T, **kw)
        torch.cuda.synchronize()
        assert torch.equal(k1, ref), f"K1 T={T}"
        assert torch.equal(k3, ref), f"K3 T={T}"


@pytest.mark.gpu
@pytest.mark.parametrize("acc", ["i16", "f32"])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_accumulators_match_plain_and_int(cuda, mode, acc):
    """K1 ``acc="i16"`` (the int16 pair kernel) and ``"f32"`` against their
    plain versions and K1 ``"int"``, at every T: an odd batch (a pair
    with no partner), ragged and zero lengths with garbage past them, and
    queries of several passes at every T (600 rows > 32 x 16)."""
    G, B, N, qlens = 4, 33, 256, (600, 0, 17, 513)
    args = _inputs(11, G, B, N, qlens, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    kw = dict(mode=mode, max_qlen=600, max_sub=11, acc=acc)
    ref = scan.align_scores_grouped(*args, m32, mode=mode)
    plain = scan.align_scores_grouped(*args, m32, **kw)
    assert torch.equal(plain, ref)
    counter = f"{acc}_launches"
    for T in (None, *GROUP_THREADS):
        launches = getattr(sw_grouped, counter), sw_grouped.kernel_launches
        got = sw_grouped.sw_scores_grouped(*args, m32, threads_per_target=T, **kw)
        torch.cuda.synchronize()
        assert (getattr(sw_grouped, counter), sw_grouped.kernel_launches) == (
            launches[0] + 1, launches[1])
        assert torch.equal(got, ref), f"{acc} T={T}"


@pytest.mark.gpu
def test_kernel_refuses_an_inadmissible_int16_bound(cuda):
    args = _inputs(11, 2, 8, 512, (100, 7), cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    launches = sw_grouped.i16_launches
    with pytest.raises(ValueError, match="int16"):
        sw_grouped.sw_scores_grouped(*args, m32, max_qlen=700, max_sub=11, acc="i16")
    assert sw_grouped.i16_launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case",
    [(1024, 512, 10, 1, 40, 3), (300, 200, 11, 2, 25, -7), (5, 16, 5, 2, 0, 1)],
    ids=["jax-shape", "ragged", "no-rows"],
)
def test_dp_row_probe_matches_plain(cuda, case):
    from sift4g_tpu_torch.align import roofline

    B, N, go, ge, M, salt = case
    launches = roofline.dp_row_launches
    got = roofline.dp_row_probe(M, salt, B=B, N=N, go=go, ge=ge, device=cuda)
    ref = roofline.dp_row_probe_plain(M, salt, B=B, N=N, go=go, ge=ge, device=cuda)
    torch.cuda.synchronize()
    assert roofline.dp_row_launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 15, 16, 17, 511, 512, 513, 1100, 6144])
def test_dp_row_probe_strip_and_wavefront_edges(cuda, N):
    """K5 at chip_smoke.py phase 6's edges: widths around a lane's 16
    columns and a strip's 512, rows around the wavefront's 32 lanes (and
    the 512-row tiles past one strip), gaps with go < ge, salts at the
    argument limit, B = 1 and 33; exact."""
    from sift4g_tpu_torch.align import roofline

    cases = [(B, M, go, ge, salt) for M in (0, 1, 2, 31, 32, 33)
             for go, ge in ((10, 1), (11, 2), (1, 3))
             for B, salt in ((1, 1 << 20), (33, -(1 << 20)), (33, 5))]
    if N > 512:
        cases += [(5, M, go, ge, 3) for M in (511, 512, 513, 1025) for go, ge in ((10, 1), (1, 3))]
    for B, M, go, ge, salt in cases:
        got = roofline.dp_row_probe(M, salt, B=B, N=N, go=go, ge=ge, device=cuda)
        ref = roofline.dp_row_probe_plain(M, salt, B=B, N=N, go=go, ge=ge, device=cuda)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (B,)
        assert torch.equal(got, ref), (B, N, M, go, ge, salt)


@pytest.mark.gpu
def test_dp_row_probe_entry_refuses_a_strip_count_off_its_width(cuda):
    """The C entry takes the strips of roofline.dp_row_geometry and refuses
    a count whose strips do not just cover N (cudaErrorInvalidValue)."""
    from sift4g_tpu_torch.align import _build, roofline

    lib = _build.load()
    B, N = 4, 1100
    T, _, block, strips = roofline.dp_row_geometry(B, N, 132)
    assert strips == 3
    scratch = torch.empty(lib.sift4g_dp_row_scratch_bytes(B, 4), dtype=torch.uint8, device=cuda)
    out = torch.empty(B, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for bad in (0, 2, 4):
        assert lib.sift4g_dp_row_probe(B, N, 8, 3, 10, 1, T, bad, block, scratch.data_ptr(),
                                       out.data_ptr(), stream) == 1
    assert lib.sift4g_dp_row_scratch_bytes(B, 1) == 0
    assert lib.sift4g_dp_row_scratch_bytes(B, strips) == B * strips * 16 * 32 * 8


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "s16x2"])
@pytest.mark.parametrize("pairs", [1, 2, 4])
def test_int32_probe_matches_plain(cuda, pairs, packed):
    from sift4g_tpu_torch.align import roofline

    launches = roofline.int32_launches
    # the int16 form also past 32,767, where its values wrap
    cases = [(1024, 512, 300, 3), (70, 37, 41, -5), (3, 1100, 9, 2)]
    for B, N, M, salt in cases + ([(3, 70, 32_760, 2)] if packed else []):
        got = roofline.int32_probe(M, salt, B=B, N=N, pairs=pairs, packed=packed, device=cuda)
        ref = roofline.int32_probe_plain(M, salt, B=B, N=N, pairs=pairs, packed=packed,
                                         device=cuda)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (B,)
        assert torch.equal(got, ref)
    assert roofline.int32_launches == launches + 3 + packed


@pytest.mark.gpu
def test_resident_kernel_refuses_bad_window(cuda):
    rdb, args = _resident_inputs(1, 1, 8, 64, (10,), cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        sw_grouped.sw_scores_grouped_resident(*args, m32, 24)
    with pytest.raises(TypeError, match="int64"):
        sw_grouped.sw_scores_grouped_resident(*args[:4], args[4].int(), args[5], m32, 64)


def _single_inputs(seed, B, N, m_pad, qlen, dev):
    """One query and B int32 rows of any width: ragged lengths, empty rows
    (the first row N long), and codes from the whole int32 range past every
    length, so that a read past a length changes a score."""
    rng = np.random.default_rng(seed)
    targets = rng.integers(-2**31, 2**31, (B, N), dtype=np.int64).astype(np.int32)
    lens = rng.integers(0, N + 1, B).astype(np.int32)
    lens[-1], lens[0] = 0, N
    for b in range(B):
        targets[b, : lens[b]] = rng.integers(0, 26, lens[b])
    q = np.full(m_pad, 31, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    return [torch.from_numpy(a).to(dev) for a in (q, targets, lens)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape",
    [(300, 512, 384, 361), (257, 200, 64, 50), (1, 37, 32, 9), (40, 64, 8192, 8192)],
    ids=["ragged", "n200", "b1-n37", "8192-aa"],
)
def test_single_kernel_matches_plain(cuda, mode, shape):
    """K4 at the geometry's own T and at every forced T; also with the
    query length as a tensor on the card and a row base that is not
    16-byte aligned (the kernel's scalar loads)."""
    B, N, m_pad, qlen = shape
    q, t, tl = _single_inputs(5, B, N, m_pad, qlen, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    kw = dict(mode=mode, gap_open=11, gap_extend=2)
    ref = scan.align_scores(q, qlen, t, tl, m32, **kw)
    ql = torch.tensor([qlen], dtype=torch.int32, device=cuda)
    t_off = torch.empty(B * N + 1, dtype=torch.int32, device=cuda)[1:].view(B, N)
    t_off.copy_(t)
    launches = sw_grouped.single_launches
    for T in (None, *GROUP_THREADS):
        got = sw_grouped.sw_scores_single(q, qlen, t, tl, m32, threads_per_target=T, **kw)
        got2 = sw_grouped.sw_scores_single(q, ql, t_off, tl, m32, threads_per_target=T, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (B,)
        assert torch.equal(got, ref) and torch.equal(got2, ref), f"T={T}"
    assert sw_grouped.single_launches == launches + 2 * (1 + len(GROUP_THREADS))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_single_kernel_at_the_edge_lengths(cuda, mode):
    """K4 at every pass boundary of every T (query lengths T x 16 - 1,
    T x 16, T x 16 + 1), an empty query, one row and 8,192 rows, and at
    target lengths 0, 1, 15, 16, 17 and N, gaps 11/2, at the geometry's
    own T and at every forced T."""
    N = 200
    q, t, tl = _single_inputs(21, 64, N, 8192, 8192, cuda)
    tl[:6] = torch.tensor([0, 1, 15, 16, 17, N], dtype=torch.int32, device=cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    kw = dict(mode=mode, gap_open=11, gap_extend=2)
    for qlen in EDGE_QLENS:
        ref = scan.align_scores(q, qlen, t, tl, m32, **kw)
        for T in (None, *GROUP_THREADS):
            got = sw_grouped.sw_scores_single(q, qlen, t, tl, m32, threads_per_target=T, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), f"qlen={qlen} T={T}"


@pytest.mark.gpu
@pytest.mark.parametrize("screen_k", [0, 16], ids=["scores", "screened"])
def test_sharded_factories_on_two_shards_of_the_card(cuda, screen_k):
    """make_grouped_sharded and make_sharded_scores on [cuda, cuda]: each
    shard launches its kernel, and the shards equal the unsharded kernel."""
    from sift4g_tpu_torch.parallel import sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = [dev, dev]
    m32 = scan.matrix32_from_scorer(_blosum62(), dev)
    args = _inputs(3, 6, 256, 512, (51, 17, 0, 64, 300, 90), dev)
    smin = torch.full((6,), 20, dtype=torch.int32, device=dev)
    want = sw_grouped.sw_scores_grouped(*args, m32)
    if screen_k:
        want = scan.screen_topk_words(want, smin, screen_k)
    sw_grouped.reset_counters()
    extra = (smin,) if screen_k else ()
    got = sharded.make_grouped_sharded(mesh, screen_k=screen_k)(*args, m32, *extra)
    assert sw_grouped.kernel_launches == 2 and sw_grouped.twin_calls_on_cuda == 0
    assert torch.equal(torch.cat(got), want)

    q, t, tl = _single_inputs(9, 512, 200, 384, 300, dev)
    want = sw_grouped.sw_scores_single(q, 300, t, tl, m32)
    sw_grouped.reset_counters()
    got = sharded.make_sharded_scores(mesh)(q, torch.tensor(300, dtype=torch.int32), t, tl, m32)
    assert sw_grouped.single_launches == 2 and sw_grouped.twin_calls_on_cuda == 0
    assert torch.equal(torch.cat(got), want)


# K2's edges: target lengths on lane (16), strip (512) and N edges, 0 and
# 1; query lengths around the 32-lane wavefront and the 512-row tiles of
# strips in turn; N a whole number of strips and one that cuts the last
LONG_EDGE_QLENS = (0, 1, 31, 32, 33, 511, 512, 513, 1025)
LONG_EDGE_TLENS = (0, 1, 15, 16, 17, 511, 512, 513, 1023, 1024, 1025)


def _long_edge_inputs(seed, N, dev, qlens=LONG_EDGE_QLENS, B=16):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, N + 1, (len(qlens), B))
    lens[:, : len(LONG_EDGE_TLENS)] = LONG_EDGE_TLENS
    lens[:, -2:] = (N - 1, N)
    return _inputs_with_lens(rng, qlens, lens, N, dev)


def _inputs_with_lens(rng, qlens, lens, N, dev):
    G, B = lens.shape
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets,
                                                  lens.astype(np.int32))]


def long_splits(N):
    """(cluster, warps a block) of K2 at every split of N's strips: the
    geometry's own, one block of 1 to min(strips, 16) warps and of 16 (idle
    warps), clusters of 2 to 8 one-warp blocks (every ring between blocks;
    strips in turn below the strips), 2 blocks of 2 and 4 of 4 warps, and 8
    blocks of 16 (idle blocks)."""
    strips = -(-N // sw_grouped.LONG_STRIP)
    top = min(strips, sw_grouped.MAX_LONG_WARPS)
    return ((None, None), *((1, w) for w in range(1, top + 1)),
            *(((1, sw_grouped.MAX_LONG_WARPS),) if top < sw_grouped.MAX_LONG_WARPS else ()),
            *((c, 1) for c in range(2, sw_grouped.MAX_LONG_CLUSTER + 1)),
            (2, 2), (4, 4), (sw_grouped.MAX_LONG_CLUSTER, sw_grouped.MAX_LONG_WARPS))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [2560, 2336])
@pytest.mark.parametrize("mode", MODES)
def test_long_kernel_at_every_warp_split_and_edge(cuda, mode, N):
    """K2 == plain at every split of N's strips over a cluster's blocks and
    warps (one warp a strip, fewer warps taking strips in turn, idle warps
    and blocks), gaps with go < ge among them."""
    args = _long_edge_inputs(N, N, cuda)
    for go, ge in ((10, 1), (11, 2), (1, 3)):
        m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
        ref = scan.align_scores_grouped(*args, m32, mode=mode, gap_open=go, gap_extend=ge)
        for cl, warps in long_splits(N):
            sw_grouped.reset_counters()
            got = sw_grouped.sw_scores_grouped_long(
                *args, m32, mode=mode, gap_open=go, gap_extend=ge, n_chunk=16, m_cap=1025,
                cluster=cl, warps_per_block=warps)
            torch.cuda.synchronize()
            assert sw_grouped.long_launches == 1
            assert torch.equal(got, ref), f"gaps {go}/{ge} cluster={cl} warps={warps}"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_long_kernel_with_an_8192_row_query(cuda, mode):
    """Sixteen row tiles when a warp takes both strips in turn."""
    rng = np.random.default_rng(5)
    lens = rng.integers(900, 1025, (1, 8))
    args = _inputs_with_lens(rng, (8192,), lens, 1024, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    ref = scan.align_scores_grouped(*args, m32, mode=mode)
    for cl, warps in ((None, None), (1, 1), (2, 1)):
        got = sw_grouped.sw_scores_grouped_long(*args, m32, mode=mode, m_cap=8192,
                                                cluster=cl, warps_per_block=warps)
        assert torch.equal(got, ref), f"cluster={cl} warps={warps}"


@pytest.mark.gpu
def test_long_factory_on_two_shards_of_the_card(cuda):
    """make_grouped_long_sharded on [cuda, cuda]: K2 on each shard, equal
    to the unsharded kernel."""
    from sift4g_tpu_torch.parallel import sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(8)
    args = _inputs_with_lens(rng, (360,), rng.integers(3000, 8193, (1, 64)), 8192, dev)
    m32 = scan.matrix32_from_scorer(_blosum62(), dev)
    want = sw_grouped.sw_scores_grouped_long(*args, m32)
    sw_grouped.reset_counters()
    got = sharded.make_grouped_long_sharded([dev, dev])(*args, m32)
    assert sw_grouped.long_launches == 2 and sw_grouped.kernel_launches == 0
    assert sw_grouped.twin_calls_on_cuda == 0
    assert torch.equal(torch.cat(got, dim=1), want)


@pytest.mark.gpu
def test_long_kernel_refuses_what_it_does_not_take(cuda):
    args = _long_edge_inputs(1, 2560, cuda, qlens=(40,))
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    with pytest.raises(ValueError):
        sw_grouped.sw_scores_grouped_long(*args, m32, n_chunk=96)
    with pytest.raises(ValueError):   # rows of 2,552 bytes: not 16-byte multiples
        sw_grouped.sw_scores_grouped_long(*args[:3], args[3][..., :2552].contiguous(),
                                          args[4], m32, n_chunk=8)
    with pytest.raises(ValueError):
        sw_grouped.sw_scores_grouped_long(*args, m32, warps_per_block=0)
    with pytest.raises(ValueError):
        sw_grouped.sw_scores_grouped_long(*args, m32, cluster=9)


@pytest.mark.gpu
def test_long_kernel_leaves_lengths_on_the_card_unchecked(cuda):
    """A query past ``m_cap`` on the card: no host sync and no device
    assertion, and the scores are still right (the kernel needs no bound)."""
    args = _long_edge_inputs(1, 2560, cuda, qlens=(40,))
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    got = sw_grouped.sw_scores_grouped_long(*args, m32, m_cap=8)
    assert torch.equal(got, scan.align_scores_grouped(*args, m32))


def _predict_chunk(seed, nq):
    """A chunk of the device-predict mix (``tools/bench_predict.py``),
    padded to one bucket: (packed int8 rows, n_valid, prepared rows)."""
    from sift4g_tpu_torch.tools.bench_predict import make_inputs

    _, prepared = make_inputs(nq, seed=seed)
    L_pad = max(-(-r.shape[1] // 128) * 128 for r in prepared)
    n_pad = max(-(-r.shape[0] // 64) * 64 for r in prepared)
    packed = np.full((nq, n_pad, L_pad), ord("X") - ord("A"), dtype=np.int8)
    for j, r in enumerate(prepared):
        packed[j, : r.shape[0], : r.shape[1]] = r
    n_valid = torch.tensor([r.shape[0] for r in prepared], dtype=torch.int32)
    return torch.from_numpy(packed), n_valid, prepared


@pytest.mark.gpu
def test_device_predict_scores_on_the_card(cuda):
    """scores_torch on the card: within the reference's tolerance (rtol
    2e-3, atol 2e-4) of its CPU run and the float64 oracle, bit-identical
    between two runs, and the same bits with TF32 switched on around the
    call (no product of the math goes through cuBLAS)."""
    from sift4g_tpu_torch.sift import scores as S
    from sift4g_tpu_torch.sift import scores_torch as ST

    rows, n_valid, prepared = _predict_chunk(5, 16)
    got = ST.sift_scores_from_rows_batch(rows.to(cuda), n_valid.to(cuda))
    again = ST.sift_scores_from_rows_batch(rows.to(cuda), n_valid.to(cuda))
    assert torch.equal(got, again)
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = ST.sift_scores_from_rows_batch(rows.to(cuda), n_valid.to(cuda))
    finally:
        torch.set_float32_matmul_precision("highest")
    assert torch.equal(got, tf32)
    cpu = ST.sift_scores_from_rows_batch(rows[:4], n_valid[:4])
    np.testing.assert_allclose(got[:4].cpu().numpy(), cpu.numpy(), rtol=2e-3, atol=2e-4)
    for j in (0, 7, 15):
        r = prepared[j]
        want = S.calc_sift_scores(r, S.create_matrix(r, np.ones(r.shape[0]))[0])[0]
        np.testing.assert_allclose(got[j, : r.shape[1]].cpu().numpy(), want,
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.gpu
def test_device_predict_files_on_the_card(cuda, tmp_path):
    """predict_matrix_batch on the card writes the CPU run's files within a
    printed digit, the same bytes twice, and at every depth."""
    import filecmp
    import os

    from sift4g_tpu_torch.sift import predict_batch as PB
    from sift4g_tpu_torch.tools.bench_predict import make_inputs

    queries, prepared = make_inputs(40, seed=3)
    outs = {}
    for tag, kw in {"cpu": dict(device="cpu", q_chunk=8), "card": dict(device=cuda),
                    "card2": dict(device=cuda), "depth1": dict(device=cuda, depth=1),
                    "chunk8": dict(device=cuda, q_chunk=8)}.items():
        out = tmp_path / tag
        out.mkdir()
        PB.predict_matrix_batch(queries, prepared, str(out), **kw)
        outs[tag] = out
    names = sorted(os.listdir(outs["cpu"]))
    assert len(names) == 40
    for name in names:
        for tag in ("card2", "depth1"):
            assert filecmp.cmp(outs["card"] / name, outs[tag] / name, shallow=False), tag

        def values(path):
            return np.array([[float(x) for x in line.split()] for line in open(path)
                             if line[:2] not in ("ID", "AC", "DE", "MA", "//")
                             and not line.split()[0].isalpha()])

        want = values(outs["cpu"] / name)
        for tag in ("card", "chunk8"):
            np.testing.assert_allclose(values(outs[tag] / name), want, atol=1.5e-4)

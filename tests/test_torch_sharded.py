"""The port's scoring across several devices against the JAX package's:
K4's plain version against the Pallas ``_sw_kernel``, every factory of
``parallel/sharded.py``, the mesh's card selection, the aligner over
several devices and the pipeline on two.  The port's "devices" here are
the CPU named several times, where the JAX package uses the 8 virtual CPU
devices of ``tests/conftest.py``.  Tolerance: exact integer equality and
byte-identical files."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sift4g_tpu.align.batch import BatchAligner as JaxAligner  # noqa: E402
from sift4g_tpu.align.xla import _extend_matrix  # noqa: E402
from sift4g_tpu.core.scorers import create_scorer as jax_create_scorer  # noqa: E402
from sift4g_tpu.parallel import sharded as jsharded  # noqa: E402
from sift4g_tpu_torch import align as talign  # noqa: E402
from sift4g_tpu_torch.align import scan, sw_grouped  # noqa: E402
from sift4g_tpu_torch.align.batch import BatchAligner  # noqa: E402
from sift4g_tpu_torch.align.resident import ResidentDB  # noqa: E402
from sift4g_tpu_torch.core.scorers import create_scorer  # noqa: E402
from sift4g_tpu_torch.parallel import sharded  # noqa: E402

# the suite runs several worker processes at once: torch's OpenMP threads
# on top of them oversubscribe the cores and slow every test many times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["SW", "NW", "HW", "OV"]
CPU = torch.device("cpu")
SCORER = create_scorer("BLOSUM_62", 10, 1)
JAX_SCORER = jax_create_scorer("BLOSUM_62", 10, 1)
M32 = _extend_matrix(JAX_SCORER.matrix)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _single_inputs(rng, b, n, m_pad, qlen, min_len=0, fixed=None):
    """One query and b int32 target rows: ragged lengths (zero-length rows
    unless ``min_len``; the first rows ``fixed`` long when given), random
    codes 0..31 past every length."""
    targets = rng.integers(0, 32, (b, n)).astype(np.int32)
    lens = rng.integers(min_len, n + 1, b).astype(np.int32)
    if fixed is not None:
        lens[: len(fixed)] = fixed
    elif not min_len:
        lens[:2] = (0, n)
    for i in range(b):
        targets[i, : lens[i]] = rng.integers(0, 26, lens[i])
    q = np.full(m_pad, scan.PAD_CODE, np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    return q, targets, lens


# ---- K4's plain version against the Pallas kernel ---------------------------


# (b, n, m_pad, query lengths, gaps, the first rows' lengths): the last
# three sit at the edges of K4's tiled body: a pass boundary at T = 8
# (128 rows), one row of 37 codes (the int32 loader's scalar tail, and no
# row after it), and target lengths around the 4- and 16-column loads
SINGLE_SHAPES = {
    "b32-n128": (32, 128, 64, (57,), (10, 1), None),
    "n200-gaps11-2": (8, 200, 32, (29,), (11, 2), None),
    "qlen-127-128-129": (12, 96, 160, (127, 128, 129), (11, 2), None),
    "b1-n37": (1, 37, 32, (30,), (11, 2), (37,)),
    "target-lens-0-1-15-16-17-n": (8, 48, 32, (21,), (11, 2), (0, 1, 15, 16, 17, 48)),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SINGLE_SHAPES.values(), ids=SINGLE_SHAPES.keys())
def test_single_plain_matches_pallas_interpret(mode, shape):
    """As tests/test_pallas_sw.py runs ``sw_scores_pallas``, with empty
    rows and garbage codes past every length; the wrapper on CPU tensors
    is the plain version and launches nothing."""
    from sift4g_tpu.align.pallas_sw import sw_scores_pallas

    b, n, m_pad, qlens, (go, ge), fixed = shape
    rng = np.random.default_rng(11)
    q, targets, lens = _single_inputs(rng, b, n, m_pad, max(qlens), fixed=fixed)
    kw = dict(mode=mode, gap_open=go, gap_extend=ge)
    sw_grouped.reset_counters()
    qt, tt, lt, mt = _t(q, targets, lens, M32)
    for qlen in qlens:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(sw_scores_pallas(q, np.int32(qlen), targets, lens, M32, **kw))
        got = sw_grouped.sw_scores_single(qt, qlen, tt, lt, mt, **kw)
        assert got.dtype == torch.int32 and got.shape == (b,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"qlen={qlen}")
        # a tensor query length, as the sharded factories pass it
        got_t = sw_grouped.sw_scores_single(qt, torch.tensor([qlen], dtype=torch.int32), tt, lt,
                                            mt, **kw)
        np.testing.assert_array_equal(got_t.numpy(), want, err_msg=f"qlen={qlen}")
    assert sw_grouped.single_launches == 0 and sw_grouped.twin_calls_on_cuda == 0


def test_single_wrapper_refuses_other_devices_and_modes():
    meta = torch.zeros(4, 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sw_grouped.sw_scores_single(meta[0], 3, meta, meta[:, 0], meta, mode="SW")
    with pytest.raises(ValueError, match="unknown alignment mode"):
        sw_grouped.sw_scores_single(meta[0], 3, meta, meta[:, 0], meta, mode="XX")


# ---- the factories ----------------------------------------------------------


@pytest.fixture
def eight(monkeypatch):
    """The port's local devices: the CPU eight times, as the JAX tests see
    eight virtual CPU devices."""
    monkeypatch.setattr(sharded, "local_devices", lambda: [CPU] * 8)
    return [CPU] * 8


def test_sharded_scores_match_jax_pallas(eight):
    """``make_sharded_scores`` over 8 devices against the JAX factory on
    ``make_mesh(8)`` with its Pallas kernel (interpret mode), as
    tests/test_parallel_pallas.py runs it."""
    q, targets, lens = _single_inputs(np.random.default_rng(3), 32, 128, 64, 41, min_len=1)
    mesh = jsharded.make_mesh(8)
    t_dev, l_dev = jsharded.shard_batch(mesh, targets, lens)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsharded.make_sharded_scores(mesh, kernel="pallas")(
            q, np.int32(41), t_dev, l_dev, M32))
    mesh_t = sharded.make_mesh(8)
    assert mesh_t == eight
    fn = sharded.make_sharded_scores(mesh_t)
    got = fn(q, np.int32(41), targets, lens, M32)
    assert len(got) == 8 and all(s.shape == (4,) for s in got)
    np.testing.assert_array_equal(sharded.to_host(got).numpy(), want)
    # pre-sharded inputs, and the plain versions called by name, agree
    t_sh, l_sh = sharded.shard_batch(mesh_t, targets, lens)
    plain = sharded.make_sharded_scores(mesh_t, kernel="torch")(q, np.int32(41), t_sh, l_sh, M32)
    np.testing.assert_array_equal(sharded.to_host(plain).numpy(), want)


def test_factories_refuse_bad_layouts():
    with pytest.raises(ValueError, match="does not divide"):
        sharded.make_sharded_scores([CPU] * 3)(
            np.zeros(8, np.int32), 4, np.zeros((32, 16), np.int32), np.zeros(32, np.int32), M32)
    with pytest.raises(ValueError, match="2 shards for a mesh of 3"):
        sharded.make_sharded_scores([CPU] * 3)(
            np.zeros(8, np.int32), 4, [torch.zeros(1, 16, dtype=torch.int32)] * 2,
            np.zeros(3, np.int32), M32)
    with pytest.raises(ValueError, match="kernel must be one of"):
        sharded.make_grouped_sharded([CPU], kernel="pallas")
    with pytest.raises(TypeError, match="smin"):
        sharded.make_grouped_sharded([CPU], screen_k=4)(
            *_t(np.zeros(8, np.int32), np.zeros(1, np.int32), np.ones(1, np.int32),
                np.zeros((1, 2, 16), np.int8), np.ones((1, 2), np.int32), M32))


@pytest.mark.parametrize("mode", MODES)
def test_sharded_topk_matches_jax(mode, eight):
    """As tests/test_parallel.py: scores, the global top-k and, with the
    stable per-shard order, the very indices of the JAX merge."""
    rng = np.random.default_rng(7)
    b, n, m, k = 64, 64, 32, 6
    q, targets, lens = _single_inputs(rng, b, n, m, m - 3, min_len=5)
    mesh = jsharded.make_mesh(8)
    t_dev, l_dev = jsharded.shard_batch(mesh, targets, lens)
    want = [np.asarray(a) for a in jsharded.make_sharded_topk_align(mesh, k=k, mode=mode)(
        q, np.int32(m - 3), t_dev, l_dev, M32)]
    scores, top_s, top_i = sharded.make_sharded_topk_align(eight, k=k, mode=mode)(
        q, np.int32(m - 3), targets, lens, M32)
    np.testing.assert_array_equal(sharded.to_host(scores).numpy(), want[0])
    np.testing.assert_array_equal(top_s.numpy(), want[1])
    np.testing.assert_array_equal(top_i.numpy(), want[2])
    assert top_i.dtype == torch.int32
    order = np.argsort(-want[0], kind="stable")[:k]
    np.testing.assert_array_equal(top_i.numpy(), order)


def _grouped_inputs(rng, G, B, N, mq=64):
    tg = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    tl = rng.integers(0, N + 1, (G, B)).astype(np.int32)
    tl[0, :2] = (0, N)
    for g in range(G):
        for b in range(B):
            tg[g, b, : tl[g, b]] = rng.integers(0, 26, tl[g, b])
    q = np.full(G * mq, scan.PAD_CODE, np.int32)
    go = (np.arange(G) * mq).astype(np.int32)
    gl = rng.integers(5, mq - 2, G).astype(np.int32)
    for g in range(G):
        q[g * mq : g * mq + gl[g]] = rng.integers(0, 26, gl[g])
    return q, go, gl, tg, tl


@pytest.mark.parametrize("screen_k", [0, 5], ids=["scores", "screened"])
@pytest.mark.parametrize("mode", ["SW", "OV"])
def test_grouped_sharded_matches_jax_xla(mode, screen_k, eight):
    """``make_grouped_sharded`` (K1's factory) against the JAX factory with
    its exact XLA twin; non-empty rows where the XLA scan and the Pallas
    kernel agree, every row under SW/OV."""
    q, go, gl, tg, tl = _grouped_inputs(np.random.default_rng(2), 8, 16, 128)
    smin = np.full(8, 20, np.int32)
    extra = (smin,) if screen_k else ()
    jfn = jsharded.make_grouped_sharded(jsharded.make_mesh(8), mode=mode, kernel="xla",
                                        screen_k=screen_k)
    want = np.asarray(jfn(q, go, gl, tg, tl, M32, *extra))
    got = sharded.make_grouped_sharded(eight, mode=mode, screen_k=screen_k)(
        q, go, gl, tg, tl, M32, *extra)
    assert len(got) == 8
    np.testing.assert_array_equal(sharded.to_host(got).numpy(), want)


def test_grouped_long_sharded_matches_jax_pallas(eight):
    """``make_grouped_long_sharded`` (K2 on every shard) against the JAX
    factory's column-chunked Pallas kernel in interpret mode, as
    tests/test_parallel_pallas.py runs it: one group, rows sharded."""
    rng = np.random.default_rng(1)
    G, B, N, qlen = 1, 16, 256, 40
    tg = np.full((G, B, N), scan.PAD_CODE, dtype=np.int8)
    tl = np.zeros((G, B), dtype=np.int32)
    for b in range(B):
        ln = int(rng.integers(130, N))
        tg[0, b, :ln] = rng.integers(0, 26, ln)
        tl[0, b] = ln
    q = np.full(64, scan.PAD_CODE, dtype=np.int32)
    q[:qlen] = rng.integers(0, 26, qlen)
    go, gl = np.zeros(G, np.int32), np.full(G, qlen, np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsharded.make_grouped_long_sharded(
            jsharded.make_mesh(8), n_chunk=128, m_cap=64)(q, go, gl, tg, tl, M32))
    got = sharded.make_grouped_long_sharded(eight, n_chunk=128, m_cap=64)(q, go, gl, tg, tl, M32)
    assert all(s.shape == (1, 2) for s in got)
    np.testing.assert_array_equal(sharded.to_host(got, dim=1).numpy(), want)


@pytest.mark.parametrize("screen_k", [0, 4], ids=["scores", "screened"])
def test_grouped_resident_sharded_matches_jax_xla(screen_k, eight):
    """``make_grouped_resident_sharded`` (K3's factory) with the database
    replicated, against the JAX factory's XLA twin on 1024-aligned starts
    (the twin rounds starts down to that grain)."""
    rng = np.random.default_rng(23)
    G, B, N, R = 8, 10, 256, 9000
    db = np.concatenate([rng.integers(0, 26, R).astype(np.uint8),
                         np.zeros((-R % 1024) + 4096, np.uint8)])
    starts = (rng.integers(0, R // 1024 + 1, (G, B)) * 1024).astype(np.int32)
    lens = rng.integers(1, N + 1, (G, B)).astype(np.int32)
    q, go, gl, _, _ = _grouped_inputs(rng, G, 2, 16, mq=80)
    smin = np.full(G, 15, np.int32)
    extra = (smin,) if screen_k else ()
    jmesh = jsharded.make_mesh(8)
    want = np.asarray(jsharded.make_grouped_resident_sharded(
        jmesh, n_pad=N, kernel="xla", screen_k=screen_k)(
        q, go, gl, jsharded.replicate_to_mesh(jmesh, db), starts, lens, M32, *extra))
    dbs = sharded.replicate_to_mesh(eight, db)
    assert len(dbs) == 8 and all(d is dbs[0] for d in dbs)   # one copy per distinct device
    got = sharded.make_grouped_resident_sharded(eight, n_pad=N, screen_k=screen_k)(
        q, go, gl, dbs, starts, lens, M32, *extra)
    np.testing.assert_array_equal(sharded.to_host(got).numpy(), want)


@pytest.mark.parametrize("mode", ["SW", "NW"])
def test_sharded_pipeline_step_matches_jax(mode, eight):
    """``make_sharded_pipeline_step`` on the (2, 2) grid of
    ``make_2d_mesh(4)``: two query blocks, the database in two shards."""
    rng = np.random.default_rng(5)
    Q, b, n, m, k = 4, 32, 64, 40, 5
    queries = np.full((Q, m), scan.PAD_CODE, np.int32)
    qlens = rng.integers(10, m, Q).astype(np.int32)
    for i in range(Q):
        queries[i, : qlens[i]] = rng.integers(0, 26, qlens[i])
    _, targets, lens = _single_inputs(rng, b, n, m, 1, min_len=3)
    jmesh = jsharded.make_2d_mesh(4)
    want = [np.asarray(a) for a in jsharded.make_sharded_pipeline_step(jmesh, k=k, mode=mode)(
        queries, qlens, targets, lens, M32)]
    mesh = sharded.make_2d_mesh(4)
    assert mesh == [[CPU, CPU], [CPU, CPU]]
    top_s, top_i = sharded.make_sharded_pipeline_step(mesh, k=k, mode=mode)(
        queries, qlens, targets, lens, M32)
    assert len(top_s) == 2 and top_s[0].shape == (2, k)
    np.testing.assert_array_equal(sharded.to_host(top_s).numpy(), want[0])
    np.testing.assert_array_equal(sharded.to_host(top_i).numpy(), want[1])


# ---- the mesh and --cards ----------------------------------------------------


@pytest.fixture
def four_cards(monkeypatch):
    """A host that reports four CUDA cards (no kernel is launched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_make_mesh_cards_selects_devices(four_cards):
    """As tests/test_cards.py: the card list picks those local devices, in
    order; a repeated card is kept (the factories take it)."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert sharded.make_mesh() == cuda
    assert sharded.make_mesh(cards=(0, 2)) == [cuda[0], cuda[2]]
    assert sharded.make_mesh(cards=(3, 1)) == [cuda[3], cuda[1]]
    assert sharded.make_mesh(cards=(0, 0)) == [cuda[0], cuda[0]]
    for nd in (1, 2, 4):
        assert len(sharded.make_mesh(nd)) == nd
    assert sharded.make_2d_mesh() == [cuda[:2], cuda[2:]]
    assert sharded.make_2d_mesh(3) == [cuda[:3]]
    assert talign.resolve_backend("cuda") == ("cuda", cuda)
    assert talign.resolve_backend("auto", (1, 3)) == ("cuda", [cuda[1], cuda[3]])


def test_make_mesh_cards_out_of_range(four_cards):
    with pytest.raises(ValueError, match="out of range: 4 local device"):
        sharded.make_mesh(cards=(0, 99))
    with pytest.raises(ValueError, match="out of range"):
        talign.resolve_backend("cuda", (4,))


def test_batch_aligner_honors_cards(four_cards):
    al = BatchAligner(SCORER, backend="cuda", cards=(1, 3))
    assert al.devices == [torch.device("cuda", 1), torch.device("cuda", 3)]
    assert BatchAligner(SCORER, backend="cuda").devices == sharded.make_mesh()
    with pytest.raises(ValueError, match="out of range"):
        BatchAligner(SCORER, backend="cuda", cards=(42,))
    with pytest.raises(ValueError, match="on the CPU"):
        BatchAligner(SCORER, backend="torch", devices=[CPU, torch.device("cuda", 0)])


# ---- the aligner over several devices ---------------------------------------


def _mixed_items(rng, n_queries=5, max_tlen=700):
    """tests/test_parallel_pallas.py's realistic mixed-length batch."""
    items = []
    for _ in range(n_queries):
        q = rng.integers(0, 26, int(rng.integers(30, 120))).astype(np.uint8)
        targets = [
            rng.integers(0, 26, int(rng.integers(5, max_tlen))).astype(np.uint8)
            for _ in range(int(rng.integers(10, 40)))
        ]
        items.append((q, targets))
    return items


def _jax_mesh_aligner(**kw):
    kw.setdefault("b_cap", 32)
    al = JaxAligner(JAX_SCORER, backend="pallas", **kw)
    al.grouped_impl = "xla"
    assert al._mesh is not None, "conftest provides 8 virtual devices"
    return al


@pytest.mark.parametrize("n_dev", [8, 3])
def test_batch_aligner_over_devices_equals_one_device_and_jax(n_dev):
    """The launches split over the devices score exactly as one device and
    as the JAX mesh aligner; a launch counts once however many devices it
    spans.  With b_cap 8 most launches have more groups than devices
    (group axis), the rest fewer (batch axis)."""
    items = _mixed_items(np.random.default_rng(11))
    want = _jax_mesh_aligner().scores_many(items)
    for b_cap in (32, 8):
        one = BatchAligner(SCORER, backend="torch", b_cap=b_cap)
        many = BatchAligner(SCORER, backend="torch", b_cap=b_cap, devices=[CPU] * n_dev)
        got_one, got_many = one.scores_many(items), many.scores_many(items)
        for w, a, b in zip(want, got_one, got_many):
            np.testing.assert_array_equal(a, w)
            np.testing.assert_array_equal(b, w)
        assert many.launches == one.launches > 0


def test_batch_aligner_splits_on_the_right_axis(monkeypatch):
    """Eight devices: a launch of 14 groups goes over the group axis (its
    screen on each device), one of a single group over the batch axis (no
    screen); the keep lists equal the JAX mesh aligner's."""
    from sift4g_tpu_torch.align import batch as tbatch

    calls = []
    for name in ("make_grouped_sharded", "make_grouped_long_sharded"):
        real = getattr(tbatch, name)

        def spy(mesh, _real=real, _name=name, **kw):
            calls.append((_name, len(mesh), kw.get("screen_k", 0)))
            return _real(mesh, **kw)

        monkeypatch.setattr(tbatch, name, spy)
    rng = np.random.default_rng(7)
    items = []
    for n_t in (60, 3, 50):
        q = rng.integers(0, 26, 50).astype(np.uint8)
        items.append((q, [rng.integers(0, 26, int(rng.integers(20, 120))).astype(np.uint8)
                          for _ in range(n_t)]))
    ref = JaxAligner(JAX_SCORER, backend="numpy").scores_many(items)
    smins = [max(1, int(np.median(r))) for r in ref]
    k = 4
    al = BatchAligner(SCORER, backend="torch", b_cap=8, devices=[CPU] * 8)
    got = al.scores_many_async(items, screen=(smins, k))()
    jx = _jax_mesh_aligner(b_cap=8).scores_many_async(items, screen=(smins, k))()
    assert calls == [("make_grouped_sharded", 8, k)]
    calls.clear()
    al.scores_many_async(items[1:2], screen=(smins[1:2], k))()
    assert calls == [("make_grouped_long_sharded", 8, 0)]   # B=8 rows, one a device

    def keep(scores, smin):
        idx = np.flatnonzero(scores >= smin)
        return sorted(idx.tolist(), key=lambda i: (-int(scores[i]), i))[:k]

    for g, j, r, s in zip(got, jx, ref, smins):
        assert keep(g, s) == keep(r, s) == keep(j, s)
        np.testing.assert_array_equal(g[keep(g, s)], r[keep(r, s)])


@pytest.mark.parametrize("coalesce", [False, True], ids=["per-rung", "coalesced"])
def test_launches_scale_with_buckets_over_devices(coalesce, monkeypatch):
    """tests/test_parallel_pallas.py's launch count over 8 devices: one
    launch per rung bucket without tail coalescing, one with it, as the
    JAX mesh aligner."""
    rng = np.random.default_rng(7)
    items = []
    for _ in range(6):
        q = rng.integers(0, 26, 50).astype(np.uint8)
        targets = [rng.integers(0, 26, 100).astype(np.uint8) for _ in range(3)]
        targets += [rng.integers(0, 26, 500).astype(np.uint8) for _ in range(3)]
        items.append((q, targets))
    if not coalesce:
        monkeypatch.setenv("SIFT4G_TPU_TAIL_COALESCE", "0")
    jx = _jax_mesh_aligner()
    want = jx.scores_many(items)
    al = BatchAligner(SCORER, backend="torch", b_cap=32, tail_coalesce=coalesce,
                      devices=[CPU] * 8)
    got = al.scores_many(items)
    assert al.launches == jx.launches == (1 if coalesce else 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["SW", "HW"])
def test_batch_aligner_resident_over_devices(mode):
    """The resident database on every device: launches over 4 devices
    equal one device's and the JAX package's."""
    rng = np.random.default_rng(21)
    lens_seq = rng.integers(3, 700, 120).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, [CPU] * 4)
    assert rdb.devices == [CPU] and rdb.on(CPU) is rdb.dev
    with pytest.raises(ValueError, match="not on cuda:1"):
        rdb.on("cuda:1")
    lens = np.diff(offsets).astype(np.int32)
    items, raw = [], []
    for qlen, ids in ((40, np.arange(0, 120, 2)), (75, np.arange(120)), (20, np.arange(7))):
        q = rng.integers(0, 26, qlen).astype(np.uint8)
        items.append((q, rdb.packed_targets(ids, lens[ids])))
        raw.append((q, [codes[offsets[i] : offsets[i + 1]] for i in ids]))
    one = BatchAligner(SCORER, mode=mode, backend="torch", b_cap=16, resident=rdb)
    many = BatchAligner(SCORER, mode=mode, backend="torch", b_cap=16, resident=rdb,
                        devices=[CPU] * 4)
    jx = JaxAligner(JAX_SCORER, mode=mode, backend="xla", batch=8)
    jx._mesh = None
    for w, a, b in zip(jx.scores_many(raw), one.scores_many(items), many.scores_many(items)):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    assert many.launches == one.launches > 0


# ---- the pipeline on two devices --------------------------------------------


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    d = tmp_path_factory.mktemp("syn")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_db.py"), str(d),
         "--n-db", "2000", "--n-q", "3", "--subst-per-query", "5", "--seed", "2"],
        check=True, capture_output=True,
    )
    ref = d / "xla-ref"
    ref.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    subprocess.run(
        [sys.executable, "-m", "sift4g_tpu", "--platform", "cpu", "--backend", "xla",
         "--overlap", "off", "-q", str(d / "queries.fa"), "-d", str(d / "db.fa"),
         "--subst", str(d), "--out", str(ref)],
        check=True, capture_output=True, cwd=REPO, env=env,
    )
    return d


@pytest.mark.parametrize("resident", ["off", "on"])
def test_pipeline_on_two_devices_matches_jax(syn, resident, tmp_path):
    from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline

    out = tmp_path / "out"
    out.mkdir()
    cfg = PipelineConfig(
        query_path=str(syn / "queries.fa"), database_path=str(syn / "db.fa"),
        subst_path=str(syn), out_path=str(out), align_backend="torch",
        overlap="off", resident_db=resident, log=open(os.devnull, "w"),
    )
    run_pipeline(cfg, [CPU, CPU])
    names = sorted(os.listdir(syn / "xla-ref"))
    assert names == sorted(os.listdir(out))
    assert any(n.endswith(".SIFTprediction") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(syn / "xla-ref", out, names, shallow=False)
    assert not mismatch and not errors

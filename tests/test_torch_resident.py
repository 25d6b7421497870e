"""The port's device-resident database and its scorer against the JAX
package: the plain resident scorer, ``ResidentDB``, the aligner's resident
launches, the ``--resident-db`` decision, and the host layer the resident
path stands on (parse cache, search, synthetic inputs).  Tolerance: exact
integer equality and byte-identical files."""

import filecmp
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sift4g_tpu.align.batch import BatchAligner as JaxAligner  # noqa: E402
from sift4g_tpu.align.xla import _extend_matrix  # noqa: E402
from sift4g_tpu.core.scorers import create_scorer as jax_create_scorer  # noqa: E402
from sift4g_tpu_torch import pipeline as tpipe  # noqa: E402
from sift4g_tpu_torch.align import batch as tbatch  # noqa: E402
from sift4g_tpu_torch.align import resident as tres  # noqa: E402
from sift4g_tpu_torch.align import scan, sw_grouped  # noqa: E402
from sift4g_tpu_torch.align.batch import BatchAligner  # noqa: E402
from sift4g_tpu_torch.core.scorers import create_scorer  # noqa: E402
from sift4g_tpu_torch.io import fasta as tfasta  # noqa: E402

# the suite runs several worker processes at once: torch's OpenMP threads
# on top of them oversubscribe the cores and slow every test many times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["SW", "NW", "HW", "OV"]
SCORER = create_scorer("BLOSUM_62", 10, 1)
M32 = _extend_matrix(SCORER.matrix)


def _queries(rng, G, mq):
    q = np.full(G * mq, scan.PAD_CODE, np.int32)
    qo = (np.arange(G) * mq).astype(np.int32)
    ql = rng.integers(5, mq - 2, G).astype(np.int32)
    for g in range(G):
        q[g * mq : g * mq + ql[g]] = rng.integers(0, 26, ql[g])
    return q, qo, ql


def _plain(q, qo, ql, db, starts, lens, n_pad, mode, go=10, ge=1):
    out = sw_grouped.sw_scores_grouped_resident(
        torch.from_numpy(q), torch.from_numpy(qo), torch.from_numpy(ql),
        torch.from_numpy(db), torch.from_numpy(starts.astype(np.int64)),
        torch.from_numpy(lens), torch.from_numpy(M32), n_pad,
        mode=mode, gap_open=go, gap_extend=ge,
    )
    assert out.dtype == torch.int32 and out.shape == lens.shape
    return out.numpy()


@pytest.mark.parametrize("mode", MODES)
def test_plain_resident_matches_pallas_interpret(mode):
    """As tests/test_pallas_resident.py runs the Pallas kernel: 1024-aligned
    starts into a flat database, garbage past every length, an empty row."""
    from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped_resident

    rng = np.random.default_rng(11)
    G, B, N, mq = 2, 8, 128, 64
    R = 5000
    db = rng.integers(0, 26, R).astype(np.uint8)
    db_pad = np.concatenate([db, np.zeros((-R % 1024) + 4096, np.uint8)])
    starts = (rng.integers(0, R // 1024 + 1, (G, B)) * 1024).astype(np.int32)
    lens = rng.integers(1, N + 1, (G, B)).astype(np.int32)
    lens[0, 0] = 0
    q, qo, ql = _queries(rng, G, mq)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sw_scores_pallas_grouped_resident(
            jnp.asarray(q), jnp.asarray(qo), jnp.asarray(ql), jnp.asarray(db_pad),
            jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(M32), N,
            mode=mode, gap_open=10, gap_extend=1,
        ))
    np.testing.assert_array_equal(_plain(q, qo, ql, db_pad, starts, lens, N, mode), want)


@pytest.mark.parametrize("mode", MODES)
def test_plain_resident_matches_jax_xla_twin(mode):
    from sift4g_tpu.align.xla import align_scores_grouped_resident as xla_resident

    rng = np.random.default_rng(23)
    G, B, N, mq = 3, 10, 256, 80
    R = 9000
    db_pad = np.concatenate([rng.integers(0, 26, R).astype(np.uint8),
                             np.zeros((-R % 1024) + 4096, np.uint8)])
    starts = (rng.integers(0, R // 1024 + 1, (G, B)) * 1024).astype(np.int32)
    lens = rng.integers(0, N + 1, (G, B)).astype(np.int32)
    lens[0, :2] = (N, 0)
    q, qo, ql = _queries(rng, G, mq)
    got = _plain(q, qo, ql, db_pad, starts, lens, N, mode, go=11, ge=2)
    want = np.asarray(xla_resident(
        q, qo, ql, db_pad, starts, lens, M32, N, mode=mode, gap_open=11, gap_extend=2,
    ))
    # the XLA scan scores an empty target H[qlen, 0] under NW/HW where the
    # Pallas kernel (and the port) give NEG; every other cell must agree
    has = lens > 0
    np.testing.assert_array_equal(got[has], want[has])
    if mode in ("NW", "HW"):
        assert (got[~has] == scan.NEG).all()
    else:
        np.testing.assert_array_equal(got[~has], want[~has])


def _flat_db(rng, n, lo=10, hi=300):
    lens = rng.integers(lo, hi, n).astype(np.int64)
    offsets = np.concatenate(([0], np.cumsum(lens)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    return codes, offsets


def test_plain_resident_equals_slab_on_the_same_windows():
    """16-byte slots: a row's window runs into the next sequences and,
    for the last ones, into the tail pad; scores equal the slab scorer fed
    the same windows as a (G, B, N) slab."""
    rng = np.random.default_rng(5)
    codes, offsets = _flat_db(rng, 40)
    rdb = tres.ResidentDB(codes, offsets, "cpu")
    G, B, N = 2, 20, 384
    ids = np.arange(40).reshape(G, B)
    starts = rdb.slot_off[ids]
    lens = np.diff(offsets)[ids].astype(np.int32)
    lens[1, 5] = 0
    q, qo, ql = _queries(rng, G, 70)
    slab = rdb.host_slotted[starts[..., None] + np.arange(N)].astype(np.int8)
    assert starts[-1, -1] + N > rdb.nbytes   # the last window leaves the data
    for mode in MODES:
        want = sw_grouped.sw_scores_grouped(
            torch.from_numpy(q), torch.from_numpy(qo), torch.from_numpy(ql),
            torch.from_numpy(slab), torch.from_numpy(lens), torch.from_numpy(M32), mode=mode,
        ).numpy()
        np.testing.assert_array_equal(_plain(q, qo, ql, rdb.host_slotted, starts, lens, N, mode),
                                      want)


def test_resident_wrapper_uses_plain_version_on_cpu_only():
    sw_grouped.reset_counters()
    rng = np.random.default_rng(1)
    codes, offsets = _flat_db(rng, 8)
    rdb = tres.ResidentDB(codes, offsets, "cpu")
    q, qo, ql = _queries(rng, 1, 40)
    _plain(q, qo, ql, rdb.host_slotted, rdb.slot_off[None, :], np.diff(offsets)[None, :]
           .astype(np.int32), 384, "SW")
    assert sw_grouped.resident_launches == 0 and sw_grouped.twin_calls_on_cuda == 0
    meta = torch.zeros((1, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sw_grouped.sw_scores_grouped_resident(
            meta, meta, meta, torch.zeros(16, dtype=torch.uint8, device="meta"),
            meta, meta, meta, 16,
        )
    with pytest.raises(ValueError, match="unknown alignment mode"):
        _plain(q, qo, ql, rdb.host_slotted, rdb.slot_off[None, :1],
               np.ones((1, 1), np.int32), 128, "XX")


def _write_fasta(path, rng, n, lo=1, hi=400, planted=()):
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    with open(path, "wb") as fh:
        for i in range(n):
            fh.write(b">t%d\n%s\n" % (i, rng.choice(aas, int(rng.integers(lo, hi))).tobytes()))
        for i, s in enumerate(planted):
            fh.write(b">h%d\n%s\n" % (i, s))


@pytest.fixture
def cache_db(tmp_path, monkeypatch):
    """A synthetic database read through the port's parse cache."""
    monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(tmp_path / "cache"))
    _write_fasta(tmp_path / "db.fa", np.random.default_rng(2), 90)
    fs = tfasta.FastaStream(str(tmp_path / "db.fa"))
    assert isinstance(fs, tfasta.CachedFastaStream)
    yield fs
    tres.drop_resident_db()


def test_resident_db_layout(cache_db, monkeypatch):
    codes, offsets = cache_db._codes, cache_db._offsets
    rdb = tres.ResidentDB(codes, offsets, "cpu")
    n = offsets.shape[0] - 1
    lens = np.diff(offsets).astype(np.int32)
    assert (rdb.slot_off % tres.SLOT == 0).all()
    assert rdb.nbytes == tres.ResidentDB.slotted_size(offsets)
    pt = rdb.packed_targets(np.arange(n), lens)
    assert pt.codes is rdb.host_slotted
    for i in range(n):
        np.testing.assert_array_equal(pt[i], cache_db.codes_at(i))
    # the largest rung's window from the last sequence stays in bounds
    rung = tbatch._length_rung(int(lens.max()), tbatch.T_BUCKET)
    assert int(rdb.slot_off[-1]) + rung <= rdb.host_slotted.shape[0]
    assert rdb.dev.data_ptr() == rdb.host_slotted.ctypes.data   # no copy on the CPU
    # the native slot packer and the Python fallback lay out the same bytes
    monkeypatch.setenv("SIFT4G_TPU_NO_NATIVE", "1")
    py = tres.ResidentDB(codes, offsets, "cpu")
    np.testing.assert_array_equal(py.host_slotted, rdb.host_slotted)
    np.testing.assert_array_equal(py.slot_off, rdb.slot_off)


def test_resident_cache_key_reused_and_dropped(cache_db):
    codes, offsets = cache_db._codes, cache_db._offsets
    tres.drop_resident_db()
    assert not tres.resident_db_cached(codes, offsets, "cpu")
    a = tres.get_resident_db(codes, offsets, "cpu")
    assert tres.resident_db_cached(codes, offsets, "cpu")
    assert tres.get_resident_db(codes, offsets, "cpu") is a
    # another device is another upload
    assert not tres.resident_db_cached(codes, offsets, torch.device("cuda", 0))
    # another record span is another database
    assert not tres.resident_db_cached(codes, offsets[:-1], "cpu")
    assert tres.drop_resident_db() is True
    assert not tres.resident_db_cached(codes, offsets, "cpu")
    assert tres.drop_resident_db() is False
    assert tres.get_resident_db(codes, offsets, "cpu") is not a


@pytest.fixture
def resident_items():
    rng = np.random.default_rng(21)
    codes, offsets = _flat_db(rng, 120, lo=3, hi=700)
    rdb = tres.ResidentDB(codes, offsets, "cpu")
    lens = np.diff(offsets).astype(np.int32)
    items, raw = [], []
    for qlen, ids in ((40, np.arange(0, 120, 2)), (75, np.arange(120)), (20, np.arange(0))):
        q = rng.integers(0, 26, qlen).astype(np.uint8)
        items.append((q, rdb.packed_targets(ids, lens[ids])))
        raw.append((q, [codes[offsets[i] : offsets[i + 1]] for i in ids]))
    return rdb, items, raw


@pytest.mark.parametrize("mode", MODES)
def test_batch_aligner_resident_matches_slab_and_jax(mode, resident_items, monkeypatch):
    rdb, items, raw = resident_items
    calls = {"resident": 0, "slab": 0}
    for name, key in (("sw_scores_grouped_resident", "resident"),
                      ("sw_scores_grouped", "slab")):
        real = getattr(sw_grouped, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(sw_grouped, name, spy)
    res = BatchAligner(SCORER, mode=mode, backend="torch", b_cap=16, resident=rdb)
    got = res.scores_many(items)
    assert calls["resident"] == res.launches > 0 and calls["slab"] == 0
    slab = BatchAligner(SCORER, mode=mode, backend="torch", b_cap=16).scores_many(raw)
    jx = JaxAligner(jax_create_scorer("BLOSUM_62", 10, 1), mode=mode, backend="xla", batch=8)
    jx._mesh = None   # the CPU test platform has 8 virtual devices
    want = jx.scores_many(raw)
    for g, s, w in zip(got, slab, want):
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, w)


def test_batch_aligner_resident_screen_matches_jax(resident_items):
    rdb, items, raw = resident_items
    ref = JaxAligner(jax_create_scorer("BLOSUM_62", 10, 1), backend="numpy").scores_many(raw)
    smins = [max(1, int(np.median(r))) if len(r) else 1 for r in ref]
    k = 5
    got = BatchAligner(SCORER, backend="torch", b_cap=16, resident=rdb).scores_many_async(
        items, screen=(smins, k))()

    def keep(scores, smin):
        idx = np.flatnonzero(scores >= smin)
        return sorted(idx.tolist(), key=lambda i: (-int(scores[i]), i))[:k]

    for g, r, s in zip(got, ref, smins):
        assert keep(g, s) == keep(r, s)
        np.testing.assert_array_equal(g[keep(g, s)], r[keep(r, s)])


def test_resident_decision_with_injected_device(cache_db, monkeypatch, tmp_path):
    """The ``auto`` rule on synthetic inputs, the device kind injected."""
    offsets = cache_db._offsets
    n = offsets.shape[0] - 1
    cuda = torch.device("cuda", 0)
    slotted = tres.ResidentDB.slotted_size(offsets)
    assert tpipe._resident_budget(torch.device("cpu")) is None   # no limit on the CPU
    monkeypatch.setattr(tpipe, "_resident_budget", lambda dev: 1 << 40)
    few = [np.arange(3)]
    many = [np.arange(n)] * 3      # candidate bytes 3x the database
    tres.drop_resident_db()
    assert "candidate bytes" in tpipe._resident_refusal("auto", cuda, cache_db, few)
    assert tpipe._resident_refusal("auto", cuda, cache_db, many) is None
    assert tpipe._resident_refusal("auto", torch.device("cpu"), cache_db, many) == "no CUDA device"
    # "on" does not weigh the candidates or the device kind
    assert tpipe._resident_refusal("on", cuda, cache_db, few) is None
    assert tpipe._resident_refusal("on", torch.device("cpu"), cache_db, few) is None
    # a live upload of the same database is sunk cost: reused regardless
    tres._RESIDENT_CACHE["key"] = tres._resident_key(cache_db._codes, offsets, cuda)
    assert tpipe._resident_refusal("auto", cuda, cache_db, few) is None
    tres.drop_resident_db()
    # over the device budget: both modes refuse
    monkeypatch.setattr(tpipe, "_resident_budget", lambda dev: slotted)
    for flag in ("auto", "on"):
        assert "exceeds the device budget" in tpipe._resident_refusal(flag, cuda, cache_db, many)
    # no parse cache: both modes refuse, and "on" raises with the reason
    with tfasta.PyFastaStream(str(tmp_path / "db.fa")) as py:
        assert "parse cache" in tpipe._resident_refusal("auto", cuda, py, many)
        al = SimpleNamespace(devices=[torch.device("cpu")], backend="torch")
        with pytest.raises(tpipe.ResidentRefused, match="parse cache"):
            tpipe._maybe_resident_db(py, many, al, "on", open(os.devnull, "w"))


def test_search_candidates_match_jax(tmp_path):
    from sift4g_tpu.io.fasta import read_fasta as jax_read_fasta
    from sift4g_tpu.prefilter.search import search_database as jax_search
    from sift4g_tpu_torch.prefilter.search import search_database

    rng = np.random.default_rng(8)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    qs = [rng.choice(aas, int(rng.integers(60, 200))).tobytes() for _ in range(3)]
    _write_fasta(tmp_path / "db.fa", rng, 400, planted=qs)
    with open(tmp_path / "q.fa", "wb") as fh:
        for i, s in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, s))
    log = open(os.devnull, "w")
    kw = dict(kmer_length=3, max_candidates=50, chunk_bytes=20_000, log=log)
    got, cells = search_database(str(tmp_path / "db.fa"),
                                 tfasta.read_fasta(str(tmp_path / "q.fa")), **kw)
    want, cells_j = jax_search(str(tmp_path / "db.fa"),
                               jax_read_fasta(str(tmp_path / "q.fa")), **kw)
    assert cells == cells_j
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert len(g) > 0


def test_parse_cache_written_by_either_package_is_read_by_the_other(tmp_path, monkeypatch):
    from sift4g_tpu.io import fasta as jfasta

    _write_fasta(tmp_path / "db.fa", np.random.default_rng(3), 120)
    db = str(tmp_path / "db.fa")
    caches = {}
    for name, writer in (("jax", jfasta), ("port", tfasta)):
        monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(tmp_path / name))
        path = writer.build_fasta_cache(db)
        assert path == jfasta._cache_path(db) == tfasta._cache_path(db)
        with open(path, "rb") as fh:
            caches[name] = fh.read()
        # both packages read the cache alike, whichever wrote it, and
        # FastaStream takes it as its own (no rebuild)
        parts = []
        for reader in (jfasta, tfasta):
            more, codes, offs, names = reader.CachedFastaStream(path).read_part_arrays(1 << 40)
            parts.append((more, codes.tobytes(), offs.tolist(), names))
            assert isinstance(reader.FastaStream(db), reader.CachedFastaStream)
            with open(path, "rb") as fh:
                assert fh.read() == caches[name]
        assert parts[0] == parts[1] and len(parts[0][3]) == 120
    assert caches["jax"] == caches["port"]


def test_synthetic_generator_matches_tool(tmp_path):
    from sift4g_tpu_torch.synthetic import main as make_db

    args = ["--n-db", "400", "--n-q", "3", "--subst-per-query", "4", "--seed", "9",
            "--mean-len", "200"]
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_synthetic_db.py"),
                    str(tmp_path / "tool"), *args], check=True, capture_output=True)
    make_db([str(tmp_path / "port"), *args])
    names = sorted(os.listdir(tmp_path / "tool"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "tool", tmp_path / "port", names,
                                           shallow=False)
    assert not mismatch and not errors

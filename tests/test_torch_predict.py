"""Device predict of the port (``sift/scores_torch.py``,
``sift/predict_batch.py`` and the device branch of ``finish_pipeline``)
against the JAX package's ``scores_jax``/``predict_batch`` and the float64
host oracle, on the CPU.

Tolerances: the reference's own (``tests/test_sift_jax.py``): scores
rtol 2e-3, atol 2e-4 against either; weights rtol 2e-4, atol 1e-6; the
count of different letters exact; padding invariance rtol 1e-5, atol
1e-6; matrix-mode files within one printed digit (atol 1.5e-4).
Subst-mode files: byte-identical to the host oracle.  Outputs of one
input under another depth or chunk width: byte-identical."""

import filecmp
import io
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sift4g_tpu.sift import scores as S  # noqa: E402
from sift4g_tpu.sift import scores_jax as SJ  # noqa: E402
from sift4g_tpu_torch.core.chain import Chain  # noqa: E402
from sift4g_tpu_torch.sift import predict_batch as PB  # noqa: E402
from sift4g_tpu_torch.sift import scores_torch as ST  # noqa: E402
from sift4g_tpu_torch.sift.predict import predict_prepared, prepare_rows  # noqa: E402
from sift4g_tpu_torch.sift.predict_subst import finish_subst_query  # noqa: E402

torch.set_num_threads(1)

X = ord("X") - ord("A")
CPU = torch.device("cpu")
STD20 = np.array([ord(c) - ord("A") for c in "ACDEFGHIKLMNPQRSTVWY"])


def _random_alignment(rng, n, L):
    rows = rng.integers(0, 26, size=(n, L)).astype(np.uint8)
    rows[rng.random((n, L)) < 0.25] = X
    rows[0] = rng.integers(0, 20, size=L)
    return rows


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("shape", [(5, 40), (40, 120), (2, 8)])
def test_scores_match_jax_and_oracle(shape):
    rng = np.random.default_rng(9)
    rows = _random_alignment(rng, *shape)
    raw, _ = S.create_matrix(rows, np.ones(rows.shape[0]))

    want, w_weights, w_ndiff = S.calc_sift_scores(rows, raw)
    j_sift, j_weights, j_ndiff = SJ.calc_sift_scores_jit(rows.astype(np.int32),
                                                         raw.astype(np.float32))
    got, g_weights, g_ndiff = ST.calc_sift_scores(_t(rows)[None], _t(raw, torch.float32)[None])
    got, g_weights, g_ndiff = got[0].numpy(), g_weights[0].numpy(), g_ndiff[0].numpy()
    np.testing.assert_array_equal(g_ndiff, w_ndiff)
    np.testing.assert_array_equal(g_ndiff, np.asarray(j_ndiff))
    np.testing.assert_allclose(g_weights, w_weights, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(g_weights, np.asarray(j_weights), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(j_sift), rtol=2e-3, atol=2e-4)


def test_scores_batched_match_jax_vmap():
    rng = np.random.default_rng(11)
    q, n, L = 3, 10, 30
    rows = np.stack([_random_alignment(rng, n, L) for _ in range(q)])
    raws = np.stack([S.create_matrix(rows[i], np.ones(n))[0] for i in range(q)]).astype(np.float32)
    j_got, _, _ = SJ.calc_sift_scores_batch(rows.astype(np.int32), raws)
    got, _, _ = ST.calc_sift_scores(_t(rows), _t(raws))
    for i in range(q):
        want, _, _ = S.calc_sift_scores(rows[i], raws[i].astype(np.float64))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(j_got[i]), rtol=2e-3, atol=2e-4)
        # a query scores the same alone as in the batch
        alone, _, _ = ST.calc_sift_scores(_t(rows[i : i + 1]), _t(raws[i : i + 1]))
        np.testing.assert_array_equal(alone[0].numpy(), got[i].numpy())


def test_scores_from_rows_padding_invariant():
    """Padded all-'X' rows and positions with n_valid reproduce the
    unpadded result (padding is inert)."""
    rng = np.random.default_rng(13)
    n, L = 7, 50
    rows = _random_alignment(rng, n, L)
    base = ST.sift_scores_from_rows(_t(rows), n).numpy()
    packed = np.full((16, 128), X, dtype=np.int8)
    packed[:n, :L] = rows
    padded = ST.sift_scores_from_rows(_t(packed), n).numpy()
    np.testing.assert_allclose(padded[:L], base, rtol=1e-5, atol=1e-6)
    j_base = np.asarray(SJ.sift_scores_from_rows(rows.astype(np.int32), np.int32(n)))
    np.testing.assert_allclose(base, j_base, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("rows", [
    ["AAAAAA", "AAAAAA", "CCCCCC", "CCCCCC"],
    ["ACDEFG", "ACDEFG", "GFEDCA", "GFEDCA"],
    ["WWKKAA", "KKWWAA", "WWKKCC", "KKWWCC"],
], ids=["two-letters", "mirrored", "mixed"])
def test_argmax_ties_pick_the_first_letter(rows):
    """Rows in pairs of equal weight tie the weighted counts exactly; the
    pseudocount's rank row must come from the first maximum, as numpy's
    and jnp's argmax take it."""
    codes = np.array([[ord(c) - ord("A") for c in r] for r in rows], dtype=np.uint8)
    raw, _ = S.create_matrix(codes, np.ones(len(rows)))
    w, nd = ST.calc_seq_weights(_t(codes)[None], _t(raw, torch.float32)[None])
    weighted, _ = ST.create_matrix(ST._onehot_valid(_t(codes)[None]), w)
    top = weighted[0].amax(dim=1, keepdim=True)
    assert ((weighted[0] == top).sum(dim=1) >= 2).any(), "no tie was built"
    first = np.array([int(np.flatnonzero(r == r.max())[0]) for r in weighted[0].numpy()])
    np.testing.assert_array_equal(torch.argmax(weighted, dim=2)[0].numpy(), first)
    np.testing.assert_array_equal(first, np.argmax(weighted[0].numpy(), axis=1))
    eps = ST.calc_epsilon(weighted, torch.argmax(weighted, dim=2), nd)[0].numpy()
    w64 = weighted[0].numpy().astype(np.float64)
    want_eps = S.calc_epsilon(w64, S.find_max_aa(w64), nd[0].numpy().astype(np.float64))
    np.testing.assert_allclose(eps, want_eps, rtol=1e-6)
    want, _, _ = S.calc_sift_scores(codes, raw)
    got, _, _ = ST.calc_sift_scores(_t(codes)[None], _t(raw, torch.float32)[None])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-3, atol=2e-4)


def test_weighted_counts_match_jax_create_matrix():
    """The weighted count matrix (the one-hot scaled in place and summed
    over the rows): exact for weight-1 counts, within float32 rounding of
    the JAX module's einsum for real weights, and the one-hot consumed."""
    rng = np.random.default_rng(21)
    rows = _random_alignment(rng, 40, 120)
    w = rng.random(40).astype(np.float32)
    oh = ST._onehot_valid(_t(rows)[None])
    ones, ones_tot = ST.create_matrix(oh.clone(), torch.ones(1, 40))
    np.testing.assert_array_equal(ones[0].numpy(), S.create_matrix(rows, np.ones(40))[0])
    got, tot = ST.create_matrix(oh, _t(w)[None])
    j_got, j_tot = SJ.create_matrix(rows.astype(np.int32), w)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(j_got), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tot[0].numpy(), np.asarray(j_tot), rtol=1e-6, atol=1e-6)
    assert not torch.equal(oh, ST._onehot_valid(_t(rows)[None]))


def test_bucket_shapes_match_jax():
    from sift4g_tpu.sift.predict_batch import bucket_shapes as jax_buckets

    assert PB.bucket_shapes([37, 61, 37, 200], [6, 12, 3, 30]) == \
        {(128, 64): [0, 1, 2], (256, 64): [3]}
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 5000, 300).tolist()
    n_rows = rng.integers(1, 401, 300).tolist()
    assert PB.bucket_shapes(lens, n_rows) == jax_buckets(lens, n_rows)
    assert PB.MAX_DEVICE_QUERY_LEN == 4096


def test_chunk_widths_policy(monkeypatch):
    """The card's width rule: as many queries as fit, at most 64; the
    resident database is dropped only when the widest bucket's
    full-width chunk does not fit beside it; a caller's width is taken
    as given; on the CPU every bucket takes 64."""
    from sift4g_tpu_torch.align import resident

    buckets = {(512, 448): list(range(100)), (4096, 448): list(range(3))}
    assert PB.chunk_widths(buckets, CPU) == {k: 64 for k in buckets}
    assert PB.chunk_widths(buckets, CPU, q_chunk=5) == {k: 5 for k in buckets}
    cuda = torch.device("cuda", 0)
    assert PB.chunk_widths(buckets, cuda, q_chunk=7) == {k: 7 for k in buckets}
    free = {"bytes": 80 << 30}
    drops = []
    monkeypatch.setattr(resident, "free_device_bytes", lambda d: free["bytes"])

    def drop():
        drops.append(1)
        free["bytes"] += 30 << 30
        return True

    monkeypatch.setattr(resident, "drop_resident_db", drop)
    assert PB.chunk_widths(buckets, cuda) == {k: 64 for k in buckets} and not drops
    # the widest bucket's 3 queries take 0.8 GB: 2.0 GB free holds them
    # beside the 1 GiB headroom, 1.5 GB does not, and the drop frees 30 GB
    free["bytes"] = int(2.0e9)
    w = PB.chunk_widths(buckets, cuda)
    assert not drops and w[(4096, 448)] == 3 and w[(512, 448)] == 27
    free["bytes"] = int(1.5e9)
    w = PB.chunk_widths(buckets, cuda)
    assert drops and w == {k: 64 for k in buckets}
    per = PB.query_bytes((4096, 448))
    assert per == 4096 * 448 * PB.BYTES_PER_CELL + PB.DEPTH * 4096 * 26 * 4


def _prepared_queries(rng, shapes):
    queries, names_rows = [], []
    for qi, (n, L) in enumerate(shapes):
        rows = _random_alignment(rng, n, L)
        letters = (rows[0] % 20 + ord("A")).astype(np.uint8).tobytes().decode()
        q = Chain.from_string(f"q{qi}", letters)
        names = [f"t{j}" for j in range(n - 1)]
        queries.append(q)
        names_rows.append((names, rows[1:]))
    return queries, names_rows


def _parse_matrix(path):
    vals = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if parts and parts[0] not in ("ID", "AC", "DE", "MA", "//") \
                    and not parts[0].isalpha():
                vals.append([float(x) for x in parts])
    return np.asarray(vals)


def test_predict_matrix_batch_matches_jax_and_host(tmp_path):
    """Matrix-mode files of the port's device predict against the JAX
    package's device predict and the host float64 oracle."""
    from sift4g_tpu.core.chain import Chain as JChain
    from sift4g_tpu.sift.predict import prepare_rows as jax_prepare
    from sift4g_tpu.sift.predict_batch import predict_matrix_batch as jax_batch
    from sift4g_tpu_torch.sift.predict import predict_query

    rng = np.random.default_rng(17)
    queries, names_rows = _prepared_queries(rng, [(6, 37), (12, 61), (3, 37), (30, 200)])
    dirs = {k: tmp_path / k for k in ("host", "torch", "jax")}
    for d in dirs.values():
        d.mkdir()
    prepared, jq, jprep = [], [], []
    for q, (names, rows) in zip(queries, names_rows):
        predict_query(q, list(names), rows, str(tmp_path / "nosubst"), 100, str(dirs["host"]))
        prepared.append(prepare_rows(q, list(names), rows, 100))
        jq.append(JChain.from_string(q.name, q.letters))
        jprep.append(jax_prepare(jq[-1], list(names), rows, 100))
    PB.predict_matrix_batch(queries, prepared, str(dirs["torch"]), q_chunk=3, device=CPU)
    jax_batch(jq, jprep, str(dirs["jax"]), q_chunk=3)
    for q in queries:
        want = _parse_matrix(dirs["host"] / f"{q.name}.SIFTprediction")
        got = _parse_matrix(dirs["torch"] / f"{q.name}.SIFTprediction")
        j = _parse_matrix(dirs["jax"] / f"{q.name}.SIFTprediction")
        assert want.shape == got.shape == j.shape
        np.testing.assert_allclose(got, want, atol=1.5e-4)
        np.testing.assert_allclose(got, j, atol=1.5e-4)


@pytest.mark.parametrize("knob", ["depth", "q_chunk"])
def test_predict_batch_depth_and_chunk_invariance(tmp_path, knob):
    """The launches in flight and the queries per chunk change no byte."""
    rng = np.random.default_rng(23)
    queries, names_rows = _prepared_queries(
        rng, [(6, 37), (12, 61), (3, 37), (8, 61), (5, 37), (70, 130)])
    prepared = [prepare_rows(q, list(nm), r, 100) for q, (nm, r) in zip(queries, names_rows)]
    values = {"depth": (1, 2, 3), "q_chunk": (1, 2, 0)}[knob]
    outs = []
    for v in values:
        out = tmp_path / f"{knob}{v}"
        out.mkdir()
        kw = {"depth": v, "q_chunk": 2} if knob == "depth" else {"q_chunk": v}
        PB.predict_matrix_batch(queries, prepared, str(out), device=CPU, **kw)
        outs.append(out)
    names = sorted(os.listdir(outs[0]))
    assert len(names) == len(queries)
    for out in outs[1:]:
        assert names == sorted(os.listdir(out))
        for name in names:
            assert filecmp.cmp(outs[0] / name, out / name, shallow=False), (knob, name)


def test_predict_matrix_batch_refuses_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    queries, names_rows = _prepared_queries(rng, [(3, 20)])
    prepared = [prepare_rows(queries[0], list(names_rows[0][0]), names_rows[0][1], 100)]
    with pytest.raises(RuntimeError, match="needs a visible GPU"):
        PB.predict_matrix_batch(queries, prepared, str(tmp_path))
    assert not os.listdir(tmp_path)


# ---- subst mode: the f32 screen + float64 hybrid, byte-identical ----


def _random_case(rng, conserved=False):
    L = int(rng.integers(12, 200))
    n = int(rng.integers(2, 60))
    q_codes = rng.choice(STD20, L).astype(np.uint8)
    if conserved:
        rows = np.tile(q_codes, (n, 1))
        mut = rng.random(rows.shape) < 0.08
        rows[mut] = rng.choice(STD20, int(mut.sum()))
    else:
        rows = rng.choice(STD20, (n, L)).astype(np.uint8)
    rows[rng.random(rows.shape) < 0.15] = X
    rows[0] = q_codes
    query = Chain.from_string("Q", "".join(chr(c + ord("A")) for c in q_codes))
    pos = rng.choice(L, size=min(int(rng.integers(1, 8)), L), replace=False)
    lines = ["# comment", "bogus line"]
    for p in sorted(pos.tolist()):
        lines.append(f"{query.char(p)}{p + 1}{chr(int(rng.choice(STD20)) + ord('A'))}  ")
    return query, rows, lines


def _f32_screen(rows):
    """The port's device scores for one query, padded to its bucket as
    predict_batch pads it."""
    n, L = rows.shape
    packed = np.full((-(-n // 64) * 64, -(-L // 128) * 128), X, dtype=np.int8)
    packed[:n, :L] = rows
    return ST.sift_scores_from_rows(_t(packed), n).numpy()[:L]


def _oracle_files(tmp_path, tag, query, rows, lines):
    """The host oracle's file from the port and from the JAX package."""
    from sift4g_tpu.core.chain import Chain as JChain
    from sift4g_tpu.sift.predict import predict_prepared as jax_prepared

    want = tmp_path / f"want_{tag}.SIFTprediction"
    jwant = tmp_path / f"jwant_{tag}.SIFTprediction"
    predict_prepared(query, rows, lines, str(want))
    jax_prepared(JChain.from_string(query.name, query.letters), rows, lines, str(jwant))
    assert filecmp.cmp(want, jwant, shallow=False)
    return want


@pytest.mark.parametrize("conserved", [False, True])
def test_subst_hybrid_byte_identical_to_oracle_fuzz(tmp_path, conserved):
    rng = np.random.default_rng(17 if conserved else 5)
    for trial in range(10):
        query, rows, lines = _random_case(rng, conserved)
        want = _oracle_files(tmp_path, f"{conserved}_{trial}", query, rows, lines)
        got = tmp_path / f"got_{conserved}_{trial}.SIFTprediction"
        finish_subst_query(query, rows, lines, _f32_screen(rows), str(got), log=io.StringIO())
        assert filecmp.cmp(want, got, shallow=False), (conserved, trial)


def test_subst_screen_drift_falls_back_to_oracle(tmp_path):
    """eps_screen=0: any f32 drift trips the in-run verification and the
    query falls back to the float64 oracle, byte-identical."""
    query, rows, lines = _random_case(np.random.default_rng(29))
    want = _oracle_files(tmp_path, "drift", query, rows, lines)
    got = tmp_path / "got.SIFTprediction"
    log = io.StringIO()
    finish_subst_query(query, rows, lines, _f32_screen(rows), str(got), eps_screen=0.0, log=log)
    assert "falling back to the float64 oracle" in log.getvalue()
    assert filecmp.cmp(want, got, shallow=False)


def test_subst_padded_screen_rows_ignored(tmp_path):
    query, rows, lines = _random_case(np.random.default_rng(31))
    want = _oracle_files(tmp_path, "pad", query, rows, lines)
    got = tmp_path / "got.SIFTprediction"
    padded = np.vstack([_f32_screen(rows), np.full((7, 26), 0.001, np.float32)])
    finish_subst_query(query, rows, lines, padded, str(got), log=io.StringIO())
    assert filecmp.cmp(want, got, shallow=False)


def test_subst_hybrid_edge_cases_byte_identical(tmp_path):
    """Positions 1 and L, every substitution at one position, invalid
    letters (X/B/Z) in the query itself, duplicate lines; and the
    degenerate shapes: the query alone, an L = 1 query."""
    rng = np.random.default_rng(101)
    L, n = 40, 12
    q = list(rng.choice(STD20, L).astype(np.uint8))
    q[4], q[5], q[6] = X, ord("B") - ord("A"), ord("Z") - ord("A")
    q_codes = np.asarray(q, dtype=np.uint8)
    rows = np.tile(q_codes, (n, 1))
    mut = rng.random(rows.shape) < 0.25
    rows[mut] = rng.choice(STD20, int(mut.sum()))
    rows[0] = q_codes
    query = Chain.from_string("Q", "".join(chr(c + ord("A")) for c in q_codes))
    lines = [f"{query.char(0)}1{a}" for a in "ACDEFGHIKLMNPQRSTVWY"]
    lines += [f"{query.char(L - 1)}{L}M"] * 3
    lines += [f"{query.char(4)}5K", f"{query.char(5)}6K", f"{query.char(6)}7K"]
    cases = [("edge", query, rows, lines)]
    for L1, n1 in ((1, 1), (3, 1), (1, 4)):
        c = np.random.default_rng(L1 * 10 + n1).choice(STD20, L1).astype(np.uint8)
        qq = Chain.from_string("Q", "".join(chr(x + ord("A")) for x in c))
        cases.append((f"tiny{L1}_{n1}", qq, np.tile(c, (n1, 1)), [f"{qq.char(0)}1A"]))
    for tag, qq, rr, ll in cases:
        want = _oracle_files(tmp_path, tag, qq, rr, ll)
        got = tmp_path / f"got_{tag}.out"
        finish_subst_query(qq, rr, ll, _f32_screen(rr), str(got), log=io.StringIO())
        assert filecmp.cmp(want, got, shallow=False), tag


# ---- the device branch of finish_pipeline ----


def _homolog_inputs(tmp_path, seed, qlens, n_db=40, subst=True):
    rng = np.random.default_rng(seed)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    qs = {f"Q{i}": "".join(rng.choice(list(aas), L)) for i, L in enumerate(qlens)}
    with open(tmp_path / "q.fa", "w") as fh:
        for n, s in qs.items():
            fh.write(f">{n}\n{s}\n")
    with open(tmp_path / "db.fa", "w") as fh:
        for i in range(n_db):
            fh.write(f">t{i}\n{''.join(rng.choice(list(aas), 150))}\n")
        for n, s in qs.items():  # exact homologs and a mutated copy pass the E-value filter
            fh.write(f">h_{n}\n{s}\n")
            mut = "".join(c if rng.random() > 0.2 else rng.choice(list(aas)) for c in s)
            fh.write(f">m_{n}\n{mut}\n")
    sub = tmp_path / "subst"
    sub.mkdir(exist_ok=True)
    if subst:
        for n, s in qs.items():
            with open(sub / f"{n}.subst", "w") as fh:
                for p in sorted(rng.choice(len(s), 4, replace=False).tolist()):
                    fh.write(f"{s[p]}{p + 1}{rng.choice(list(aas))}\n")
    return qs


def _run(tmp_path, tag, **kw):
    from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from sift4g_tpu_torch.utils import PhaseMetrics

    out = tmp_path / tag
    out.mkdir()
    metrics = PhaseMetrics(log=io.StringIO(), enabled=False)
    cfg = PipelineConfig(query_path=str(tmp_path / "q.fa"), database_path=str(tmp_path / "db.fa"),
                         out_path=str(out), align_backend="torch", overlap="off",
                         log=io.StringIO(), metrics=metrics, **kw)
    run_pipeline(cfg)
    return out, metrics


def test_long_queries_route_to_host_oracle(tmp_path, monkeypatch):
    """Queries beyond MAX_DEVICE_QUERY_LEN stay on the float64 host path
    under device predict; their files are the oracle's bytes."""
    monkeypatch.setattr(PB, "MAX_DEVICE_QUERY_LEN", 100)
    _homolog_inputs(tmp_path, 9, (60, 240), subst=False)
    routed = []
    real = PB.predict_matrix_batch

    def spy(queries, *a, **kw):
        routed.extend(q.name for q in queries)
        return real(queries, *a, **kw)

    monkeypatch.setattr(PB, "predict_matrix_batch", spy)
    host, _ = _run(tmp_path, "host", predict_backend="host")
    dev, m = _run(tmp_path, "device", predict_backend="device")
    assert routed == ["Q0"]
    assert (dev / "Q0.SIFTprediction").exists()
    assert filecmp.cmp(host / "Q1.SIFTprediction", dev / "Q1.SIFTprediction", shallow=False)
    assert {"predict.prep", "predict.pack", "predict.fetch", "predict.writedrain"} <= \
        set(m.phases)


def test_pipeline_device_subst_byte_identical_to_host(tmp_path):
    """Subst-mode files of device predict through the pipeline equal host
    predict's, byte for byte, with the finishers' drain timed."""
    _homolog_inputs(tmp_path, 5, (70, 130, 200))
    sub = str(tmp_path / "subst")
    host, _ = _run(tmp_path, "host", predict_backend="host", subst_path=sub)
    dev, m = _run(tmp_path, "device", predict_backend="device", subst_path=sub)
    names = sorted(os.listdir(host))
    assert sum(n.endswith(".SIFTprediction") for n in names) == 3
    assert names == sorted(os.listdir(dev))
    for name in names:
        assert filecmp.cmp(host / name, dev / name, shallow=False), name


def test_pipeline_subst_process_pool_byte_identical(tmp_path, monkeypatch):
    """The finishers on a spawn process pool write the same bytes as
    inline, and as host predict."""
    _homolog_inputs(tmp_path, 6, (80, 120))
    sub = str(tmp_path / "subst")
    host, _ = _run(tmp_path, "host", predict_backend="host", subst_path=sub)
    monkeypatch.setenv("SIFT4G_TPU_SUBST_PROCS", "2")
    pool, m = _run(tmp_path, "pool", predict_backend="device", subst_path=sub)
    assert "predict.substdrain" in m.phases
    for name in sorted(os.listdir(host)):
        assert filecmp.cmp(host / name, pool / name, shallow=False), name


def test_predict_device_follows_the_backend():
    from sift4g_tpu_torch.pipeline import PipelineConfig, predict_device

    assert predict_device(PipelineConfig(align_backend="torch")) == CPU
    assert predict_device(PipelineConfig(align_backend="native")) == CPU
    two = [torch.device("cuda", 1), torch.device("cuda", 0)]
    assert predict_device(PipelineConfig(align_backend="cuda"), two) == torch.device("cuda", 1)

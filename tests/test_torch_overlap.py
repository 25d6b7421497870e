"""The port's overlapped pipeline (prefilter + provisional scoring,
``pipeline._overlap_cache``/``_run_overlapped``) against its two-phase
order and against the JAX package's overlapped run, on the CPU (the
plain PyTorch scorer, ``--backend torch``).

The synthetic runs force many small search chunks and a small
``max_candidates``, so later chunks evict earlier provisional candidates.
Tolerance: every output file byte-identical."""

import filecmp
import io
import os

import numpy as np
import pytest
import torch

from sift4g_tpu_torch import native
from sift4g_tpu_torch import pipeline as P
from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline
from sift4g_tpu_torch.utils import PhaseMetrics

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.load() is None, reason="native engine unavailable")


@pytest.fixture(autouse=True)
def _fresh_finisher_pool(monkeypatch):
    """The port keeps one subst finisher pool a process
    (``predict_subst.POOL``), started from a process's second
    device-predict job with subst queries: each test starts with a
    process that has run no such job and holds no pool, and leaves none."""
    from sift4g_tpu_torch.sift import predict_subst

    monkeypatch.setattr(predict_subst, "POOL", predict_subst.FinisherPool())
    yield
    predict_subst.POOL.close()


def _make_db(tmp_path, n_db=1500, n_q=3, seed=3):
    rng = np.random.default_rng(seed)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    db = tmp_path / "db.fa"
    with open(db, "wb") as fh:
        for i in range(n_db):
            seq = rng.choice(aas, size=int(rng.integers(50, 400))).tobytes()
            fh.write(b">s%d\n%s\n" % (i, seq))
    q = tmp_path / "q.fa"
    with open(q, "wb") as fh:
        for i in range(n_q):
            seq = rng.choice(aas, size=int(rng.integers(80, 200))).tobytes()
            fh.write(b">q%d\n%s\n" % (i, seq))
    return str(q), str(db)


def _run(tmp_path, tag, q, db, **kw):
    out = tmp_path / tag
    out.mkdir()
    metrics = PhaseMetrics(log=io.StringIO(), enabled=False)
    cfg = PipelineConfig(query_path=q, database_path=db, out_path=str(out),
                         align_backend="torch", log=io.StringIO(), metrics=metrics, **kw)
    run_pipeline(cfg)
    return out, metrics


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert "alignments.txt" in names and names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_overlapped_pipeline_matches_two_phase_and_jax(tmp_path):
    from sift4g_tpu.pipeline import PipelineConfig as JaxConfig
    from sift4g_tpu.pipeline import run_pipeline as jax_run

    q, db = _make_db(tmp_path)
    kw = dict(sub_results=True, max_candidates=40, search_chunk_bytes=40_000)
    off, m_off = _run(tmp_path, "off", q, db, overlap="off", **kw)
    on, m_on = _run(tmp_path, "on", q, db, overlap="on", **kw)
    assert "overlapped" not in m_off.phases["search"]
    assert m_on.phases["search"]["overlapped"] == 1.0
    # align's cells are the final candidate sets' in either schedule; the
    # provisional ones hold the evicted candidates' besides
    assert m_on.phases["align"]["cells"] == m_off.phases["align"]["cells"]
    assert m_on.phases["align.provisional"]["cells"] >= m_on.phases["align"]["cells"]
    _same_tree(off, on)
    jax_out = tmp_path / "jax-on"
    jax_out.mkdir()
    jax_run(JaxConfig(query_path=q, database_path=db, out_path=str(jax_out),
                      align_backend="numpy", overlap="on", log=open(os.devnull, "w"), **kw))
    _same_tree(on, jax_out)


def test_overlap_auto_gates_off_without_cache(tmp_path, monkeypatch):
    """Without a parse cache "on" keeps the two-phase order: the output
    is right, nothing fails."""
    q, db = _make_db(tmp_path, n_db=300)
    ref, _ = _run(tmp_path, "ref", q, db, sub_results=True, overlap="off")
    monkeypatch.setenv("SIFT4G_TPU_NO_FASTA_CACHE", "1")
    got, m = _run(tmp_path, "got", q, db, sub_results=True, overlap="on")
    assert "overlapped" not in m.phases["search"]
    _same_tree(ref, got)


def test_overlap_auto_gates_on_cores_and_backend(tmp_path, monkeypatch):
    """auto resolves off below 8 available cores and off unless the run
    scores on CUDA devices; explicit "on" has neither gate."""
    q, db = _make_db(tmp_path, n_db=50)
    cfg = PipelineConfig(query_path=q, database_path=db, out_path=str(tmp_path),
                         align_backend="cuda", overlap="auto", log=io.StringIO())
    cards = [torch.device("cuda", 0)]
    monkeypatch.setattr(P.os, "sched_getaffinity", lambda pid: set(range(4)))
    assert P._overlap_cache(cfg, 1, cards) is None
    monkeypatch.setattr(P.os, "sched_getaffinity", lambda pid: set(range(16)))
    assert P._overlap_cache(cfg, 1, cards) is not None
    # the CPU is no accelerator: a CPU device list, the torch and native
    # backends, and no visible card all keep the two-phase order
    assert P._overlap_cache(cfg, 1, [torch.device("cpu")]) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P._overlap_cache(cfg, 1, None) is None
    for backend in ("torch", "native"):
        cfg.align_backend = backend
        assert P._overlap_cache(cfg, 1, [torch.device("cpu")]) is None
    cfg.overlap = "on"
    assert P._overlap_cache(cfg, 1, [torch.device("cpu")]) is not None
    monkeypatch.setattr(P.os, "sched_getaffinity", lambda pid: set(range(2)))
    assert P._overlap_cache(cfg, 1, [torch.device("cpu")]) is not None


def test_overlap_refuses_above_the_budget(tmp_path):
    """The provisional entries (queries x max_candidates) above
    ``overlap_budget`` refuse the overlap, loudly under "on" and silently
    under "auto"; the run keeps the two-phase order."""
    log = io.StringIO()
    cfg = PipelineConfig(database_path="/nonexistent", overlap="on", max_candidates=5000,
                         log=log)
    assert P._overlap_cache(cfg, n_queries=10_001) is None
    assert "refused" in log.getvalue() and "overlap_budget" in log.getvalue()
    log2 = io.StringIO()
    cfg2 = PipelineConfig(database_path="/nonexistent", overlap="auto", max_candidates=5000,
                          log=log2)
    assert P._overlap_cache(cfg2, n_queries=10_001) is None
    assert log2.getvalue() == ""
    # a budget given as a parameter
    q, db = _make_db(tmp_path, n_db=300)
    ref, _ = _run(tmp_path, "ref", q, db, overlap="off", max_candidates=40, sub_results=True)
    got, m = _run(tmp_path, "got", q, db, overlap="on", max_candidates=40, overlap_budget=100,
                  sub_results=True)
    assert "overlapped" not in m.phases["search"]
    _same_tree(ref, got)


def test_overlap_compaction_is_exact(tmp_path):
    """Compaction at every chunk (cap 0) changes no byte: evicted ids never
    re-enter (the monotone floor, Q3)."""
    q, db = _make_db(tmp_path, n_db=1200, seed=11)
    kw = dict(sub_results=True, max_candidates=30, search_chunk_bytes=30_000)
    off, _ = _run(tmp_path, "off", q, db, overlap="off", **kw)
    on, m = _run(tmp_path, "on", q, db, overlap="on", overlap_compact_cap=0, **kw)
    assert m.phases["search"]["overlapped"] == 1.0
    _same_tree(off, on)


def test_overlap_with_device_subst_predict_matches_oracle(tmp_path):
    """The overlap with ``--predict-backend device`` on subst queries:
    byte-identical to the two-phase host-oracle run."""
    rng = np.random.default_rng(23)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    qs = [rng.choice(aas, size=int(rng.integers(80, 200))).tobytes() for _ in range(3)]
    db = tmp_path / "db.fa"
    with open(db, "wb") as fh:
        for i in range(1200):
            seq = rng.choice(aas, size=int(rng.integers(50, 400))).tobytes()
            fh.write(b">s%d\n%s\n" % (i, seq))
        for i, s in enumerate(qs):  # homologs pass the E-value filter
            fh.write(b">h%d\n%s\n" % (i, s))
    q = tmp_path / "q.fa"
    with open(q, "wb") as fh:
        for i, s in enumerate(qs):
            fh.write(b">q%d\n%s\n" % (i, s))
    subst = tmp_path / "subst"
    subst.mkdir()
    for i, s in enumerate(qs):
        with open(subst / f"q{i}.subst", "w") as fh:
            for p in sorted(rng.choice(len(s), 4, replace=False).tolist()):
                fh.write(f"{chr(s[p])}{p + 1}{chr(int(rng.choice(aas)))}\n")
    kw = dict(subst_path=str(subst), max_candidates=40, search_chunk_bytes=40_000)
    oracle, _ = _run(tmp_path, "oracle", str(q), str(db), overlap="off", predict_backend="host",
                     **kw)
    stack, m = _run(tmp_path, "stack", str(q), str(db), overlap="on", predict_backend="device",
                    **kw)
    assert m.phases["search"]["overlapped"] == 1.0 and "predict.pack" in m.phases
    names = sorted(f for f in os.listdir(oracle) if f.endswith(".SIFTprediction"))
    assert len(names) == 3
    for name in names:
        assert filecmp.cmp(oracle / name, stack / name, shallow=False), name


def test_overlapped_run_never_builds_the_resident_database(tmp_path):
    """An overlapped run scores on slabs: with ``--resident-db on`` it
    builds no resident database (as in the JAX package), the two-phase
    run does, and the outputs agree."""
    from sift4g_tpu_torch.align import resident

    q, db = _make_db(tmp_path, n_db=300)
    resident.drop_resident_db()
    out = tmp_path / "on"
    out.mkdir()
    log = io.StringIO()
    m = PhaseMetrics(log=log, enabled=False)
    run_pipeline(PipelineConfig(query_path=q, database_path=db, out_path=str(out),
                                align_backend="torch", overlap="on", resident_db="on",
                                sub_results=True, log=log, metrics=m))
    assert m.phases["search"]["overlapped"] == 1.0
    assert "--resident-db on has no effect in an overlapped run" in log.getvalue()
    assert not resident.drop_resident_db()
    off, _ = _run(tmp_path, "off", q, db, overlap="off", resident_db="on", sub_results=True)
    assert resident.drop_resident_db()
    _same_tree(off, out)

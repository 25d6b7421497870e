"""The port's spans and counters (``utils.PhaseMetrics`` and the spans of
search and align), and the benchmark's readers of them, on the CPU.

``PhaseMetrics.phase`` opens a ``phase:``-prefixed profiler range only
while a profiler records and only on the thread that made it; the
traceback counts the cells of its striped int16 and scalar int32 paths
and the pairs whose int16 fill saturated;
the scan's split sums to no more than the scan; and the readers in
``benchmark/metrics`` turn the counters into the per-layer metrics."""

import io
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sift4g_tpu_torch import native
from sift4g_tpu_torch.align.host import ALIGN_STATS, align_pairs_batch
from sift4g_tpu_torch.core.scorers import create_scorer
from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline
from sift4g_tpu_torch.utils import RANGE_PREFIX, PhaseMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS_DIR = os.path.join(ROOT, "benchmark", "metrics")

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(native.load() is None, reason="native engine unavailable")


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


def _ranges(prof):
    """(name, thread id, start us, end us) of the profiler's ranges."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(RANGE_PREFIX)]


def test_spans_are_nested_profiler_ranges_on_the_job_thread_only():
    m = PhaseMetrics(enabled=False)

    def worker():
        with m.phase("align.worker"):
            pass

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.phase("align"):
            with m.phase("align.traceback"):
                with m.phase("align.traceback.native"):
                    torch.ones(4).sum()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    got = {name: (tid, s, e) for name, tid, s, e in _ranges(prof)}
    assert set(got) == {"phase:align", "phase:align.traceback", "phase:align.traceback.native"}
    # one thread, each range inside its parent
    assert len({tid for tid, _, _ in got.values()}) == 1
    for outer, inner in (("phase:align", "phase:align.traceback"),
                         ("phase:align.traceback", "phase:align.traceback.native")):
        assert got[outer][1] <= got[inner][1] and got[inner][2] <= got[outer][2]
    # the worker's span still counts its seconds
    assert {"align", "align.traceback", "align.traceback.native", "align.worker"} <= set(m.phases)
    assert all(d["seconds"] >= 0 for d in m.phases.values())


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    m = PhaseMetrics(enabled=False)
    with m.phase("search"):
        with m.phase("search.scan"):
            pass
    assert opened == []
    assert m.phases["search"]["seconds"] >= m.phases["search.scan"]["seconds"]


def _codes(rng, n):
    return rng.integers(0, 20, size=n).astype(np.uint8)


@needs_native
@pytest.mark.parametrize("mode, qlen, tlen, path", [
    ("SW", 300, 420, "striped"),      # the homolog scores far under 30,000
    ("SW", 2800, 2750, "striped"),    # past min(qlen, n) x 11 >= 30000, yet its best stays under 30,000
    ("NW", 300, 420, "scalar"),       # the striped fill is SW only
    ("SW", 3000, 3000, "saturated"),  # a run of W against itself scores 33,000: rerun on int32
])
def test_traceback_counts_the_cells_of_each_path(monkeypatch, mode, qlen, tlen, path):
    monkeypatch.delenv("SIFT4G_TPU_NO_SIMD", raising=False)
    rng = np.random.default_rng(qlen + tlen)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    if path == "saturated":
        q = np.full(qlen, ord("W") - ord("A"), dtype=np.uint8)
        homolog = q[:tlen].copy()
    else:
        q = _codes(rng, qlen)
        # a homolog of the query and an unrelated target of the same length
        homolog = q[:tlen].copy() if tlen <= qlen else np.concatenate([q, _codes(rng, tlen - qlen)])
        homolog[::7] = _codes(rng, homolog[::7].size)
    targets = [homolog, _codes(rng, tlen)]
    m = PhaseMetrics(enabled=False)
    recs = align_pairs_batch(q, targets, scorer, mode, threads=2, metrics=m)
    # without metrics the C++ gets a null stats array and reads no clock
    plain = align_pairs_batch(q, targets, scorer, mode, threads=2)
    for a, b in zip(recs, plain):
        assert (a.score, a.query_start, a.query_end, a.target_start, a.target_end) == \
            (b.score, b.query_start, b.query_end, b.target_start, b.target_end)
        assert np.array_equal(a.moves, b.moves)
    d = m.phases["align.traceback.native"]
    assert set(ALIGN_STATS) <= set(d)
    cells = float(qlen) * 2 * tlen
    assert d["cells"] == cells and d["pairs"] == 2 and d["threads"] == 2
    assert d["striped_cells"] + d["scalar_cells"] == d["cells"]
    # the saturated homolog falls back to the scalar path, the unrelated
    # target stays on the striped one
    paths = ["scalar", "striped"] if path == "saturated" else [path, path]
    for p in ("striped", "scalar"):
        k = paths.count(p)
        assert d[p + "_cells"] == k * cells / 2
        assert (d[p + "_thread_s"] > 0) == (k > 0)
    if path == "saturated":
        assert recs[0].score == 11 * qlen
    assert d["saturated_pairs"] == (1 if path == "saturated" else 0)
    for span in ("align.traceback.pack", "align.traceback.native", "align.traceback.records"):
        assert m.phases[span]["seconds"] >= 0


@needs_native
@pytest.mark.parametrize("mode, simd", [("SW", True), ("SW", False), ("NW", True)],
                         ids=["striped", "no-simd", "nw"])
def test_traceback_walk_seconds_are_the_striped_pairs_time_after_the_fill(monkeypatch, mode, simd):
    """``walk_thread_s``: the striped pairs' seconds after their fill, a
    part of ``striped_thread_s``; none where no pair takes the striped path
    (``SIFT4G_TPU_NO_SIMD``, NW)."""
    if simd:
        monkeypatch.delenv("SIFT4G_TPU_NO_SIMD", raising=False)
    else:
        monkeypatch.setenv("SIFT4G_TPU_NO_SIMD", "1")
    rng = np.random.default_rng(3)
    q = _codes(rng, 700)
    homolog = q.copy()
    homolog[::6] = _codes(rng, homolog[::6].size)
    targets = [homolog, _codes(rng, 650), q[100:600].copy()]
    m = PhaseMetrics(enabled=False)
    align_pairs_batch(q, targets, create_scorer("BLOSUM_62", 10, 1), mode, threads=2, metrics=m)
    d = m.phases["align.traceback.native"]
    assert "walk_thread_s" in ALIGN_STATS and "walk_thread_s" in d
    if mode == "SW" and simd:
        assert d["striped_cells"] == d["cells"]
        assert 0 < d["walk_thread_s"] < d["striped_thread_s"]
    else:
        assert d["striped_cells"] == 0 and d["walk_thread_s"] == 0


@pytest.mark.parametrize("scorer, device, acc", [
    ("grouped", "cuda:0", "int"),
    ("grouped", "cuda:0", "i16"),     # a pair of targets a thread group: 2 x 129 slots
    ("resident", "cuda:0", "int"),
    ("long", "cuda:0", "int"),        # K2 streams the rows as they are
    ("grouped", "cpu", "int"),        # the plain version: rows as they are
])
def test_grid_cells_follow_the_wrappers_geometry(monkeypatch, scorer, device, acc):
    from sift4g_tpu_torch.align import sw_grouped

    monkeypatch.setattr(sw_grouped, "_sm_count", lambda index: 132)
    q_lens, B, N = [144, 300, 0], 257, 512
    got = sw_grouped.grid_cells(scorer, q_lens, B, N, device, acc=acc)
    if device == "cpu" or scorer == "long":
        assert got == sum(q_lens) * B * N
        return
    width = sw_grouped.thread_groups(B, acc)
    T, _ = sw_grouped.tile_geometry(len(q_lens), width, N, 132)
    step = sw_grouped.TILE_ROWS * T
    rows = sum(-(-q // step) * step for q in q_lens)
    assert got == rows * (2 * width if acc == "i16" else B) * N
    assert got >= sum(q_lens) * B * N


def _make_db(tmp_path, n_db=800, n_q=3, seed=11):
    """A database with a family of mutated homologs of each query, so some
    candidates survive the E-value cut and are traced back."""
    rng = np.random.default_rng(seed)
    aas = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", dtype=np.uint8)
    queries = [rng.choice(aas, size=int(rng.integers(120, 260))) for _ in range(n_q)]
    with open(tmp_path / "q.fa", "wb") as fh:
        for i, s in enumerate(queries):
            fh.write(b">q%d\n%s\n" % (i, s.tobytes()))
    with open(tmp_path / "db.fa", "wb") as fh:
        for i in range(n_db):
            if i % 20 == 0:
                s = queries[(i // 20) % n_q].copy()
                hit = rng.random(s.size) < 0.2
                s[hit] = rng.choice(aas, size=int(hit.sum()))
            else:
                s = rng.choice(aas, size=int(rng.integers(50, 400)))
            fh.write(b">s%d\n%s\n" % (i, s.tobytes()))
    return str(tmp_path / "q.fa"), str(tmp_path / "db.fa")


def _run(tmp_path, tag, q, db, **kw):
    out = tmp_path / tag
    out.mkdir()
    m = PhaseMetrics(log=io.StringIO(), enabled=False)
    run_pipeline(PipelineConfig(query_path=q, database_path=db, out_path=str(out),
                                align_backend="torch", log=io.StringIO(), metrics=m,
                                max_candidates=40, search_chunk_bytes=40_000, **kw))
    return m


@needs_native
def test_search_and_align_spans_of_both_schedules(tmp_path):
    q, db = _make_db(tmp_path)
    off = _run(tmp_path, "off", q, db, overlap="off")
    on = _run(tmp_path, "on", q, db, overlap="on")
    for m in (off, on):
        p = m.phases
        # the scan's split by the engine's counters sums to no more than
        # the scan, and the scan to no more than the search phase
        assert p["search.kmer"]["seconds"] + p["search.lis"]["seconds"] \
            <= p["search.scan"]["seconds"] * (1 + 1e-9)
        assert p["search.scan"]["seconds"] <= p["search"]["seconds"]
        assert p["search.scan"]["residues"] == p["search"]["db_residues"]
        assert p["search.scan"]["sequences"] == 800
        assert p["search.read"]["seconds"] <= p["search"]["seconds"]
        assert p["search.index"]["seconds"] <= p["search"]["seconds"]
        assert p["align.launch.k1"]["launches"] >= 1
        assert p["align.launch.k1"]["cells"] <= p["align.launch.k1"]["launched_cells"]
        assert p["align.traceback.native"]["pairs"] > 0
        assert p["align.evalue"]["seconds"] <= p["align"]["seconds"]
    # the final candidate sets' cells are the same in either schedule; the
    # overlap scored them all, and the candidates it evicted besides
    assert on.phases["align"]["cells"] == off.phases["align"]["cells"] > 0
    assert on.phases["align.provisional"]["cells"] >= on.phases["align"]["cells"]
    assert "align.provisional" not in off.phases
    assert on.phases["search.wait"]["seconds"] <= on.phases["search"]["seconds"]
    for k in ("pairs", "cells", "striped_cells", "scalar_cells"):
        assert on.phases["align.traceback.native"][k] == off.phases["align.traceback.native"][k]


def _subst_files(tmp_path, q, n=6, seed=3):
    """A .subst list of ``n`` substitutions for each query of ``q``."""
    rng = np.random.default_rng(seed)
    sub = tmp_path / "subst"
    sub.mkdir(exist_ok=True)
    with open(q) as fh:
        lines = fh.read().split()
    for name, seq in zip(lines[::2], lines[1::2]):
        with open(sub / (name[1:] + ".subst"), "w") as fh:
            for p in sorted(rng.choice(len(seq), n, replace=False).tolist()):
                fh.write(f"{seq[p]}{p + 1}{'ACDEFGHIKLMNPQRSTVWY'[int(rng.integers(20))]}\n")
    return str(sub)


PREDICT_SPANS = ("predict.prep", "predict.pack", "predict.fetch", "predict.finish")


@needs_native
def test_device_predict_spans_and_counters_in_subst_mode(tmp_path):
    q, db = _make_db(tmp_path)
    sub = _subst_files(tmp_path, q)
    plain = tmp_path / "plain"
    plain.mkdir()
    # metrics off: no profiler, the pipeline's own silent metrics
    run_pipeline(PipelineConfig(query_path=q, database_path=db, out_path=str(plain),
                                align_backend="torch", log=io.StringIO(), max_candidates=40,
                                search_chunk_bytes=40_000, predict_backend="device",
                                subst_path=sub))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m = _run(tmp_path, "traced", q, db, predict_backend="device", subst_path=sub)
    opened = {name for name, _, _, _ in _ranges(prof)}
    assert {RANGE_PREFIX + s for s in PREDICT_SPANS} <= opened
    p = m.phases
    for s in PREDICT_SPANS:
        assert 0 <= p[s]["seconds"] <= p["predict"]["seconds"]
    pack = p["predict.pack"]
    assert 0 < pack["cells"] <= pack["launched_cells"]
    assert pack["positions"] == sum(len(x) for x in open(q).read().split()[1::2])
    fin = p["predict.finish"]
    assert fin["positions"] == pack["positions"]
    assert 0 < fin["exact_positions"] <= fin["positions"]
    assert fin["fallback_positions"] == 0
    assert p["predict"]["host_queries"] == 0
    assert "predict.writedrain" not in p and "predict.substdrain" not in p
    names = sorted(os.listdir(plain))
    assert sum(n.endswith(".SIFTprediction") for n in names) == 3
    for name in names:
        with open(plain / name, "rb") as a, open(tmp_path / "traced" / name, "rb") as b:
            assert a.read() == b.read(), name


@needs_native
def test_finisher_counts_come_back_alike_from_threads_and_the_pool(tmp_path, monkeypatch):
    """The subst finishers' counts reach the job's thread from the writer
    threads and from a spawn pool's ``finish_subst_task`` alike; with a
    query forced to fall back whole, its positions count as exact."""
    from sift4g_tpu_torch.sift import predict_subst

    q, db = _make_db(tmp_path, n_q=2)
    sub = _subst_files(tmp_path, q)
    counts = {}
    for procs in ("0", "1"):
        monkeypatch.setenv("SIFT4G_TPU_SUBST_PROCS", procs)
        counts[procs] = _run(tmp_path, "procs" + procs, q, db, predict_backend="device",
                             subst_path=sub).phases["predict.finish"]
    keys = set(predict_subst.finish_counts(1, 0))
    assert {k: counts["0"][k] for k in keys} == {k: counts["1"][k] for k in keys}
    assert counts["0"]["exact_positions"] > 0
    # a screen margin of 0 fails every verification: every query falls back
    monkeypatch.setenv("SIFT4G_TPU_SUBST_PROCS", "0")
    monkeypatch.setattr(predict_subst, "EPS_SCREEN", 0.0)
    fell = _run(tmp_path, "fallback", q, db, predict_backend="device",
                subst_path=sub).phases["predict.finish"]
    assert fell["fallback_positions"] == fell["positions"] == counts["0"]["positions"]
    assert fell["exact_positions"] == 0


@needs_native
def test_only_the_job_thread_adds_counters(tmp_path, monkeypatch):
    """Overlapped search and align (the resolver's fetches) and device
    predict with its writer threads: every ``PhaseMetrics.add`` runs on
    the thread that made the metrics."""
    q, db = _make_db(tmp_path)
    sub = _subst_files(tmp_path, q)
    threads = []
    real = PhaseMetrics.add

    def spy(self, phase, **counters):
        threads.append((phase, threading.get_ident() == self._thread))
        return real(self, phase, **counters)

    monkeypatch.setattr(PhaseMetrics, "add", spy)
    m = _run(tmp_path, "on", q, db, overlap="on", predict_backend="device", subst_path=sub)
    assert {"align.fetch", "predict.pack", "predict.finish"} <= {ph for ph, _ in threads}
    assert [ph for ph, same in threads if not same] == []
    assert m.phases["align.fetch"]["seconds"] > 0


# ------------------------------------------------------------------ readers

class _Run:
    def __init__(self, jobs=(), card=None):
        self.jobs, self.card, self.trace, self.ref_cells = list(jobs), card, None, None


def _job(queries, status=0, **phases):
    return {"queries": queries, "latency_s": 1.0, "status": status,
            "phases": {k.replace("__", "."): v for k, v in phases.items()}}


CARD = {"sw_cells_per_s": 3717.12e9}
JOBS = [
    _job(10, search={"seconds": 2.0}, search__scan={"seconds": 1.5}, search__wait={"seconds": 0.1},
         align={"seconds": 5.0, "cells": 600.0}, align__provisional={"cells": 1000.0},
         align__traceback__native={"seconds": 4.0, "striped_thread_s": 2.0,
                                   "scalar_thread_s": 6.0, "walk_thread_s": 0.05},
         align__launch__k1={"launches": 3.0, "cells": 300.0, "launched_cells": 400.0},
         align__launch__k2={"launches": 1.0, "cells": 100.0, "launched_cells": 400.0}),
    _job(30, search={"seconds": 3.0}, search__scan={"seconds": 2.5}, search__wait={"seconds": 0.3},
         align={"seconds": 6.0, "cells": 900.0}, align__provisional={"cells": 1000.0},
         align__traceback__native={"seconds": 5.0, "striped_thread_s": 1.0,
                                   "scalar_thread_s": 3.0, "walk_thread_s": 0.01},
         align__launch__k1={"launches": 2.0, "cells": 200.0, "launched_cells": 200.0}),
    # a failed job counts nowhere
    _job(50, status=-1, search__scan={"seconds": 9.0}, align__provisional={"cells": 9.0},
         align__traceback__native={"seconds": 9.0, "scalar_thread_s": 9.0},
         align__launch__k1={"cells": 0.0, "launched_cells": 9e9}),
]


@pytest.mark.parametrize("name, want", [
    ("search_scan_ms_per_query.batch", 1e3 * 4.0 / 40),
    ("search_wait_ms_per_query.batch", 1e3 * 0.4 / 40),
    ("traceback_native_ms_per_query.batch", 1e3 * 9.0 / 40),
    ("traceback_scalar_pct.batch", 100.0 * 9.0 / 12.0),
    ("traceback_walk_pct.batch", 100.0 * 0.06 / 3.0),
    ("sw_padding_pct.batch", 100.0 * (1 - 600.0 / 1000.0)),
    ("sw_evicted_pct.batch", 100.0 * (1 - 1500.0 / 2000.0)),
])
def test_reader_of_each_new_metric(name, want):
    from benchmark.metrics import load

    read = load(name, METRICS_DIR)
    assert read(_Run(JOBS, CARD)) == pytest.approx(want)
    # no card (the CPU's traced runs): silent
    assert read(_Run(JOBS)) is None
    # a program without the spans and counters (the two-phase schedule's
    # jobs carry no provisional cells): silent, no error
    bare = [_job(10, search={"seconds": 2.0}, align={"seconds": 5.0, "cells": 600.0})]
    assert read(_Run(bare, CARD)) is None
    assert read(_Run([], CARD)) is None

"""Multi-host runs of the port (``sift4g_tpu_torch/parallel/multihost.py``)
against the JAX package, on a seeded synthetic database.

The shard and merge helpers must equal the JAX package's exactly; the
2- and 3-process runs (real ``torch.distributed`` gloo groups, one process
per simulated host, through the port's CLI and its environment variables)
must write files byte-identical to the JAX package's single-process
``run_pipeline``, the JAX package's own standard for its multi-host runs
(``tests/test_multihost.py``).  ``PipelineConfig.query_range`` must select
the same queries in both packages.  Tolerance: exact bytes throughout.
"""

import filecmp
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sift4g_tpu.parallel import multihost as jmh
from sift4g_tpu.pipeline import PipelineConfig as JaxConfig
from sift4g_tpu.pipeline import run_pipeline as jax_run_pipeline
from sift4g_tpu_torch.parallel import multihost as tmh
from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    subprocess.run(
        [sys.executable, "-m", "sift4g_tpu_torch.synthetic", str(d), "--n-db", "2000",
         "--n-q", "4", "--subst-per-query", "5", "--seed", "3"],
        check=True, capture_output=True, cwd=REPO, timeout=120,
    )
    return {"q": str(d / "queries.fa"), "d": str(d / "db.fa"), "subst": str(d), "root": d}


def _jax_single(syn, out, **kw):
    """The JAX package's single-process run (the native aligner: its own
    tests hold it byte-identical to its other backends)."""
    os.makedirs(out)
    with open(os.devnull, "w") as devnull:
        jax_run_pipeline(JaxConfig(query_path=syn["q"], database_path=syn["d"], out_path=out,
                                   align_backend="native", log=devnull, **kw))
    return out


def _outputs(path):
    # the run manifest is written by run_pipeline only (a db-sharded run
    # writes none, in both packages): compare the pipeline's outputs
    return sorted(f for f in os.listdir(path) if not f.startswith("."))


def _assert_same_outputs(want, got):
    names = _outputs(want)
    assert names and names == _outputs(got)
    assert any(n.endswith(".SIFTprediction") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(want, got, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_hosts(n, argv, timeout=90, code=None):
    """``n`` processes of one gloo group on 127.0.0.1, each running the
    port's CLI on ``argv`` (or ``python -c code``) with the multi-host
    environment of its rank.  Returns their (rc, stdout, stderr); kills
    the whole group if any outlives ``timeout``."""
    port = _free_port()
    procs = []
    for pid in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   SIFT4G_COORDINATOR=f"127.0.0.1:{port}", SIFT4G_NUM_PROCESSES=str(n),
                   SIFT4G_PROCESS_ID=str(pid))
        env.pop("SIFT4G_MULTIHOST", None)
        cmd = ([sys.executable, "-c", code] if code is not None
               else [sys.executable, "-m", "sift4g_tpu_torch", *argv])
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=REPO, start_new_session=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs


@pytest.mark.parametrize("cache", ["cache", "no-cache"])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 5])
def test_shard_record_ranges_match_jax(syn, n_hosts, cache, monkeypatch):
    if cache == "no-cache":
        monkeypatch.setenv("SIFT4G_TPU_NO_FASTA_CACHE", "1")
    got = tmh.shard_record_ranges(syn["d"], n_hosts)
    assert got == jmh.shard_record_ranges(syn["d"], n_hosts)
    assert got[0][0] == 0 and got[-1][1] == 2000
    assert all(got[h][1] == got[h + 1][0] for h in range(n_hosts - 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_candidates_matches_jax(seed):
    """Per-host (scores, ids) lists with many tied scores: the merged
    candidate sets equal the JAX package's, ids ascending."""
    rng = np.random.default_rng(seed)
    n_hosts, n_queries, k = 3, 4, 25
    per_host = []
    for h in range(n_hosts):
        lists = []
        for _ in range(n_queries):
            n = int(rng.integers(0, 40))
            ids = np.sort(rng.choice(1000, n, replace=False) + 1000 * h).astype(np.int64)
            scores = rng.integers(0, 5, n).astype(np.float32)  # ties
            lists.append((scores, ids))
        per_host.append(lists)
    got = tmh._merge_candidates(per_host, n_queries, k)
    want = jmh._merge_candidates(per_host, n_queries, k)
    assert len(got) == n_queries
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.all(np.diff(g) > 0)


_ALLGATHER = r"""
import json, os
from sift4g_tpu_torch.parallel.multihost import allgather_bytes, init_distributed_from_env
import torch.distributed as dist
ctx = init_distributed_from_env()
payload = [b"", b"x" * 70001, bytes(range(256)) * 3][ctx.process_id]
parts = allgather_bytes(payload, ctx.num_processes)
again = allgather_bytes(b"", ctx.num_processes)
print(json.dumps({"rank": ctx.process_id, "lens": [len(p) for p in parts],
                  "ok": parts == [b"", b"x" * 70001, bytes(range(256)) * 3],
                  "empty": again == [b"", b"", b""]}))
dist.destroy_process_group()
"""


def test_allgather_bytes_empty_and_unequal_payloads():
    import json

    outs = _spawn_hosts(3, [], code=_ALLGATHER)
    for rank, (_, out, _) in enumerate(outs):
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec == {"rank": rank, "lens": [0, 70001, 768], "ok": True, "empty": True}


@pytest.mark.parametrize(
    "flags, jax_kw",
    [
        (["--backend", "native", "--sub-results"], {"sub_results": True}),
        (["--backend", "torch", "--resident-db", "on", "--predict-backend", "device",
          "--subst", None, "--max-candidates", "300", "--sub-results"],
         {"subst_path": None, "max_candidates": 300, "sub_results": True}),
    ],
    ids=["native-subresults", "torch-resident-device-subst"],
)
def test_db_sharded_two_hosts_match_jax(syn, tmp_path, flags, jax_kw):
    """Two hosts, the database sharded: candidates and winners merged
    across hosts, host 0 writes everything.  The second case is the
    screened resident path with device predict on subst queries (each
    host slot-packs and holds only its shard)."""
    flags = [syn["subst"] if a is None else a for a in flags]
    jax_kw = {k: syn["subst"] if v is None else v for k, v in jax_kw.items()}
    want = _jax_single(syn, str(tmp_path / "jax"), **jax_kw)
    out = tmp_path / "mh"
    out.mkdir()
    outs = _spawn_hosts(2, ["-q", syn["q"], "-d", syn["d"], "--out", str(out), *flags])
    _assert_same_outputs(want, str(out))
    err0 = outs[0][2]
    assert "this is host 0 with database records [0, " in err0
    assert outs[1][2].count("** ") == 0  # host 1 logs to os.devnull
    if "--resident-db" in flags:
        assert "HBM-resident database" in err0


def test_query_sharded_three_hosts_match_jax(syn, tmp_path):
    """Three hosts over 4 queries (an uneven split, 1/1/2): each runs the
    single-process pipeline on its slice and writes its own files."""
    want = _jax_single(syn, str(tmp_path / "jax"), subst_path=syn["subst"])
    out = tmp_path / "mhq"
    out.mkdir()
    outs = _spawn_hosts(3, ["--backend", "native", "--mh-shard", "queries", "-q", syn["q"],
                            "-d", syn["d"], "--subst", syn["subst"], "--out", str(out)])
    _assert_same_outputs(want, str(out))
    spans = [(0, 1), (1, 2), (2, 4)]
    for pid, (lo, hi) in enumerate(spans):
        err = outs[pid][2]
        assert f"this is host {pid} with queries [{lo}, {hi}) of 4" in err
        # each host selected and predicted its slice only
        assert f"processing queries: {hi - lo}/{hi - lo} *" in err and "/4 *" not in err


def test_run_pipeline_query_range_matches_jax(syn, tmp_path):
    """``query_range`` selects the same queries, before subst validation,
    in both packages: the files of those queries only, byte-identical."""
    want = _jax_single(syn, str(tmp_path / "jax"), subst_path=syn["subst"],
                       query_range=(1, 3))
    got = tmp_path / "port"
    got.mkdir()
    with open(os.devnull, "w") as devnull:
        done = run_pipeline(PipelineConfig(query_path=syn["q"], database_path=syn["d"],
                                           subst_path=syn["subst"], out_path=str(got),
                                           align_backend="native", query_range=(1, 3),
                                           log=devnull))
    assert [q.name for q in done] == ["QUERY_1", "QUERY_2"]
    _assert_same_outputs(want, str(got))
    assert [n for n in _outputs(str(got)) if n.endswith(".SIFTprediction")] == [
        "QUERY_1.SIFTprediction", "QUERY_2.SIFTprediction"]


def test_resident_shard_layout_and_cache_key(syn, monkeypatch):
    """A shard's resident database holds only its records, at shard-local
    slots, under a cache key of its own; under ``auto`` its candidate
    bytes are counted from shard-local ids (``_resident_refusal`` with a
    CUDA device injected, as ``tests/test_torch_resident.py`` does)."""
    from types import SimpleNamespace

    from sift4g_tpu_torch import pipeline as tpipe
    from sift4g_tpu_torch.align import resident as tres
    from sift4g_tpu_torch.io.fasta import CachedFastaStream, FastaStream

    (_, _), (lo, hi) = tmh.shard_record_ranges(syn["d"], 2)
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    tres.drop_resident_db()
    try:
        with FastaStream(syn["d"], record_range=(lo, hi)) as fs:
            assert isinstance(fs, CachedFastaStream)
            full, shard = fs._offsets, fs._offsets[lo : hi + 1]
            assert tres._resident_key(fs._codes, full, cpu) != tres._resident_key(
                fs._codes, shard, cpu)
            al = SimpleNamespace(devices=[cpu], backend="torch")
            with open(os.devnull, "w") as devnull:
                rdb = tpipe._maybe_resident_db(fs, [np.arange(lo, hi)], al, "on", devnull,
                                               (lo, hi))
            assert rdb.slot_off.shape[0] == hi - lo
            assert rdb.nbytes == tres.ResidentDB.slotted_size(shard)
            assert tres.resident_db_cached(fs._codes, shard, cpu)
            assert not tres.resident_db_cached(fs._codes, full, cpu)
            ids = np.array([lo, lo + 1, hi - 1], dtype=np.int64)
            lens = (full[ids + 1] - full[ids]).astype(np.int32)
            t = rdb.packed_targets(ids - lo, lens)
            for k, i in enumerate(ids):
                got = t.codes[t.starts[k] : t.starts[k] + t.lens[k]]
                assert np.array_equal(got, fs.codes_at(int(i)))

            tres.drop_resident_db()
            monkeypatch.setattr(tpipe, "_resident_budget", lambda dev: 1 << 40)
            slotted = tres.ResidentDB.slotted_size(shard)
            ix = np.arange(lo, hi)
            shard_bytes = int((shard[ix - lo + 1] - shard[ix - lo]).sum())
            copies = slotted // shard_bytes + 1   # just above the shard's slotted size
            assert tpipe._resident_refusal("auto", cuda, fs, [ix] * copies, (lo, hi)) is None
            assert "candidate bytes" in tpipe._resident_refusal(
                "auto", cuda, fs, [ix] * (copies - 1), (lo, hi))
    finally:
        tres.drop_resident_db()

"""The port's serve daemon (``sift4g_tpu_torch/serve.py``) against the JAX
package, on a seeded synthetic database.

``_serve_one`` is driven in-process over a socket pair (the frame
protocol, job counters, per-job environment isolation, bad requests,
failing jobs, and the resident database kept across jobs); ``_SocketLog``
and ``_strip_flag`` alone; and a daemon subprocess through the port's
``--serve``/``--connect``/``--shutdown`` entry points, whose job outputs
must be byte-identical to the JAX package's ``run_pipeline`` on the same
inputs.  Tolerance: exact bytes.
"""

import filecmp
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from sift4g_tpu import serve as jserve
from sift4g_tpu.pipeline import PipelineConfig as JaxConfig
from sift4g_tpu.pipeline import run_pipeline as jax_run_pipeline
from sift4g_tpu_torch import cli as tcli
from sift4g_tpu_torch import serve as tserve

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    subprocess.run(
        [sys.executable, "-m", "sift4g_tpu_torch.synthetic", str(d), "--n-db", "300",
         "--n-q", "2", "--subst-per-query", "3", "--seed", "5"],
        check=True, capture_output=True, cwd=REPO, timeout=120,
    )
    ref = d / "jax"
    ref.mkdir()
    with open(os.devnull, "w") as devnull:
        jax_run_pipeline(JaxConfig(query_path=str(d / "queries.fa"),
                                   database_path=str(d / "db.fa"), subst_path=str(d),
                                   out_path=str(ref), align_backend="native", log=devnull))
    return {"q": str(d / "queries.fa"), "d": str(d / "db.fa"), "subst": str(d), "ref": str(ref)}


def _job(syn, out, *extra):
    return ["-q", syn["q"], "-d", syn["d"], "--subst", syn["subst"], "--out", str(out), *extra]


def _assert_same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert any(n.endswith(".SIFTprediction") for n in names)
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


class _Pair:
    """A daemon-side connection and a client reading its frames on a
    thread (so a long log never fills the socket buffer)."""

    def __init__(self, request: bytes):
        self.daemon_end, self._client = socket.socketpair()
        self._client.sendall(request)
        self.frames = []
        self._reader = threading.Thread(target=self._read)
        self._reader.start()

    def _read(self):
        with self._client.makefile("rb") as f:
            for line in f:
                self.frames.append(json.loads(line))

    def finish(self):
        self.daemon_end.close()
        self._reader.join(timeout=60)
        assert not self._reader.is_alive()
        self._client.close()
        return self.frames


def _serve(request: bytes, jobs: int, fallback=None):
    pair = _Pair(request)
    jobs, shutdown = tserve._serve_one(pair.daemon_end, jobs, fallback or io.StringIO())
    return jobs, shutdown, pair.finish()


def _argv_request(argv) -> bytes:
    return json.dumps({"argv": argv}).encode() + b"\n"


def test_serve_one_jobs_frames_and_env_isolation(syn, tmp_path, monkeypatch):
    monkeypatch.delenv("SIFT4G_TPU_CACHE_DIR", raising=False)
    cache = tmp_path / "cache1"
    outs = [tmp_path / "o1", tmp_path / "o2"]
    for o in outs:
        o.mkdir()
    jobs, shutdown, frames = _serve(
        _argv_request(_job(syn, outs[0], "--backend", "native", "--cache-dir", str(cache))), 0)
    assert (jobs, shutdown) == (1, False)
    # log frames first, then exactly one status frame, last
    assert all(set(f) == {"log"} for f in frames[:-1]) and len(frames) >= 3
    assert frames[-1]["status"] == 0 and frames[-1]["job"] == 1
    assert frames[-1]["elapsed_s"] >= 0
    log = "".join(f["log"] for f in frames[:-1])
    assert "SIFT predictions" in log
    assert [f for f in os.listdir(cache) if f.endswith(".s4gc")]
    # job 1's --cache-dir did not leak into the daemon's environment
    assert "SIFT4G_TPU_CACHE_DIR" not in os.environ
    monkeypatch.setenv("SIFT4G_TPU_CACHE_DIR", str(tmp_path / "cache2"))
    jobs, _, frames = _serve(
        _argv_request(_job(syn, outs[1], "--backend", "native", "--connect", "x.sock",
                           "--shutdown")), jobs)
    assert jobs == 2 and frames[-1]["status"] == 0 and frames[-1]["job"] == 2
    assert os.environ["SIFT4G_TPU_CACHE_DIR"] == str(tmp_path / "cache2")
    for o in outs:
        _assert_same_tree(syn["ref"], str(o))


def test_serve_one_bad_request_failing_job_and_shutdown(syn, tmp_path, monkeypatch):
    jobs, shutdown, frames = _serve(b"this is not json\n", 4)
    assert (jobs, shutdown) == (4, False)
    assert frames == [{"status": -1, "error": "bad request"}]

    def boom(argv=None, metrics=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(tcli, "main", boom)
    jobs, shutdown, frames = _serve(_argv_request(["-q", "x"]), jobs)
    assert (jobs, shutdown) == (5, False)
    assert frames[-1]["status"] == -1 and frames[-1]["job"] == 5
    assert "error: boom" in "".join(f.get("log", "") for f in frames)
    monkeypatch.undo()
    # the daemon goes on: a job that fails validation, then a good one
    jobs, _, frames = _serve(_argv_request(_job(syn, tmp_path, "--kmer-length", "7")), jobs)
    assert frames[-1]["status"] == -1 and "kmer_length possible values" in frames[0]["log"]
    out = tmp_path / "o"
    out.mkdir()
    jobs, _, frames = _serve(_argv_request(_job(syn, out, "--backend", "native")), jobs)
    assert jobs == 7 and frames[-1]["status"] == 0
    _assert_same_tree(syn["ref"], str(out))
    jobs, shutdown, frames = _serve(json.dumps({"shutdown": True}).encode() + b"\n", jobs)
    assert (jobs, shutdown) == (7, True) and frames == [{"status": 0, "job": 7}]


def test_serve_one_keeps_the_resident_database(syn, tmp_path):
    """Two ``--backend torch --resident-db on`` jobs: the second reuses
    the first job's ResidentDB object (no second pack or upload)."""
    from sift4g_tpu_torch.align import resident

    resident.drop_resident_db()
    seen, jobs = [], 0
    for k in range(2):
        out = tmp_path / f"o{k}"
        out.mkdir()
        jobs, _, frames = _serve(
            _argv_request(_job(syn, out, "--backend", "torch", "--resident-db", "on")), jobs)
        assert frames[-1]["status"] == 0, "".join(f.get("log", "") for f in frames)
        assert "HBM-resident database" in "".join(f.get("log", "") for f in frames)
        seen.append(resident._RESIDENT_CACHE["db"])
        _assert_same_tree(syn["ref"], str(out))
    assert seen[0] is seen[1]
    resident.drop_resident_db()


class _Sink:
    def __init__(self, fail=False):
        self.data, self.fail = [], fail

    def write(self, b):
        if self.fail:
            raise BrokenPipeError("client gone")
        self.data.append(b)

    def flush(self):
        pass


def test_socket_log_flushes_and_falls_back():
    sink, fallback = _Sink(), io.StringIO()
    log = tserve._SocketLog(sink, fallback)
    assert log.isatty() is False and log.writable()
    assert isinstance(log, io.TextIOBase)
    assert log.write("") == 0 and not sink.data
    log.write("partial")
    assert not sink.data  # buffered until a line end
    log.write(" meter\r")
    log.write("banner\n")
    log.write("y" * 4097)  # a raw write above 4096 characters
    frames = [json.loads(b) for b in sink.data]
    assert frames == [{"log": "partial meter\r"}, {"log": "banner\n"}, {"log": "y" * 4097}]
    print("via print", file=log)
    assert json.loads(sink.data[-1]) == {"log": "via print\n"}
    assert fallback.getvalue() == ""

    dead = tserve._SocketLog(_Sink(fail=True), fallback)
    dead.write("lost line\n")
    assert dead.dead
    dead.write("after\n")
    assert fallback.getvalue() == ("* client connection lost; job continues, log follows *\n"
                                   "lost line\nafter\n")


@pytest.mark.parametrize(
    "argv, flag, has_value",
    [
        (["-q", "a", "--connect", "s.sock", "-d", "b"], "--connect", True),
        (["--connect=s.sock", "-q", "a"], "--connect", True),
        (["-q", "a", "--connect"], "--connect", True),
        (["--serve", "x", "--serve=y", "--out", "o"], "--serve", True),
        (["--shutdown", "-q", "a", "--shutdown"], "--shutdown", False),
        (["--shutdown=1", "-q", "a"], "--shutdown", False),
        (["--connected", "x", "-q"], "--connect", True),
        ([], "--serve", True),
    ],
)
def test_strip_flag_matches_jax(argv, flag, has_value):
    assert tserve._strip_flag(argv, flag, has_value) == jserve._strip_flag(argv, flag, has_value)


def _wait_socket(path, proc, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        assert proc.poll() is None, proc.stderr.read()
        if os.path.exists(path):
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                try:
                    c.connect(path)
                    return
                except OSError:
                    pass
        time.sleep(0.1)
    raise AssertionError("the daemon's socket never came up")


def _port(*argv, **kw):
    return subprocess.run([sys.executable, "-m", "sift4g_tpu_torch", *argv], capture_output=True,
                          text=True, cwd=REPO, timeout=60, env=_ENV, **kw)


_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def test_daemon_subprocess_connect_disconnect_shutdown(syn, tmp_path):
    """``--serve`` in a subprocess: a client killed mid-job leaves the job
    running to its files; the next ``--connect`` job is served (job 2);
    ``--connect --shutdown`` stops the daemon and removes the socket.
    Both jobs' files are byte-identical to the JAX package's."""
    sock = str(tmp_path / "d.sock")
    daemon = subprocess.Popen([sys.executable, "-m", "sift4g_tpu_torch", "--serve", sock],
                              stderr=subprocess.PIPE, text=True, cwd=REPO, env=_ENV,
                              start_new_session=True)
    client = None
    try:
        _wait_socket(sock, daemon)
        out1, out2 = tmp_path / "o1", tmp_path / "o2"
        out1.mkdir()
        out2.mkdir()
        client = subprocess.Popen(
            [sys.executable, "-m", "sift4g_tpu_torch", "--connect", sock, "--backend", "native",
             *_job(syn, out1)],
            stderr=subprocess.PIPE, text=True, cwd=REPO, env=_ENV, start_new_session=True)
        assert client.stderr.readline()  # the first relayed frame: the job runs
        os.killpg(client.pid, signal.SIGKILL)
        client.wait(timeout=10)

        res = _port("--connect", sock, "--backend", "native", *_job(syn, out2))
        assert res.returncode == 0, res.stderr
        assert "** job 2 done in " in res.stderr and "(status 0) **" in res.stderr
        assert "SIFT predictions" in res.stderr  # the job's log, relayed
        for out in (out1, out2):
            _assert_same_tree(syn["ref"], str(out))

        res = _port("--connect", sock, "--shutdown")
        assert res.returncode == 0, res.stderr
        assert daemon.wait(timeout=30) == 0
        assert not os.path.exists(sock)
    finally:
        for p in (client, daemon):
            if p is not None and p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

"""Daemon mode: keep the card warm across CLI invocations.

``sift4g-tpu-torch --serve SOCKET`` starts one long-lived process that
runs pipeline jobs submitted over a UNIX domain socket;
``sift4g-tpu-torch --connect SOCKET <normal flags>`` ships an invocation
to it.  What stays warm between jobs is what a fresh process pays for
again: the CUDA context, the loaded kernels and native library, and the
resident database (``align/resident.py`` keeps its upload in a one-entry
cache, and ``--resident-db auto`` reuses a live upload whatever the
job's candidate volume, ``pipeline._resident_refusal``).

Protocol (the JAX package's, ``sift4g_tpu/serve.py``): the client sends
one JSON line, {"argv": [...]} or {"shutdown": true}; the daemon answers
with a stream of JSON lines: zero or more {"log": "..."} frames carrying
the job's stderr as it is written (progress meters included, the
reference's carriage-return meters, utils.cpp:52-61), then one final
{"status": int, "job": int, "elapsed_s": float}.  Jobs run one at a
time; their output files are written by the daemon to the job's --out
directory.  Text that the native C++ library writes to file descriptor 2
goes to the daemon's own stderr, not to the client, as in the JAX
package.

Robustness: every socket write is guarded.  A client that dies or stops
reading mid-job flips the connection to drop mode, the job runs to
completion (its files are the product; the log goes to the daemon's own
stderr), and the daemon serves the next connection.  A job's error never
ends the daemon; a CUDA error that leaves the context unusable fails
every later job too, and each says so in its status and log.

Changes from the JAX module: ``serve_forever`` takes no platform (each
job picks its devices with its own --backend and --cards), the flags
stripped from a job are --serve, --connect and --shutdown, and
``_SocketLog`` is an ``io.TextIOBase`` whose ``isatty()`` is False
(PyTorch writes warnings to ``sys.stderr`` during jobs, and asks it).
"""

from __future__ import annotations

import io
import json
import os
import socket
import sys
import time

# per-connection socket timeout: bounds how long a write to a wedged
# (alive but not reading) client can stall the job's log flush before
# the connection is declared dead; also bounds the initial request read
_CONN_TIMEOUT_S = 30.0


class _SocketLog(io.TextIOBase):
    """stderr stand-in that streams chunks to the client as {"log": ...}
    frames.  A failed write (dead or wedged client) flips it to drop mode
    for good: the job must never die on the client's account; later text
    goes to ``fallback`` (the daemon's own stderr)."""

    def __init__(self, sock_file, fallback):
        super().__init__()
        self._f = sock_file
        self._fallback = fallback
        self.dead = False
        self._buf = []
        self._buffered = 0

    def isatty(self) -> bool:
        return False

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        if not s:
            return 0
        self._buf.append(s)
        self._buffered += len(s)
        # meters end in \r, phase banners in \n: flush on either so the
        # client renders progress live; cap buffering for raw writes
        if "\n" in s or "\r" in s or self._buffered > 4096:
            self.flush()
        return len(s)

    def flush(self) -> None:
        if not self._buf:
            return
        chunk = "".join(self._buf)
        self._buf.clear()
        self._buffered = 0
        if self.dead:
            self._fallback.write(chunk)
            self._fallback.flush()
            return
        try:
            self._f.write(json.dumps({"log": chunk}).encode() + b"\n")
            self._f.flush()
        except (OSError, ValueError):  # dead client / closed file
            self.dead = True
            self._fallback.write("* client connection lost; job continues, log follows *\n")
            self._fallback.write(chunk)
            self._fallback.flush()


def _strip_flag(argv, flag, has_value=True):
    out, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == flag:
            i += 2 if has_value else 1
            continue
        if has_value and a.startswith(flag + "="):
            i += 1
            continue
        out.append(a)
        i += 1
    return out


def _serve_one(conn, jobs: int, real_stderr) -> "tuple[int, bool]":
    """Handle one connection.  Returns (jobs, shutdown_requested).
    Raises nothing: every socket error is contained here."""
    from . import cli

    conn.settimeout(_CONN_TIMEOUT_S)
    f = conn.makefile("rwb")

    def _reply(obj) -> None:
        try:
            f.write(json.dumps(obj).encode() + b"\n")
            f.flush()
        except (OSError, ValueError):
            pass  # dead client: the reply has nowhere to go

    try:
        line = f.readline()
    except OSError:
        return jobs, False
    if not line:
        return jobs, False
    try:
        req = json.loads(line)
    except ValueError:
        _reply({"status": -1, "error": "bad request"})
        return jobs, False
    if req.get("shutdown"):
        _reply({"status": 0, "job": jobs})
        return jobs, True

    argv = req.get("argv", [])
    # a job must not start another daemon or client
    argv = _strip_flag(argv, "--serve")
    argv = _strip_flag(argv, "--connect")
    argv = _strip_flag(argv, "--shutdown", has_value=False)
    jobs += 1
    t0 = time.perf_counter()
    log = _SocketLog(f, real_stderr)
    old_stderr, sys.stderr = sys.stderr, log
    # per-job env isolation: --cache-dir exports SIFT4G_TPU_CACHE_DIR for
    # the pipeline; one job's export must not change the next job (the
    # same argv behaves the same one-shot and under the daemon)
    _job_env = ("SIFT4G_TPU_CACHE_DIR",)
    env_before = {k: os.environ.get(k) for k in _job_env}
    try:
        status = cli.main(argv)
    except SystemExit as exc:
        status = int(exc.code or 0)
    except Exception as exc:  # a job's error must not end the daemon
        print(f"error: {exc}", file=log)
        status = -1
    finally:
        sys.stderr = old_stderr
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        try:
            log.flush()
        except Exception:
            pass
    _reply({
        "status": status,
        "job": jobs,
        "elapsed_s": round(time.perf_counter() - t0, 3),
    })
    return jobs, False


def serve_forever(socket_path: str) -> int:
    """Run the job loop until a shutdown request or SIGINT.  Returns the
    exit status."""
    # jobs can tell they run in the daemon
    os.environ["SIFT4G_TPU_IN_DAEMON"] = "1"

    if os.path.exists(socket_path):
        os.unlink(socket_path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    srv.listen(8)
    print(f"** sift4g-tpu-torch daemon listening on {socket_path} **", file=sys.stderr)

    jobs = 0
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    jobs, shutdown = _serve_one(conn, jobs, sys.stderr)
                except OSError:
                    continue  # connection-level failure: next client
            if shutdown:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        srv.close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)


def submit(socket_path: str, argv, shutdown: bool = False) -> int:
    """Ship one invocation to the daemon; relay its streamed log frames
    live to stderr; return the job's exit status."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        c.connect(socket_path)
    except OSError as exc:
        print(f"error: cannot reach daemon at '{socket_path}': {exc}", file=sys.stderr)
        c.close()
        return -1
    reply = None
    with c:
        f = c.makefile("rwb")
        req = {"argv": list(argv)}
        if shutdown:
            req["shutdown"] = True
        f.write(json.dumps(req).encode() + b"\n")
        f.flush()
        for line in f:
            try:
                msg = json.loads(line)
            except ValueError:
                # a truncated frame (daemon killed mid-write): a severed
                # stream, not a client traceback
                break
            if "status" in msg:
                reply = msg
                break
            if "log" in msg:  # the job's stderr, as it is written
                sys.stderr.write(msg["log"])
                sys.stderr.flush()
    if reply is None:
        print("error: daemon closed the connection", file=sys.stderr)
        return -1
    if not shutdown:
        print(
            f"** job {reply.get('job')} done in {reply.get('elapsed_s')}s "
            f"(status {reply.get('status')}) **",
            file=sys.stderr,
        )
    return int(reply.get("status", -1))

"""Build the CUDA sources under ``sift4g_tpu_torch/csrc`` and load them.

The kernels have a plain C interface, so they compile with ``nvcc`` alone
(no PyTorch headers: seconds instead of minutes) into one shared library
that ctypes loads.  The library lands in ``sift4g_tpu_torch/_build/``,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None
build_seconds = 0.0   # wall time of the build this process ran (0 if cached)
build_log = ""        # nvcc's output of that build (-Xptxas -v included)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libsift4g_torch_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sift4g_sw_grouped.restype = i32
    lib.sift4g_sw_grouped.argtypes = [
        vp, i32, vp, vp,          # q_all, qm, q_off, q_len
        vp, vp, vp,               # targets, lens, matrix32
        i32, i32, i32,            # G, B, N
        i32, i32, i32,            # mode, go, ge
        vp, vp, vp,               # scratch, out, stream
    ]
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            _lib = _bind(ctypes.CDLL(path))
        return _lib

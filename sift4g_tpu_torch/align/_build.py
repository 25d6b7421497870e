"""Build the CUDA sources under ``sift4g_tpu_torch/csrc`` and load them.

The kernels have a plain C interface, so they compile with ``nvcc`` alone
(no PyTorch headers: seconds instead of minutes): one ``nvcc -c`` per
``.cu`` file, all started together, then one link into a shared library
that ctypes loads.  The library lands in ``sift4g_tpu_torch/_build/``,
named by a hash of the sources (headers included) and flags, so an edited
source rebuilds and an unchanged one loads at once.  A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import threading
import time

from ..native import run_parallel

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    for src in sorted(_sources() + glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libsift4g_torch_{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in _sources()]
    t0 = time.perf_counter()
    try:
        logs = run_parallel([
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src]
            for src, obj in zip(_sources(), objs)
        ], "nvcc")
        logs += run_parallel([[nvcc, *NVCC_FLAGS, "-shared", "-o", tag, *objs]], "nvcc")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    os.replace(tag, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sift4g_sw_grouped.restype = i32
    lib.sift4g_sw_grouped.argtypes = [
        vp, i32, vp, vp,          # q_all, qm, q_off, q_len
        vp, vp, vp,               # targets, lens, matrix32
        i32, i32, i32,            # G, B, N
        i32, i32, i32, i32,       # mode, go, ge, acc
        i32, i32,                 # threads per target, block
        vp, vp, vp,               # scratch, out, stream
    ]
    lib.sift4g_sw_grouped_resident.restype = i32
    lib.sift4g_sw_grouped_resident.argtypes = [
        vp, i32, vp, vp,          # q_all, qm, q_off, q_len
        vp, ctypes.c_int64, vp,   # db, db_len, starts
        vp, vp,                   # lens, matrix32
        i32, i32, i32,            # G, B, N
        i32, i32, i32,            # mode, go, ge
        i32, i32,                 # threads per target, block
        vp, vp, vp,               # scratch, out, stream
    ]
    lib.sift4g_sw_single.restype = i32
    lib.sift4g_sw_single.argtypes = [
        vp, i32, vp,              # q, qm, qlen
        vp, vp, vp,               # targets, lens, matrix32
        i32, i32,                 # B, N
        i32, i32, i32,            # mode, go, ge
        i32, i32,                 # threads per target, block
        vp, vp, vp,               # scratch, out, stream
    ]
    lib.sift4g_sw_grouped_long.restype = i32
    lib.sift4g_sw_grouped_long.argtypes = [
        vp, i32, vp, vp,          # q_all, qm, q_off, q_len
        vp, vp, vp,               # targets, lens, matrix32
        i32, i32, i32,            # G, B, N
        i32, i32, i32,            # mode, go, ge
        i32, i32,                 # warps a block, blocks a cluster (one cluster a target)
        vp, vp, vp,               # scratch, out, stream
    ]
    lib.sift4g_sw_long_scratch_bytes.restype = ctypes.c_longlong
    # G, B, N, warps, cluster
    lib.sift4g_sw_long_scratch_bytes.argtypes = [i32, i32, i32, i32, i32]
    lib.sift4g_dp_row_probe.restype = i32
    lib.sift4g_dp_row_probe.argtypes = [
        i32, i32, i32, i32,       # B, N, M, salt
        i32, i32,                 # go, ge
        i32, i32, i32,            # lanes a row, strips, block
        vp, vp, vp,               # scratch, out, stream
    ]
    lib.sift4g_dp_row_scratch_bytes.restype = ctypes.c_longlong
    lib.sift4g_dp_row_scratch_bytes.argtypes = [i32, i32]   # B, strips
    for probe in (lib.sift4g_int32_probe, lib.sift4g_s16x2_probe):
        probe.restype = i32
        probe.argtypes = [
            i32, i32, i32, i32,   # B, N, M, salt
            i32,                  # pairs
            vp, vp,               # out, stream
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

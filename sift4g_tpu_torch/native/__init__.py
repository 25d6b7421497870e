"""ctypes bindings for the port's native host library.

The C++ sources beside this file (FASTA streaming, the k-mer/LIS/top-k
search engine, the threaded traceback aligner, slab and slot packing,
selection and the median/weights helpers) are the port's own copies of
``sift4g_tpu/native``; callers use :func:`load` as they did there.

The library is built with ``g++`` on first use into
``sift4g_tpu_torch/_build/`` (one compiler per source, started together,
then one link), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  A missing
compiler or a failed build raises; nothing falls back to another build.
``SIFT4G_TPU_NO_NATIVE=1`` still asks for the pure-Python fallbacks
(``load`` returns None).

Dropped from the JAX package's loader: the ``make`` build into the source
directory and the "stale .so tolerance" ``hasattr`` guards (this library is
always built from the sources it is bound to).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-Wall", "-Wextra", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

c_i64 = ctypes.c_int64
c_i32 = ctypes.c_int32
c_u8_p = ctypes.POINTER(ctypes.c_uint8)
c_i64_p = ctypes.POINTER(ctypes.c_int64)
c_i32_p = ctypes.POINTER(ctypes.c_int32)
c_f64_p = ctypes.POINTER(ctypes.c_double)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sift4g_search_create.restype = ctypes.c_void_p
    lib.sift4g_search_create.argtypes = [
        c_i32, c_i32, c_i32, c_i32_p, c_i64, c_i32_p, c_i32_p, c_i64, c_i32,
    ]
    lib.sift4g_search_chunk.restype = ctypes.c_uint64
    lib.sift4g_search_chunk.argtypes = [
        ctypes.c_void_p, c_u8_p, c_i64_p, c_i64, c_i64,
    ]
    lib.sift4g_search_counts.restype = None
    lib.sift4g_search_counts.argtypes = [ctypes.c_void_p, c_i64_p]
    lib.sift4g_search_collect.restype = None
    lib.sift4g_search_collect.argtypes = [ctypes.c_void_p, c_i64_p]
    lib.sift4g_search_destroy.restype = None
    lib.sift4g_search_destroy.argtypes = [ctypes.c_void_p]
    lib.sift4g_search_collect_scored.restype = None
    lib.sift4g_search_collect_scored.argtypes = [
        ctypes.c_void_p, c_i64_p, ctypes.POINTER(ctypes.c_float),
    ]
    lib.sift4g_hash_count.restype = c_i64
    lib.sift4g_hash_count.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), c_i64_p, c_i64, ctypes.c_int,
        c_i32_p, c_i64,
    ]
    lib.sift4g_hash_fill.restype = None
    lib.sift4g_hash_fill.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), c_i64_p, c_i64, ctypes.c_int,
        c_i32_p, c_i64, c_i32_p, c_i32_p,
    ]
    lib.sift4g_search_stats.restype = None
    lib.sift4g_search_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
    ]

    lib.sift4g_fasta_open.restype = ctypes.c_void_p
    lib.sift4g_fasta_open.argtypes = [ctypes.c_char_p]
    lib.sift4g_fasta_read_part.restype = ctypes.c_int
    lib.sift4g_fasta_read_part.argtypes = [ctypes.c_void_p, c_i64]
    for fn in ("part_nseq", "part_residues", "part_names_bytes"):
        f = getattr(lib, f"sift4g_fasta_{fn}")
        f.restype = c_i64
        f.argtypes = [ctypes.c_void_p]
    lib.sift4g_fasta_part_fill.restype = None
    lib.sift4g_fasta_part_fill.argtypes = [
        ctypes.c_void_p, c_u8_p, c_i64_p, ctypes.c_char_p, c_i64_p,
    ]
    lib.sift4g_fasta_close.restype = None
    lib.sift4g_fasta_close.argtypes = [ctypes.c_void_p]

    lib.sift4g_pack_group.restype = None
    lib.sift4g_pack_group.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), c_i32_p, c_i32, c_i64,
        ctypes.POINTER(ctypes.c_int8), c_i32_p,
    ]
    lib.sift4g_slot_pack.restype = None
    lib.sift4g_slot_pack.argtypes = [
        c_u8_p, c_i64_p, c_i64, c_u8_p, c_i64_p, c_i64,
    ]

    lib.sift4g_align_batch.restype = ctypes.c_int
    lib.sift4g_align_batch.argtypes = [
        c_u8_p, c_i32, c_u8_p, c_i64_p, c_i32,   # q, qlen, targets, offsets, n
        c_i32_p, c_i32, c_i32, c_i32, c_i32,      # matrix26, go, ge, mode, threads
        c_i32_p, c_i32_p, c_i32_p, c_i32_p, c_i32_p,  # score, qs, qe, ts, te
        c_u8_p, c_i64, c_i64_p,                   # moves_buf, cap, moves_off
        c_f64_p,                                  # stats (ALIGN_STATS) or null
    ]
    lib.sift4g_score_batch.restype = None
    lib.sift4g_score_batch.argtypes = [
        c_u8_p, c_i32, c_u8_p,                   # q, qlen, codes base
        c_i64_p, c_i32_p, c_i32,                 # starts, lens, n
        c_i32_p, c_i32, c_i32, c_i32, c_i32,     # matrix26, go, ge, mode, threads
        c_i32_p,                                 # out scores
    ]

    lib.sift4g_select.restype = c_i64
    lib.sift4g_select.argtypes = [
        c_u8_p, c_i64, c_i64,                    # rows, n, L
        ctypes.POINTER(ctypes.c_float), c_i64,   # xlogx table, size
        ctypes.c_float, ctypes.c_double,         # threshold, kLog_2_20
    ]
    _extract_sig = [
        c_u8_p, c_i64_p,                         # moves, move offsets (n+1)
        c_i64_p, c_i64_p,                        # query/target starts
        c_u8_p, c_i64_p,                         # tcodes, tcode offsets (n+1)
        c_i64, c_i64, c_u8_p,                    # n, L, rows out (X-filled)
    ]
    lib.sift4g_extract.restype = None
    lib.sift4g_extract.argtypes = _extract_sig
    lib.sift4g_basic_matrix.restype = c_i64
    lib.sift4g_basic_matrix.argtypes = [
        c_u8_p, c_i64_p, c_i64, c_i64,           # rows, keep, m, L
        ctypes.POINTER(ctypes.c_double), c_u8_p,  # aa_freq, valid mask
        ctypes.POINTER(ctypes.c_double),          # out (L, 26)
    ]
    lib.sift4g_seq_weights.restype = c_i64
    lib.sift4g_seq_weights.argtypes = [
        c_u8_p, c_i64, c_i64, c_u8_p,             # rows, n, L, valid
        ctypes.POINTER(ctypes.c_double),          # out w (n,)
        ctypes.POINTER(ctypes.c_double),          # out ndiff (L,)
    ]
    # returns -1 or the first corrupt record's index (callers raise)
    lib.sift4g_extract_checked.restype = c_i64
    lib.sift4g_extract_checked.argtypes = _extract_sig
    return lib


def run_parallel(cmds, what: str):
    """Run the commands at once and wait for all of them; the output of
    each, or RuntimeError naming the first that failed.  Also builds the
    port's CUDA kernels (``align/_build.py``)."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    logs = [proc.communicate()[0] for _, proc in procs]
    for (cmd, proc), log in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
    return logs


def _sources():
    return sorted(glob.glob(os.path.join(_DIR, "*.cpp")) + glob.glob(os.path.join(_DIR, "*.h")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libsift4g_native_{h.hexdigest()[:16]}.so")


def build(out: str) -> None:
    """Compile the sources into ``out``; raises when that fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's native host library needs a C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    srcs = [s for s in _sources() if s.endswith(".cpp")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    try:
        run_parallel([[cxx, *CXX_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)],
                     "native build")
        run_parallel([[cxx, *CXX_FLAGS, "-shared", "-o", tmp, *objs]], "native build")
    finally:
        for o in objs:
            if os.path.exists(o):
                os.unlink(o)
    os.replace(tmp, out)


def load() -> Optional[ctypes.CDLL]:
    """The bound native library, built on first use.

    Returns None only when ``SIFT4G_TPU_NO_NATIVE`` asks for the
    pure-Python fallbacks."""
    global _lib
    if os.environ.get("SIFT4G_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _lib = _bind(ctypes.CDLL(path))
        return _lib

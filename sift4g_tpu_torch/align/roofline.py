"""The bench's probes of the card: the row engine (K5) and int32 throughput (K6).

``dp_row_probe`` (K5) is the port of the kernel in
``sift4g_tpu/align/roofline.py:dp_row_roofline``: B rows, each the same
M-row local-alignment recurrence over N columns with salted column
scores, and each row's best cell as the (B,) int32 result.  Its kernel
holds a row's columns in the registers of T lanes and streams the query
rows through them as a wavefront; ``dp_row_geometry`` picks T and the
block from the launch's shape.
``int32_probe`` (K6) is the port of the kernels in ``tools/bench_ab.py``
``run_roofline`` (``pairs=1``) and ``run_roofline_ilp``: M rounds of
``(a, b) = (max(a + 1, b), max(b - 1, a))`` on ``pairs`` (B, N) int32
pairs, and each row's maximum; ``packed=True`` runs the same update on
int16 pairs, two elements a register (the packed DPX forms of K1's int16
accumulator; no TPU counterpart).  Both wrappers dispatch on the device:
the CPU runs the plain PyTorch versions, a CUDA device the kernels in
``csrc/dp_row_roofline.cu`` and ``csrc/int32_roofline.cu``, built on first
use.  A CUDA call launches the kernel or raises; nothing falls back.

``dp_row_roofline`` and ``int32_roofline`` keep the JAX timing protocol
(``roofline.py:103-114``, ``bench_ab.py:132-145``): a new salt on every
call, the best of ``iters`` calls at ``lo`` and at ``hi`` rounds, and the
rate from the difference, so the launch cost and any fixed prologue
cancel.  Each call is timed with CUDA events.  They measure the card and
refuse any other device.

Counters (plain integers a run reads to show which path it took):
``dp_row_launches`` counts K5 launches made here, ``int32_launches`` K6
launches.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import time
from collections import Counter
from functools import lru_cache

import torch

from . import _build

NEGL = -(10 ** 7)            # roofline.py: F on the top row, the shifted-in value
MAX_DP_ROW_N = 6144          # the widest row K5 takes: 12 strips of 512 columns
DP_ROW_COLS = 16             # columns a lane holds (kCols of csrc/dp_row_roofline.cu)
DP_ROW_MAX_BLOCK = 128        # the largest block (kMaxBlock)
MAX_ARG = 1 << 20            # |salt|, go, ge: keeps every value inside int32
MAX_ROUNDS = 1 << 28
INT32_PAIRS = (1, 2, 4)

# the documented int32 add/sub/min/max rate of compute capability 9.0
INT32_RESULTS_PER_SM_CLOCK = 64
INT32_RATE_SOURCE = (
    "CUDA C++ Programming Guide, throughput of native arithmetic instructions, "
    "compute capability 9.0: 64 results per clock per SM for 32-bit integer "
    "add, subtract, minimum and maximum"
)
# operations counted per fused instruction: nvcc fuses max(x + c, y) into
# one VIADDMNMX on sm_90a, which does the add and the max
OPS_PER_FUSED_INSTRUCTION = 2
# max-family instructions (VIMNMX, VIMNMX3, VIADDMNMX) one DP cell needs
# on sm_90a: F, G (its zero floor fused), E, H and, in SW mode, the
# running best, which the three-input VIMNMX3 takes two cells at a time.
# The cell's adds fuse into them or issue beside them on another pipe (on
# an H100, K5 issues 90 int32 instructions a clock per SM, 60 of them
# max-family), so these at INT32_RESULTS_PER_SM_CLOCK bound the cell.
MAX_INSTRUCTIONS_PER_CELL = {"SW": 4.5, "NW": 4, "HW": 4, "OV": 4}
# the same for a SW cell of K1's int16 accumulator: the packed s16x2 forms
# do two cells an instruction (csrc/sw_pair16.cuh), if they issue at the
# int32 forms' rate
MAX_INSTRUCTIONS_PER_CELL_I16 = MAX_INSTRUCTIONS_PER_CELL["SW"] / 2

dp_row_launches = 0
int32_launches = 0


def reset_counters() -> None:
    global dp_row_launches, int32_launches
    dp_row_launches = 0
    int32_launches = 0


def require_cuda(device="cuda") -> torch.device:
    """The CUDA device a measurement runs on; raises without a card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes measure a CUDA card, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the benchmark measures the card and "
            "has no CPU mode"
        )
    return _device(dev)


def _check_args(name, m, salt, B, N, go=0, ge=0):
    if B <= 0 or N <= 0:
        raise ValueError(f"{name}: B and N must be positive, got B={B} N={N}")
    if not 0 <= m <= MAX_ROUNDS:
        raise ValueError(f"{name}: the round count {m} is outside [0, {MAX_ROUNDS}]")
    if abs(salt) > MAX_ARG or not (0 <= go <= MAX_ARG and 0 <= ge <= MAX_ARG):
        raise ValueError(f"{name}: salt, go and ge must stay within {MAX_ARG}")


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA one with its index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_out(name, out, B, dev):
    if out.device != dev:
        raise ValueError(f"{name}: out is on {out.device}, expected {dev}")
    if out.dtype != torch.int32:
        raise TypeError(f"{name}: out must be torch.int32, got {out.dtype}")
    if tuple(out.shape) != (B,) or not out.is_contiguous():
        raise ValueError(f"{name}: out must be a contiguous ({B},) tensor, "
                         f"got {tuple(out.shape)}")


# ---------------------------------------------------------------- K5


def dp_row_probe_plain(m, salt, *, B=1024, N=512, go=10, ge=1, device="cpu"):
    """(B,) int32: the Pallas kernel's arithmetic in plain PyTorch, the
    row recurrence in its decayed-prefix-max form over (B, N) tensors."""
    dev = torch.device(device)
    i32 = torch.int32
    col = torch.arange(N, dtype=i32, device=dev)
    s0 = col % 11 - 4 + salt
    s1 = (col + 5) % 13 - 6 - salt
    jge1 = (col + 1) * ge
    goge = go + col * ge
    h = torch.zeros((B, N), dtype=i32, device=dev)
    f = torch.full((B, N), NEGL, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    negl_col = torch.full((B, 1), NEGL, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    for i in range(int(m)):
        s = torch.where((col + i) % 2 == 0, s0, s1)
        f = torch.maximum(h - go, f - ge)
        diag = torch.cat([zero_col, h[:, :-1]], dim=1)
        g = torch.maximum(diag + s, f).clamp(min=0)
        cmax = torch.cummax(g + jge1, dim=1).values
        e = torch.cat([negl_col, cmax[:, :-1]], dim=1).clamp(min=0) - goge
        h = torch.maximum(g, e)
        best = torch.maximum(best, h.amax(dim=1))
    return best


def dp_row_geometry(B: int, N: int, sm_count: int):
    """(T, C, block, strips) of a K5 launch of B rows of N columns on a
    card of ``sm_count`` SMs: T lanes a row, each holding C =
    ``DP_ROW_COLS`` columns, ``block`` threads a block, and the strips of
    T x C columns a row takes.

    T is the smallest power of two whose T x C columns cover N, at most
    32 (one warp a row); a wider row takes several strips of 512 columns.
    The block holds ``DP_ROW_MAX_BLOCK`` threads, halved down to one warp
    while the launch would leave SMs without a block (as
    ``sw_grouped.tile_geometry``)."""
    if B <= 0 or N <= 0:
        raise ValueError(f"dp_row_geometry: B and N must be positive, got B={B} N={N}")
    if N > MAX_DP_ROW_N:
        raise ValueError(f"dp_row_probe: N={N} exceeds {MAX_DP_ROW_N}")
    C = DP_ROW_COLS
    T = 1
    while T < 32 and T * C < N:
        T *= 2
    block = DP_ROW_MAX_BLOCK
    while block > 32 and -(-B * T // block) < sm_count:
        block //= 2
    return T, C, block, -(-N // (T * C))


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dp_row_probe(m, salt, *, B=1024, N=512, go=10, ge=1, device="cuda", out=None):
    """(B,) int32: each row's best cell after ``m`` query rows (K5).  On
    a CUDA device it launches the kernel, into ``out`` when given; a row
    of one strip (N <= 512) needs no scratch."""
    dev = _device(device)
    m, salt, go, ge = int(m), int(salt), int(go), int(ge)
    _check_args("dp_row_probe", m, salt, B, N, go, ge)
    if N > MAX_DP_ROW_N:
        raise ValueError(f"dp_row_probe: N={N} exceeds {MAX_DP_ROW_N}")
    if out is not None:
        _check_out("dp_row_probe", out, B, dev)
    if dev.type == "cpu":
        res = dp_row_probe_plain(m, salt, B=B, N=N, go=go, ge=ge, device=dev)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"dp_row_probe runs on cpu or cuda, not {dev}")
    lib = _build.load()
    T, _, block, strips = dp_row_geometry(B, N, _sm_count(dev.index))
    if out is None:
        out = torch.empty(B, dtype=torch.int32, device=dev)
    # each strip's bottom (H, F) row between row tiles, laid out by the kernel
    nbytes = lib.sift4g_dp_row_scratch_bytes(B, strips)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.sift4g_dp_row_probe(B, N, m, salt, go, ge, T, strips, block,
                                     None if scratch is None else scratch.data_ptr(),
                                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dp_row_probe kernel launch failed: CUDA error {rc}")
    global dp_row_launches
    dp_row_launches += 1
    return out


# ---------------------------------------------------------------- K6


def int32_probe_plain(m, salt, *, B=1024, N=512, pairs=1, packed=False, device="cpu"):
    """(B,) int32 in plain PyTorch; ``packed``: on int16, with a second
    element a pair that starts one further on (a + 1, b - 1)."""
    dev = torch.device(device)
    i32 = torch.int32
    p = torch.arange(pairs, dtype=i32, device=dev)[:, None, None]
    a = (torch.arange(N, dtype=i32, device=dev)[None, None, :] + salt + p).expand(pairs, B, N)
    b = (torch.arange(B, dtype=i32, device=dev)[None, :, None] - salt - p).expand(pairs, B, N)
    if packed:
        a = torch.cat([a, a + 1]).to(torch.int16)
        b = torch.cat([b, b - 1]).to(torch.int16)
    a, b = a.contiguous(), b.contiguous()
    for _ in range(int(m)):
        a, b = torch.maximum(a + 1, b), torch.maximum(b - 1, a)
    return torch.maximum(a, b).amax(dim=(0, 2)).to(i32)


def int32_probe(m, salt, *, B=1024, N=512, pairs=1, packed=False, device="cuda", out=None):
    """(B,) int32: each row's maximum after ``m`` rounds (K6; ``packed``:
    its int16 form).  On a CUDA device it launches the kernel, into
    ``out`` when given."""
    dev = _device(device)
    m, salt = int(m), int(salt)
    _check_args("int32_probe", m, salt, B, N)
    if pairs not in INT32_PAIRS:
        raise ValueError(f"int32_probe: pairs must be one of {INT32_PAIRS}, got {pairs}")
    if out is not None:
        _check_out("int32_probe", out, B, dev)
    if dev.type == "cpu":
        res = int32_probe_plain(m, salt, B=B, N=N, pairs=pairs, packed=packed, device=dev)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"int32_probe runs on cpu or cuda, not {dev}")
    lib = _build.load()
    if out is None:
        out = torch.empty(B, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        probe = lib.sift4g_s16x2_probe if packed else lib.sift4g_int32_probe
        rc = probe(B, N, m, salt, pairs, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"int32_probe kernel launch failed: CUDA error {rc}")
    global int32_launches
    int32_launches += 1
    return out


# ---------------------------------------------------------------- timing


def event_ms(fn, device) -> float:
    """Milliseconds between CUDA events recorded just before and just
    after ``fn()`` on the current stream of ``device``."""
    with torch.cuda.device(device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end)


def _differential(call, lo, hi, iters, device):
    """(first call's wall s, best t_lo s, best t_hi s) with a new salt on
    every call; the first call builds the kernels."""
    t0 = time.perf_counter()
    call(min(64, hi), 0)
    torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    t_lo = min(event_ms(lambda s=1 + i: call(lo, s), device) for i in range(iters)) / 1e3
    t_hi = min(event_ms(lambda s=100 + i: call(hi, s), device) for i in range(iters)) / 1e3
    if t_hi - t_lo <= 1e-3:
        raise RuntimeError(
            f"t_hi - t_lo = {(t_hi - t_lo) * 1e3:.4f} ms is at the events' "
            f"resolution: raise hi ({hi}) against lo ({lo})"
        )
    return first_s, t_lo, t_hi


def dp_row_roofline(B=1024, N=512, go=10, ge=1, iters=6, lo=1_000, hi=4_000, device="cuda"):
    """The row engine's marginal cell rate on the card (K5).

    Returns ``gcups`` (B * N cells per row over the row-count delta),
    ``t_lo_s``/``t_hi_s`` (best-of-``iters`` event times at each row
    count) and ``build_s`` (the first call, the kernels' build
    included).  Raises without a card."""
    dev = require_cuda(device)
    out = torch.empty(B, dtype=torch.int32, device=dev)

    def call(m, salt):
        dp_row_probe(m, salt, B=B, N=N, go=go, ge=ge, device=dev, out=out)

    build_s, t_lo, t_hi = _differential(call, lo, hi, iters, dev)
    return {
        "gcups": B * N * (hi - lo) / (t_hi - t_lo) / 1e9,
        "t_lo_s": t_lo,
        "t_hi_s": t_hi,
        "build_s": build_s,
    }


def int32_roofline(B=1024, N=512, iters=6, pairs=1, lo=None, hi=None, packed=False,
                   device="cuda"):
    """The int32 probe's marginal rate on the card (K6): 4 operations per
    element, pair and round (two adds, two maxes, as ``bench_ab.py:144``
    counts them; twice that under ``packed``, whose elements hold two).
    ``lo``/``hi`` default to the JAX rounds, 25,000 and 100,000 divided
    by ``pairs``.  Returns ``tops``, ``t_lo_s``, ``t_hi_s`` and
    ``compile_s`` (the JAX key: the first call's wall time, the kernels'
    build included).  Raises without a card."""
    dev = require_cuda(device)
    lo = 25_000 // pairs if lo is None else lo
    hi = 100_000 // pairs if hi is None else hi
    out = torch.empty(B, dtype=torch.int32, device=dev)

    def call(m, salt):
        int32_probe(m, salt, B=B, N=N, pairs=pairs, packed=packed, device=dev, out=out)

    compile_s, t_lo, t_hi = _differential(call, lo, hi, iters, dev)
    return {
        "tops": (8 if packed else 4) * pairs * B * N * (hi - lo) / (t_hi - t_lo) / 1e12,
        "t_lo_s": t_lo,
        "t_hi_s": t_hi,
        "compile_s": compile_s,
    }


# ---------------------------------------------------------------- the card


def nvidia_smi(fields: str) -> list:
    """One query of ``nvidia-smi`` for the first card: the values of the
    comma-separated ``fields``, as strings with their units."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [v.strip() for v in out.strip().splitlines()[0].split(",")]


def gpu_state() -> dict:
    """The card's SM clock, its maximum, power draw and power limit now."""
    keys = ("clocks.sm", "clocks.max.sm", "power.draw", "power.limit")
    return dict(zip(keys, nvidia_smi(",".join(keys))))


def int32_max_rate(device="cuda"):
    """(instructions/s, how it was computed): the card's peak rate of
    int32 max-family instructions at its maximum SM clock, the documented
    int32 min/max rate.  The operations bounds divide a kernel's
    max-family instructions (``MAX_INSTRUCTIONS_PER_CELL``) by it."""
    dev = require_cuda(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm")[0].split()[0])
    rate = INT32_RESULTS_PER_SM_CLOCK * sms * mhz * 1e6
    how = (f"{INT32_RESULTS_PER_SM_CLOCK} max-family instructions/clock/SM x {sms} SMs x "
           f"{mhz:g} MHz (clocks.max.sm) = {rate / 1e12:.3f} T/s; {INT32_RATE_SOURCE}")
    return rate, how


def int32_peak_rate(device="cuda"):
    """(ops/s, how it was computed): the card's peak rate of int32 adds and
    maxes counted one operation each, at its maximum SM clock: the
    documented int32 instruction rate, every instruction a fused
    add-and-max (K6's loop)."""
    rate, how = int32_max_rate(device)
    return (OPS_PER_FUSED_INSTRUCTION * rate,
            f"{OPS_PER_FUSED_INSTRUCTION} ops per fused VIADDMNMX (an add and a max) x {how}")


# ---------------------------------------------------------------- SASS

_FUNC = re.compile(r"Function\s*:\s*")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_PRED = re.compile(r"^@!?U?P[T0-9]+\s+")
_ADDR = re.compile(r"0x([0-9a-f]+)")
_K6_NAME = re.compile(r"(?:int32|s16x2)_probe_kernelILi(\d+)E")
MAX_OPCODES = ("IMNMX", "VIMNMX", "VIADDMNMX", "VIMNMX3")


def _n_max(ops: Counter) -> int:
    return sum(v for k, v in ops.items() if k in MAX_OPCODES)


def sass_inner_loops(text: str, full: bool = False) -> dict:
    """{function: [opcode Counter of each innermost loop]} from the output
    of ``cuobjdump -sass``: a loop runs from a branch's target address to
    the branch, when the target lies before it.  Opcodes lose their
    modifiers (``VIADDMNMX.S16x2`` counts as ``VIADDMNMX``) unless
    ``full``."""
    funcs = {}
    for chunk in _FUNC.split(text)[1:]:
        insns = []
        for m in _INSN.finditer(chunk):
            op, _, args = _PRED.sub("", m.group(2).strip()).partition(" ")
            insns.append((int(m.group(1), 16), op if full else op.split(".")[0], args))
        loops = []
        for addr, op, args in insns:
            m = _ADDR.search(args) if op.split(".")[0] == "BRA" else None
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
        funcs[chunk.split(None, 1)[0]] = [
            Counter(o for x, o, _ in insns if t <= x <= a) for t, a in loops
            # skip a loop that holds another
            if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a) for t2, a2 in loops)
        ]
    return funcs


def sass_loops(text: str) -> dict:
    """{function: opcode Counter of its hot loop}: the innermost loop with
    the most max-family instructions (:func:`sass_inner_loops`)."""
    return {fn: max(loops, key=lambda c: (_n_max(c), sum(c.values())), default=Counter())
            for fn, loops in sass_inner_loops(text).items()}


def sass_instructions(text: str) -> dict:
    """{function: its instructions, as text} from the output of
    ``cuobjdump -sass``."""
    return {chunk.split(None, 1)[0]: [m.group(2) for m in _INSN.finditer(chunk)]
            for chunk in _FUNC.split(text)[1:]}


def library_sass(path=None):
    """``cuobjdump -sass`` of the built kernel library (or of the library
    at ``path``); None without ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", path or _build.library_path()], capture_output=True,
                          text=True, check=True).stdout


def dp_row_probe_sass():
    """{function: [(loop opcode Counter, instructions per cell)]} of K5's
    instantiations, each innermost loop that runs whole step pairs (at
    least one max-family instruction a cell, 2 x ``DP_ROW_COLS`` cells a
    pass), fewest instructions first: the unguarded steady-state loop,
    then the guarded first and last steps; None without ``cuobjdump``."""
    text = library_sass()
    if text is None:
        return None
    cells = 2 * DP_ROW_COLS
    return {fn: sorted(((ops, sum(ops.values()) / cells) for ops in loops
                        if _n_max(ops) >= cells), key=lambda x: x[1])
            for fn, loops in sass_inner_loops(text).items() if "dp_row_probe_kernel" in fn}


# K1's SW kernels on slabs: the int32 body, the int16 pair body, the float
# body, and their profile loads a column: one 16-byte load of 16 rows (two
# in the pair kernel, one for each target)
_K1_SW_NAME = re.compile(r"(sw_tiled_kernel|sw_pair16_kernel|sw_tiled_f32_kernel)"
                         r"ILi0ENS_8SlabRows")
K1_LOADS_PER_COLUMN = {"sw_tiled_kernel": 1, "sw_pair16_kernel": 2, "sw_tiled_f32_kernel": 1}
K1_ROWS_PER_LOAD = 16


def k1_sw_loop_sass():
    """{kernel name: (opcode Counter of its column loop, with modifiers;
    the cells, or cell pairs in the int16 kernel, that the loop's code
    covers; instructions per cell or cell pair)} of K1's three SW kernels,
    read with ``cuobjdump -sass`` from the built library.  The column loop
    is the innermost loop with the most profile loads (``LDS.128``); nvcc
    may put several versions of a step in it, of which a pass runs one,
    so the cells are counted from its loads (16 rows each) and the
    instructions a cell are those that its code holds for each; None
    without ``cuobjdump``."""
    text = library_sass()
    if text is None:
        return None
    out = {}
    for fn, loops in sass_inner_loops(text, full=True).items():
        m = _K1_SW_NAME.search(fn)
        if not m or not loops:
            continue
        ops = max(loops, key=lambda c: (c.get("LDS.128", 0), sum(c.values())))
        cells = ops.get("LDS.128", 0) * K1_ROWS_PER_LOAD // K1_LOADS_PER_COLUMN[m.group(1)]
        out[m.group(1)] = (ops, cells, sum(ops.values()) / cells if cells else None)
    return out


def int32_probe_sass(packed=False):
    """{pairs: (loop opcode Counter, rounds per loop pass, instructions
    per element, pair and round)} of K6's variants (``packed``: its int16
    form's, an element there holding two), read with ``cuobjdump -sass``
    from the built library; None without ``cuobjdump``."""
    text = library_sass()
    if text is None:
        return None
    out = {}
    for fn, ops in sass_loops(text).items():
        m = _K6_NAME.search(fn)
        if not m or ("s16x2_probe" in fn) != packed:
            continue
        pairs = int(m.group(1))
        rounds = _n_max(ops) / (2 * pairs)
        per = sum(ops.values()) / (rounds * pairs) if rounds else None
        out[pairs] = (ops, rounds, per)
    return out

"""Grouped affine-gap scorers: the wrappers around the CUDA kernels.

``sw_scores_grouped`` (K1) takes the layout of
``sift4g_tpu/align/pallas_sw.py:sw_scores_pallas_grouped`` and
``sw_scores_grouped_resident`` (K3) that of
``sw_scores_pallas_grouped_resident``, with int64 starts.  Both dispatch
on the device of their tensors: CPU tensors go to the plain PyTorch
versions (``align/scan.py``), CUDA tensors to the kernels in
``csrc/sw_grouped.cu`` and ``csrc/sw_grouped_resident.cu``, built on
first use.  A CUDA call launches the kernel or raises; there is no
fallback to the plain version.

Counters (plain integers a run reads to show which path it took):
``kernel_launches`` counts K1 launches made here, ``resident_launches``
K3 launches, and ``twin_calls_on_cuda`` calls of the plain versions on
CUDA tensors (only a comparison against a kernel makes those).
"""

from __future__ import annotations

import torch

from . import _build, scan

MODE_IDS = {"SW": 0, "NW": 1, "HW": 2, "OV": 3}

kernel_launches = 0
resident_launches = 0
twin_calls_on_cuda = 0


def reset_counters() -> None:
    global kernel_launches, resident_launches, twin_calls_on_cuda
    kernel_launches = 0
    resident_launches = 0
    twin_calls_on_cuda = 0


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sw_scores_grouped(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32
    targets: torch.Tensor,       # (G, B, N) int8 codes
    target_lens: torch.Tensor,   # (G, B) int32, each <= N
    matrix32: torch.Tensor,      # (32, 32) int32
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
) -> torch.Tensor:
    """Scores (G, B) int32: group g = query g against its B targets."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown alignment mode {mode!r}")
    dev = targets.device
    if dev.type == "cpu":
        return scan.align_scores_grouped(
            q_codes_all, q_offsets, q_lens, targets, target_lens, matrix32,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        )
    if dev.type != "cuda":
        raise ValueError(f"sw_scores_grouped runs on cpu or cuda, not {dev}")
    G, B, N = targets.shape
    _check("q_codes_all", q_codes_all, torch.int32, (q_codes_all.numel(),), dev)
    _check("q_offsets", q_offsets, torch.int32, (G,), dev)
    _check("q_lens", q_lens, torch.int32, (G,), dev)
    _check("targets", targets, torch.int8, (G, B, N), dev)
    _check("target_lens", target_lens, torch.int32, (G, B), dev)
    _check("matrix32", matrix32, torch.int32, (32, 32), dev)
    if N % 16 or targets.data_ptr() % 16:
        raise ValueError("targets rows must be 16-byte multiples on a 16-byte aligned base")
    if G > 65535:
        raise ValueError(f"{G} groups exceed the launch grid (65535)")

    lib = _build.load()
    out = torch.empty((G, B), dtype=torch.int32, device=dev)
    # (H, F) of the previous query row per (group, column, target); freed
    # to the caching allocator on return, which reuses it only for work
    # queued after this launch on the same stream
    scratch = torch.empty((G, N, B, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sift4g_sw_grouped(
            q_codes_all.data_ptr(), q_codes_all.shape[0],
            q_offsets.data_ptr(), q_lens.data_ptr(),
            targets.data_ptr(), target_lens.data_ptr(), matrix32.data_ptr(),
            G, B, N, MODE_IDS[mode], int(gap_open), int(gap_extend),
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_grouped kernel launch failed: CUDA error {rc}")
    global kernel_launches
    kernel_launches += 1
    return out


def sw_scores_grouped_resident(
    q_codes_all: torch.Tensor,   # (Qm,) int32 concatenated queries
    q_offsets: torch.Tensor,     # (G,) int32
    q_lens: torch.Tensor,        # (G,) int32
    db: torch.Tensor,            # (R,) uint8 resident database
    t_starts: torch.Tensor,      # (G, B) int64 byte starts, 16-byte aligned
    target_lens: torch.Tensor,   # (G, B) int32, each <= n_pad
    matrix32: torch.Tensor,      # (32, 32) int32
    n_pad: int,                  # the window (the length rung)
    *,
    mode: str = "SW",
    gap_open: int = 10,
    gap_extend: int = 1,
) -> torch.Tensor:
    """Scores (G, B) int32: group g = query g against the rows of the
    resident database at ``t_starts[g]``, each ``target_lens[g, b]`` long.

    On a card the starts are checked without a host sync: a start that is
    misaligned, negative or whose ``n_pad`` window leaves the database
    fails a device-side assertion (the kernel also scores such a row as
    empty, so it never reads out of bounds)."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown alignment mode {mode!r}")
    dev = db.device
    if dev.type == "cpu":
        return scan.align_scores_grouped_resident(
            q_codes_all, q_offsets, q_lens, db, t_starts, target_lens, matrix32, n_pad,
            mode=mode, gap_open=gap_open, gap_extend=gap_extend,
        )
    if dev.type != "cuda":
        raise ValueError(f"sw_scores_grouped_resident runs on cpu or cuda, not {dev}")
    G, B = t_starts.shape
    N = int(n_pad)
    _check("q_codes_all", q_codes_all, torch.int32, (q_codes_all.numel(),), dev)
    _check("q_offsets", q_offsets, torch.int32, (G,), dev)
    _check("q_lens", q_lens, torch.int32, (G,), dev)
    _check("db", db, torch.uint8, (db.numel(),), dev)
    _check("t_starts", t_starts, torch.int64, (G, B), dev)
    _check("target_lens", target_lens, torch.int32, (G, B), dev)
    _check("matrix32", matrix32, torch.int32, (32, 32), dev)
    if N <= 0 or N % 16 or db.data_ptr() % 16:
        raise ValueError("n_pad must be a positive multiple of 16 and db 16-byte aligned")
    if G > 65535:
        raise ValueError(f"{G} groups exceed the launch grid (65535)")
    if G and B:
        torch._assert_async(
            ((t_starts & 15) == 0).all()
            & (t_starts >= 0).all()
            & (t_starts.max() <= db.numel() - N)
        )

    lib = _build.load()
    out = torch.empty((G, B), dtype=torch.int32, device=dev)
    scratch = torch.empty((G, N, B, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sift4g_sw_grouped_resident(
            q_codes_all.data_ptr(), q_codes_all.shape[0],
            q_offsets.data_ptr(), q_lens.data_ptr(),
            db.data_ptr(), db.numel(), t_starts.data_ptr(),
            target_lens.data_ptr(), matrix32.data_ptr(),
            G, B, N, MODE_IDS[mode], int(gap_open), int(gap_extend),
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"sw_grouped_resident kernel launch failed: CUDA error {rc}")
    global resident_launches
    resident_launches += 1
    return out

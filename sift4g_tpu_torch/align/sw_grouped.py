"""Grouped affine-gap scorer: the wrapper around the CUDA kernel.

``sw_scores_grouped`` takes the layout of
``sift4g_tpu/align/pallas_sw.py:sw_scores_pallas_grouped`` and dispatches
on the device of its tensors: CPU tensors go to the plain PyTorch twin
(``align/scan.py``), CUDA tensors to the kernel in
``csrc/sw_grouped.cu``, built on first use.  A CUDA call launches the
kernel or raises; there is no fallback to the twin.

Counters (plain integers a run reads to show which path it took):
``kernel_launches`` counts kernel launches made here, and
``twin_calls_on_cuda`` counts twin calls on CUDA tensors (only a
comparison against the kernel makes those).
"""

from __future__ import annotations

import torch

from . import _build, scan

MODE_IDS = {"SW": 0, "NW": 1, "HW": 2, "OV": 3}

kernel_launches = 0
twin_calls_on_cuda = 0


def reset_counters() -> None:
    global kernel_launches, twin_calls_on_cuda
    kernel_launches = 0
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

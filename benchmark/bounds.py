"""The card's bound on Smith-Waterman cells, frozen at commit eca6a4da.

Copied from ``sift4g_tpu_torch/align/roofline.py`` (``INT32_RESULTS_PER_SM_CLOCK``,
``MAX_INSTRUCTIONS_PER_CELL``, ``int32_max_rate``): an H100 retires 64
max-family int32 instructions (VIMNMX, VIMNMX3, VIADDMNMX) a clock on each
SM (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
capability 9.0), and a SW cell needs 4.5 of them (F, G with its zero floor,
E, H, and half of the three-input running best).  So the card scores at most
64 x SMs x max SM clock / 4.5 cells a second: 3,717.12 G on an H100 SXM
(132 SMs, 1,980 MHz).  SMs and clock are read from the card in the run.
"""

from __future__ import annotations

import subprocess

INT32_RESULTS_PER_SM_CLOCK = 64
MAX_INSTRUCTIONS_PER_SW_CELL = 4.5


def nvidia_smi(fields: str) -> list:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [v.strip() for v in out.strip().splitlines()[0].split(",")]


def sw_cells_per_s(sms: int, max_sm_mhz: float) -> float:
    return INT32_RESULTS_PER_SM_CLOCK * sms * max_sm_mhz * 1e6 / MAX_INSTRUCTIONS_PER_SW_CELL


def card() -> dict:
    """SMs, maximum SM clock and power limit of the first card."""
    import torch

    clock, limit = nvidia_smi("clocks.max.sm,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(clock.split()[0])
    return {"sms": sms, "max_sm_mhz": mhz, "power_limit": limit,
            "sw_cells_per_s": sw_cells_per_s(sms, mhz)}

"""Benchmark of the port: K1's Smith-Waterman scoring rate on one CUDA card.

    python -m sift4g_tpu_torch.bench

The twin of ``bench.py``.  Workload (``bench.py:58-175``): one K1 launch
per call, G=64 groups of B=1024 targets of N=512 residues against a
360-residue query each, BLOSUM_62 with gaps 10/1, codes from seed 42.
Cells are counted as G x B x N x 360.

Protocol: every slab is staged on the card before the warmup, a new slab
for each call; untimed warmup calls until the last 3 rates agree within
5 % (at most 10 calls or 90 s); then 10 timed calls, best and median,
each timed with CUDA events around the launch.  ``marginal_gcups`` comes
from runtime query lengths 360 against 120 on the same slabs: K1 loops
over the runtime query length, so the launch cost and the boundary row
cancel.

Baseline: the port's native C++ DP at the same shape on the host, scalar
(``SIFT4G_TPU_NO_SIMD=1``, the reference's plain CPU build) and SIMD;
``vs_baseline`` divides by the scalar one.

Ceiling: ``roofline_pct`` and ``marginal_roofline_pct`` divide K1's rate
by the card's operations bound for a Smith-Waterman cell,
``roofline_ops_gcups``: its peak rate of int32 max-family instructions
(``roofline.int32_max_rate``, 64 a clock per SM x SMs x the maximum SM
clock; 16.727 T/s on an H100) over the 4.5 a cell needs
(``roofline.MAX_INSTRUCTIONS_PER_CELL``: F, G, E, H and half a
three-input max for the best; the adds fuse into them or issue beside
them), so no kernel can pass 100 %.
The JAX record divides by its row-engine probe instead.  The port's
probe K5 (``align/roofline.py``) runs K1's recurrence with its state on
chip and none of K1's loads (no targets, no int8 profile, no scratch
between passes): it measures the recurrence's own rate on the card, and
K1 over K5 is what K1's loads cost.  It is re-probed after the timed
calls: ``roofline_gcups`` is K5 at B=65,536 rows (the bench launch's
cells a query row), ``roofline_gcups_b1024`` at the JAX default of 1024
rows, over ``B1024_ROWS`` (the JAX rows 1,000 -> 4,000 leave under a
millisecond between the two times there).  ``roofline_pct`` still divides
by the operations bound: a probe's rate is a measurement, not a bound.

Prints one JSON line, with the card's name and power limit, the clocks
sampled beside each measurement, and the launches of K1 and K5.  A host
without a card exits 1 with ``error: no CUDA device ...`` and prints no
metric line; any other failure fails the run.  Not carried over: the
relay probes and device discovery, the XLA-scan fallback and the frozen
``ROOFLINE_GCUPS``/``FALLBACK_BASELINE_GCUPS`` constants.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

# K5's rows at B=65,536 and at B=1024 (lo, hi): on an H100 the JAX rows
# 1,000 -> 4,000 at B=1024 leave the two times under the 1 ms timing
# guard of roofline._differential (chip_smoke.py phase 6 prints both)
B65536_ROWS = (120, 360)
B1024_ROWS = (1_000, 16_000)


def roofline_fields(gcups, marginal_gcups, max_per_s):
    """``roofline_ops_gcups`` (the operations bound of an SW cell, in
    GCUPS, from the card's max-family instruction rate ``max_per_s``) and
    K1's rates as percentages of it."""
    from .align.roofline import MAX_INSTRUCTIONS_PER_CELL

    bound = max_per_s / MAX_INSTRUCTIONS_PER_CELL["SW"] / 1e9
    out = {"roofline_ops_gcups": bound, "roofline_pct": 100.0 * gcups / bound}
    if marginal_gcups:
        out["marginal_roofline_pct"] = 100.0 * marginal_gcups / bound
    return out


def grouped_launch(device, groups=64, batch=1024, n=512, m=360, seed=42):
    """The bench launch's inputs on ``device``: (q_all, q_off, lens,
    matrix32, q_lens(length) for a runtime query length, new_slab() for
    a new (G, B, N) int8 slab of random codes)."""
    from .align import scan
    from .core.scorers import create_scorer

    m32 = scan.matrix32_from_scorer(create_scorer("BLOSUM_62", 10, 1), device)
    rng = np.random.default_rng(seed)
    m_pad = -(-m // 64) * 64
    q_all = np.full(groups * m_pad, scan.PAD_CODE, dtype=np.int32)
    q_off = (np.arange(groups) * m_pad).astype(np.int32)
    for g in range(groups):
        q_all[g * m_pad : g * m_pad + m] = rng.integers(0, 26, m)
    lens = torch.full((groups, batch), n, dtype=torch.int32, device=device)

    def q_lens(length):
        return torch.full((groups,), length, dtype=torch.int32, device=device)

    def new_slab():
        codes = rng.integers(0, 26, (groups, batch, n), dtype=np.int8)
        return torch.from_numpy(codes).to(device)

    qa = torch.from_numpy(q_all).to(device)
    qo = torch.from_numpy(q_off).to(device)
    return qa, qo, lens, m32, q_lens, new_slab


def bench_grouped_cuda(device, groups=64, batch=1024, n=512, m=360, iters=10,
                       warmup_budget_s=90.0, warmup_max=10, m_lo=120, marginal_iters=5,
                       acc="int", max_qlen=0, max_sub=0):
    """Best, median and marginal GCUPS of K1 at the bench launch, on the
    accumulator ``acc`` (``max_qlen`` and ``max_sub`` bound ``"i16"``)."""
    from .align import sw_grouped
    from .align.roofline import event_ms

    qa, qo, lens, m32, q_lens, new_slab = grouped_launch(device, groups, batch, n, m)
    qlen_hi, qlen_lo = q_lens(m), q_lens(m_lo)

    kw = dict(acc=acc, max_qlen=max_qlen, max_sub=max_sub)

    def call(qlen, t):
        return event_ms(lambda: sw_grouped.sw_scores_grouped(qa, qo, qlen, t, lens, m32, **kw),
                        device) / 1e3

    cells = groups * m * batch * n
    t0 = time.perf_counter()
    call(qlen_hi, new_slab())
    build_s = time.perf_counter() - t0

    # every slab staged before the warmup, so no transfer is in flight
    # while a call is timed
    warm_slabs = [new_slab() for _ in range(warmup_max)]
    timed_slabs = [new_slab() for _ in range(iters)]
    torch.cuda.synchronize(device)

    trail, converged = [], False
    deadline = time.monotonic() + warmup_budget_s
    for t in warm_slabs:
        if time.monotonic() >= deadline:
            break
        trail.append(cells / call(qlen_hi, t) / 1e9)
        if len(trail) >= 3 and max(trail[-3:]) <= 1.05 * min(trail[-3:]):
            converged = True
            break

    times = [call(qlen_hi, t) for t in timed_slabs]
    lo_times = [call(qlen_lo, t) for t in timed_slabs[:marginal_iters]]
    best = min(times)
    dt = best - min(lo_times)
    return {
        "gcups": cells / best / 1e9,
        "gcups_median": cells / sorted(times)[len(times) // 2] / 1e9,
        "gcups_iters": [cells / t / 1e9 for t in times],
        "marginal_gcups": groups * batch * n * (m - m_lo) / dt / 1e9 if dt > 1e-4 else None,
        "warmup_trail": trail,
        "warmup_converged": converged,
        "build_s": build_s,
    }


def bench_native_cpu(n_targets=4096, n=512, m=360, simd=True):
    """GCUPS of the port's threaded native C++ DP at the bench shape on
    the host: ``simd=False`` forces the scalar rolling-row DP (the stand-in
    for the reference's plain CPU build), ``simd=True`` the striped AVX2
    path."""
    from .align.host import score_pairs_batch
    from .core.scorers import create_scorer

    scorer = create_scorer("BLOSUM_62", 10, 1)
    rng = np.random.default_rng(42)
    q = rng.integers(0, 26, m).astype(np.uint8)
    targets = [rng.integers(0, 26, n).astype(np.uint8) for _ in range(n_targets)]
    if not simd:
        os.environ["SIFT4G_TPU_NO_SIMD"] = "1"
    try:
        score_pairs_batch(q, targets[:64], scorer, "SW")  # load the library
        t0 = time.perf_counter()
        score_pairs_batch(q, targets, scorer, "SW")
        dt = time.perf_counter() - t0
    finally:
        if not simd:
            os.environ.pop("SIFT4G_TPU_NO_SIMD", None)
    return m * n * n_targets / dt / 1e9


def main() -> int:
    from .align import roofline, sw_grouped

    try:
        device = roofline.require_cuda("cuda")
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    name, power_limit = roofline.nvidia_smi("name,power.limit")
    sw_grouped.reset_counters()
    roofline.reset_counters()

    baseline = bench_native_cpu(simd=False)
    cpu_simd = bench_native_cpu(simd=True)
    clocks = {"before K1": roofline.gpu_state()}
    detail = bench_grouped_cuda(device)
    clocks["after K1"] = roofline.gpu_state()
    gcups = detail.pop("gcups")
    # the ceiling, re-probed after the timed calls so it cannot perturb them
    lo, hi = B65536_ROWS
    probe = roofline.dp_row_roofline(B=64 * 1024, N=512, lo=lo, hi=hi, device=device)
    clocks["after K5 at B=65536"] = roofline.gpu_state()
    lo, hi = B1024_ROWS
    probe_1024 = roofline.dp_row_roofline(lo=lo, hi=hi, device=device)
    clocks["after K5 at B=1024"] = roofline.gpu_state()
    peak, peak_src = roofline.int32_max_rate(device)

    out = {
        "metric": "sw_score_gcups[cuda-grouped]",
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / baseline,
        "baseline_gcups": baseline,
        "cpu_simd_gcups": cpu_simd,
        **{k: v for k, v in detail.items() if v is not None},
        **roofline_fields(gcups, detail.get("marginal_gcups"), peak),
        "roofline_ops_src": f"{peak_src}; / {roofline.MAX_INSTRUCTIONS_PER_CELL['SW']} "
                            "max-family instructions a SW cell",
        "roofline_gcups": probe["gcups"],
        "roofline_src": "in-run K5 (the recurrence with its state on chip), B=65536 N=512, "
                        "rows {} -> {}".format(*B65536_ROWS),
        "roofline_t_lo_s": probe["t_lo_s"],
        "roofline_t_hi_s": probe["t_hi_s"],
        "roofline_build_s": probe["build_s"],
        "roofline_gcups_b1024": probe_1024["gcups"],
        "roofline_b1024_src": "in-run K5, B=1024 N=512, rows {} -> {}".format(*B1024_ROWS),
        "roofline_b1024_t_lo_s": probe_1024["t_lo_s"],
        "roofline_b1024_t_hi_s": probe_1024["t_hi_s"],
        "card": name,
        "power_limit": power_limit,
        "device": torch.cuda.get_device_name(device),
        "clocks": clocks,
        "launches": {
            "sw_grouped": sw_grouped.kernel_launches,
            "dp_row_probe": roofline.dp_row_launches,
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measurements on the card: the int32 and row-engine probes, K1 launches,
and the host baseline.

    python -m sift4g_tpu_torch.tools.bench_ab <cmd> [deadline_s]

The twin of ``tools/bench_ab.py``; one subcommand per process, each
printing one JSON line per measurement:

* ``roofline``, ``roofline2``, ``roofline4``: K6 (``align/roofline.py``)
  with 1, 2 and 4 independent (a, b) pairs per element (nvcc compiles
  the update to ``VIADDMNMX`` on sm_90a): the marginal int32 rate at
  25,000 and 100,000 rounds (divided by the pairs), 4 operations per
  element and round, beside the card's peak int32 rate
  (``roofline.int32_peak_rate``) and the instructions per second read
  from the loop's SASS;
* ``roofline16``: K6's int16 form with 4 pairs (``VIADDMNMX.S16x2``, two
  elements an instruction, 8 operations per element and round), beside
  twice that peak: whether the packed forms issue at the int32 rate;
* ``dprow``: K5, the row engine's marginal cell rate at the JAX shape,
  over the bench's B=1024 rows (``bench.B1024_ROWS``);
* ``native``: the port's threaded native C++ DP at the bench shape on the
  host (the CPU baseline);
* ``g64``, ``g128``: K1 at the bench launch with 64 and 128 groups;
* ``ab``: the JAX ``run_ab`` protocol (``tools/bench_ab.py:39-90``) on
  K1: the bench launch (G=64, B=1024, N=512, m=360) with ``acc="int"``,
  then ``acc="i16"`` (``max_qlen`` 384, the padded query, ``max_sub`` the
  matrix's maximum) on the same slabs; the two forms' scores must be
  equal, then one line per form (best, every and marginal GCUPS, by
  ``bench.bench_grouped_cuda``'s protocol) and a ``{"parity": "ok",
  "int": ..., "i16": ...}`` line.

``unroll`` and ``unroll4`` are refused: they A/B the Pallas loop's
unroll, a TPU layout knob; K1's loop is unrolled at compile time.  Every
subcommand but ``native`` measures the card: without one it exits 1 with
``error: no CUDA device ...`` and prints no metric line.
"""

from __future__ import annotations

import json
import signal
import sys

REFUSED = {
    "unroll": "A/Bs the TPU kernel's unroll knob",
    "unroll4": "A/Bs the TPU kernel's unroll knob",
}
# the padded query length of the bench launch: the JAX run_ab's max_qlen
AB_MAX_QLEN = 384


def _deadline(seconds):
    def _raise(signum, frame):
        raise TimeoutError(f"exceeded {seconds}s")

    signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)


def _card_fields():
    from ..align import roofline

    name, power_limit = roofline.nvidia_smi("name,power.limit")
    return {"card": name, "power_limit": power_limit, "clocks": roofline.gpu_state()}


def run_roofline(pairs=1, B=1024, N=512, iters=6, packed=False, device="cuda"):
    """K6's marginal rate with ``pairs`` chains (``packed``: its int16
    form, two elements a register, whose peak counts twice the int32
    form's operations an instruction): one record."""
    from ..align import roofline

    dev = roofline.require_cuda(device)
    peak, how = roofline.int32_peak_rate(dev)
    res = roofline.int32_roofline(B=B, N=N, iters=iters, pairs=pairs, packed=packed, device=dev)
    sass = roofline.int32_probe_sass(packed)
    per = sass.get(pairs, (None, None, None))[2] if sass else None
    lo, hi = 25_000 // pairs, 100_000 // pairs
    return {
        "metric": f"{'s16x2' if packed else 'int32'}_tops_marginal[pairs{pairs}]",
        **res,
        "peak_tops": (2 if packed else 1) * peak / 1e12,
        "peak_src": how,
        "insns_per_element_round": per,
        "instr_per_s": (per * pairs * B * N * (hi - lo) / (res["t_hi_s"] - res["t_lo_s"])
                        if per else None),
        **_card_fields(),
    }


def run_dprow(B=1024, N=512, go=10, ge=1, iters=6, device="cuda"):
    """K5's marginal cell rate at the JAX shape: the recurrence that K1's
    inner loop runs, without its matrix lookups and target loads."""
    from ..align.roofline import dp_row_roofline
    from ..bench import B1024_ROWS

    lo, hi = B1024_ROWS
    out = dp_row_roofline(B=B, N=N, go=go, ge=ge, iters=iters, lo=lo, hi=hi, device=device)
    return {"metric": "dp_row_engine_gcups_marginal", **out, **_card_fields()}


def run_grouped(groups=64, iters=6, device="cuda"):
    """K1 at the bench launch with ``groups`` groups, by the bench's own
    protocol (``bench.bench_grouped_cuda``)."""
    from ..align.roofline import require_cuda
    from ..bench import bench_grouped_cuda

    res = bench_grouped_cuda(require_cuda(device), groups=groups, iters=iters)
    return {
        "metric": f"sw_score_gcups[cuda-grouped,G{groups}]",
        "gcups": res["gcups"],
        "all_gcups": res["gcups_iters"],
        "compile_s": res["build_s"],
        "gcups_median": res["gcups_median"],
        "marginal_gcups": res["marginal_gcups"],
        **_card_fields(),
    }


def run_ab(groups=64, iters=10, device="cuda"):
    """K1's int32 and int16 accumulators at the bench launch: bit parity on
    one slab, then each timed by the bench's protocol.  Prints a line per
    form; returns the parity record."""
    import torch

    from ..align import sw_grouped
    from ..align.roofline import require_cuda
    from ..bench import bench_grouped_cuda, grouped_launch

    dev = require_cuda(device)
    qa, qo, lens, m32, q_lens, new_slab = grouped_launch(dev, groups)
    bounds = dict(max_qlen=AB_MAX_QLEN, max_sub=int(m32.max()))
    slab, qlen = new_slab(), q_lens(360)
    ref = sw_grouped.sw_scores_grouped(qa, qo, qlen, slab, lens, m32)
    got = sw_grouped.sw_scores_grouped(qa, qo, qlen, slab, lens, m32, acc="i16", **bounds)
    if not torch.equal(ref, got):
        raise AssertionError("K1 acc='i16' differs from acc='int' on the card")
    out = {}
    for acc in ("int", "i16"):
        res = bench_grouped_cuda(dev, groups=groups, iters=iters, acc=acc, **bounds)
        out[acc] = res["gcups"]
        print(json.dumps({
            "acc": acc,
            "gcups": res["gcups"],
            "all_gcups": res["gcups_iters"],
            "marginal_gcups": res["marginal_gcups"],
            "compile_s": res["build_s"],
            **_card_fields(),
        }), flush=True)
    return {"parity": "ok", **out}


def run_native(n_targets=8192, n=512, m=360):
    """Score-only threaded native C++ DP at the bench workload shape on
    the host: the measured CPU baseline."""
    from ..bench import bench_native_cpu

    return {"metric": "native_cpu_score_gcups", "gcups": bench_native_cpu(n_targets, n, m)}


COMMANDS = {
    "roofline": lambda: run_roofline(pairs=1),
    "roofline2": lambda: run_roofline(pairs=2),
    "roofline4": lambda: run_roofline(pairs=4),
    "roofline16": lambda: run_roofline(pairs=4, packed=True),
    "dprow": run_dprow,
    "native": run_native,
    "g64": lambda: run_grouped(groups=64),
    "g128": lambda: run_grouped(groups=128),
    "ab": run_ab,
}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(f"usage: bench_ab <{'|'.join(COMMANDS)}> [deadline_s]", file=sys.stderr)
        return 2
    cmd = args[0]
    if cmd in REFUSED:
        print(f"error: bench_ab {cmd} {REFUSED[cmd]}, a TPU layout knob that the port's "
              f"K1 does not have (ROADMAP queue 3)", file=sys.stderr)
        return 2
    if cmd not in COMMANDS:
        print(f"error: unknown command {cmd!r}; choose from {', '.join(COMMANDS)}",
              file=sys.stderr)
        return 2
    _deadline(int(args[1]) if len(args) > 1 else 1800)
    try:
        result = COMMANDS[cmd]()
    except RuntimeError as exc:
        if "no CUDA device" not in str(exc):
            raise
        print(f"error: {exc}", file=sys.stderr)
        return 1
    finally:
        signal.alarm(0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

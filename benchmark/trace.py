"""Spans and the device trace of a traced run.

:class:`SpanMetrics` is the ``PhaseMetrics`` a job is given: under
tracing it wraps each phase in a ``torch.profiler.record_function`` range
named ``phase:<name>``, so the profiler's timeline carries each phase's
start and end, on the card's clock, next to the card's kernels.  :func:`reduce_profile` turns a profiler's events
into the device intervals and host ranges the per-layer metrics read.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

from sift4g_tpu_torch.utils import PhaseMetrics

PHASE = "phase:"
JOB = "bench.job"
WINDOW = "bench.window"


class SpanMetrics(PhaseMetrics):
    """Phase seconds and counters (the parent's); under tracing each phase
    is also a profiler range."""

    def __init__(self, trace: bool):
        super().__init__(enabled=False)
        self.trace = trace

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.trace:
            import torch

            rf = torch.profiler.record_function(PHASE + name)
        else:
            rf = contextlib.nullcontext()
        with rf, super().phase(name):
            yield self


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def reduce_profile(prof) -> Dict:
    """From a finished ``torch.profiler.profile``: the window, the device's
    operations (name, start, end, is_kernel) and the host's phase and job
    ranges, in seconds from the window's start."""
    device_ops, ranges, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        on_device = str(ev.device_type()).upper().endswith("CUDA")
        marker = name.startswith((PHASE, JOB, WINDOW))
        if on_device and not marker:
            is_kernel = not name.startswith(("Memcpy", "Memset"))
            device_ops.append((name, start, end, is_kernel))
        elif not on_device and marker:
            if name == WINDOW:
                window = (start, end)
            else:
                ranges.append((name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    w0 = window[0]

    def rel(t):
        return (t - w0) / 1e9

    return {
        "window_s": rel(window[1]),
        "device_ops": [(n, rel(s), rel(e), k) for n, s, e, k in device_ops
                       if e > window[0] and s < window[1]],
        "ranges": [(n, rel(s), rel(e)) for n, s, e in ranges],
    }


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def label_at(ranges, t: float) -> str:
    """The innermost host range open at ``t``: a phase, the job outside its
    phases, or the harness between jobs."""
    best, width = "harness", None
    for name, s, e in ranges:
        if s <= t < e and (width is None or e - s < width):
            best = name[len(PHASE):] if name.startswith(PHASE) else "job.outside_phases"
            width = e - s
    return best


def breakdown(trace: Dict) -> Dict:
    """The device's ten busiest operations by name and its idle time by
    what the host was doing: each idle stretch is cut at the host ranges'
    edges and each piece goes to the innermost range open over it."""
    by_op: Dict[str, float] = {}
    for name, s, e, _ in trace["device_ops"]:
        by_op[name[:160]] = by_op.get(name[:160], 0.0) + (e - s)
    idle: Dict[str, float] = {}
    busy = [(s, e) for _, s, e, _ in trace["device_ops"]]
    edges = sorted({t for _, s, e in trace["ranges"] for t in (s, e)})
    for s, e in gaps(busy, 0.0, trace["window_s"]):
        cuts = [s] + [t for t in edges if s < t < e] + [e]
        for a, b in zip(cuts, cuts[1:]):
            lab = label_at(trace["ranges"], 0.5 * (a + b))
            idle[lab] = idle.get(lab, 0.0) + (b - a)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}

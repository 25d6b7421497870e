"""Observability: per-phase wall-clock + throughput counters.

The reference's only telemetry is carriage-return stderr meters
(utils.cpp:52-61); this adds what a production deployment needs —
structured per-phase timings and cells/s / queries/s counters — while
keeping stderr as the sink (host0-only under multi-host).  While a
``torch.profiler`` records, each phase is also a range on the
profiler's timeline (:class:`PhaseMetrics`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict

# the prefix of every profiler range the program opens: a trace reader
# tells the program's ranges from device work by it (Kineto may mirror a
# range onto the device's timeline)
RANGE_PREFIX = "phase:"


def env_int(name: str, default) -> int:
    """int(os.environ[name]) with an error that names the variable
    (advisor r4: a malformed knob raised a bare ValueError deep inside
    aligner init or mid-launch)."""
    raw = os.environ.get(name)
    if raw is None:
        return int(default)
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"environment variable {name}={raw!r} is not an integer"
        ) from None


def query_log(part: int, total: int, log=sys.stderr) -> None:
    """Carriage-return query progress meter (utils.cpp:52-55)."""
    print(f"* processing queries: {part}/{total} *", end="\r", file=log)
    if part == total:
        print(file=log)


def database_log(part: int, percentage: float, log=sys.stderr) -> None:
    """Carriage-return database scan meter (utils.cpp:57-61)."""
    print(
        f"* processing database part {part}: {min(percentage, 100.0):.1f}/100.0% *",
        end="\r",
        file=log,
    )


class PhaseMetrics:
    """Accumulates phase -> {seconds, counters}; printable summary.

    ``phase(name)`` times a span; a dotted name (``align.traceback.native``)
    is a sub-span of the phase its first word names.  While a
    ``torch.profiler`` records, a span opened on the thread that made this
    object (the job's) is also a ``record_function`` range named
    ``RANGE_PREFIX + name``, so the profiler's nesting gives each span its
    parent.  An idle stretch of the device is laid to the innermost range
    open over it on any thread, and a worker's range would take stretches
    the job's thread spent elsewhere.  ``add`` takes no lock, so only the
    job's thread adds: the overlap's resolver and the host pools return
    their counts, and the job's thread adds them once it has collected
    them."""

    def __init__(self, log=sys.stderr, enabled: bool = True):
        self.log = log
        self.enabled = enabled
        self.phases: Dict[str, Dict[str, float]] = {}
        self._thread = threading.get_ident()

    def _range(self, name: str):
        torch = sys.modules.get("torch")  # no torch loaded: no profiler
        if (torch is None or threading.get_ident() != self._thread
                or not torch.autograd._profiler_enabled()):
            return contextlib.nullcontext()
        return torch.profiler.record_function(RANGE_PREFIX + name)

    @contextlib.contextmanager
    def phase(self, name: str):
        with self._range(name):
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                dt = time.perf_counter() - t0
                self.phases.setdefault(name, {}).setdefault("seconds", 0.0)
                self.phases[name]["seconds"] += dt

    def add(self, phase: str, **counters: float) -> None:
        d = self.phases.setdefault(phase, {})
        for k, v in counters.items():
            d[k] = d.get(k, 0.0) + v

    def report(self) -> None:
        if not self.enabled:
            return
        total = sum(
            d.get("seconds", 0.0)
            for name, d in self.phases.items()
            if "." not in name  # sub-timers (e.g. align.fetch) nest in a phase
        )
        print("** Phase timings **", file=self.log)
        for name, d in self.phases.items():
            parts = [f"{d.get('seconds', 0.0):8.3f}s"]
            shown = {"seconds"}
            if "cells" in d and d.get("seconds"):
                parts.append(f"{d['cells'] / d['seconds'] / 1e9:8.3f} GCUPS")
                shown.add("cells")
            for k, v in d.items():
                if k not in shown:
                    parts.append(f"{k}={v:g}")
            print(f"*   {name:<12} {' '.join(parts)}", file=self.log)
        print(f"*   {'total':<12} {total:8.3f}s", file=self.log)

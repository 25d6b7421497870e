"""Observability: per-phase wall-clock + throughput counters.

The reference's only telemetry is carriage-return stderr meters
(utils.cpp:52-61); this adds what a production TPU deployment needs —
structured per-phase timings and cells/s / queries/s counters — while
keeping stderr as the sink (host0-only under multi-host).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional


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
    """Accumulates phase -> {seconds, counters}; printable summary."""

    def __init__(self, log=sys.stderr, enabled: bool = True):
        self.log = log
        self.enabled = enabled
        self.phases: Dict[str, Dict[str, float]] = {}

    @contextmanager
    def phase(self, name: str):
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

    def rate(self, phase: str, counter: str) -> Optional[float]:
        d = self.phases.get(phase)
        if not d or not d.get("seconds"):
            return None
        v = d.get(counter)
        return None if v is None else v / d["seconds"]

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
            if "cells" in d and d.get("seconds"):
                parts.append(f"{d['cells'] / d['seconds'] / 1e9:8.3f} GCUPS")
            for k, v in d.items():
                if k not in ("seconds", "cells"):
                    parts.append(f"{k}={v:g}")
            print(f"*   {name:<12} {' '.join(parts)}", file=self.log)
        print(f"*   {'total':<12} {total:8.3f}s", file=self.log)

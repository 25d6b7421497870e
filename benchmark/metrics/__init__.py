"""The metrics, one reader a file, found by the metric's name.

``<name>.py`` defines ``read(run)``, which returns the metric's value, or
None where the run holds nothing to read (the harness then leaves the
metric out).  A run with ``--trace 0`` reads the cell's end-to-end
metrics, one with ``--trace 1`` its per-layer ones.  ``run`` carries:

* ``jobs``: the window's jobs, each a dict with ``queries``,
  ``latency_s``, ``status`` and ``phases`` (``PhaseMetrics.phases``: each
  phase's ``seconds`` and counters);
* ``window_s``: from the window's start to its last job's end;
* ``setup_s``: from the harness's start to the window's;
* ``trace``: ``benchmark.trace.reduce_profile``'s window, device operations
  and host ranges;
* ``card``: ``benchmark.bounds.card()``;
* ``ref_cells``: the Smith-Waterman cells of the window's queries against
  their candidate sets, counted by the plain reference's prefilter.
"""

import importlib.util
import os

TOP_PHASES = ("search", "align", "select", "predict")


def load(name: str, metrics_dir: str):
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ok_jobs(run):
    return [j for j in run.jobs if j["status"] == 0]


def per_query_ms(run, seconds_of) -> "float | None":
    """Milliseconds a query: ``seconds_of(job)`` summed over the window's
    finished jobs, over their queries."""
    jobs = ok_jobs(run)
    q = sum(j["queries"] for j in jobs)
    if not q:
        return None
    return 1e3 * sum(seconds_of(j) for j in jobs) / q


def phase_s(job, name: str) -> float:
    return job["phases"].get(name, {}).get("seconds", 0.0)

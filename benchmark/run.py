"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (``workloads`` in BENCHMARK.json)
names a configuration (``benchmark/configs/<config>.json``) and a traffic
mix (``benchmark/traffic/<traffic>.json``); per-layer metrics are readers in
``benchmark/metrics/<name>.py``.  A run:

1. generates the cell's inputs from the seed under ``$TMPDIR/sift4g_bench``
   (``benchmark/gen/synth.py``) and runs one warm-up job of the cell's own
   traffic through ``sift4g_tpu_torch.cli.main``, in this process, as the
   daemon (``serve.py``) runs a job; that is the set-up (``setup_s``);
2. runs the cell's jobs back to back, a closed loop of one client, until
   ``--seconds`` have passed; a job that starts inside the window runs to
   its end and counts.  Each job gets a ``benchmark.trace.SpanMetrics``
   (the program's ``PhaseMetrics``); under ``--trace 1`` the window runs
   under ``torch.profiler`` and each phase is also a ``record_function``
   range;
3. checks the window: every job ran in the schedule the configuration
   states, the scores came from the card's kernels, and every .SIFTprediction file of
   one job drawn from the seed byte-identical to the plain reference's
   (``benchmark/reference``), which runs after the program's memory is
   read and freed;
4. reads the metrics (``benchmark/metrics``), then checks that no module of
   JAX or of the JAX package is loaded: a run that finds one prints no
   result and exits with 3;
5. prints the numbers compared, each with its limit, as the last lines of
   standard error, and one JSON object as the last line of standard output.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "sift4g_tpu")
PROGRAM = "sift4g_tpu_torch"


class Cell:
    """A workload of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(self.dir, "configs", self.workload["config"] + ".json")) as fh:
            self.config = json.load(fh)
        with open(os.path.join(self.dir, "traffic", self.workload["traffic"] + ".json")) as fh:
            self.traffic = json.load(fh)
        if self.traffic.get("loop") != "closed" or self.traffic.get("clients") != 1:
            raise SystemExit("error: the harness runs closed loops of one client only; "
                             f"traffic {self.workload['traffic']!r} asks for another")
        self.extra_flags = []

    def metrics(self, section: str):
        return [m for m in self.spec[section]
                if self.name in m.get("workloads", [self.name])]

    def argv(self, job_path: str, subst_dir: str, db_path: str, out_dir: str):
        p = self.config["params"]
        argv = ["-q", job_path, "-d", db_path, "--out", out_dir,
                "--matrix", p["matrix"], "-g", str(p["gap_open"]), "-e", str(p["gap_extend"]),
                "--algorithm", p["algorithm"], "--kmer-length", str(p["kmer_length"]),
                "--max-candidates", str(p["max_candidates"]), "--max-aligns", str(p["max_aligns"]),
                "--evalue", str(p["evalue"]), "--median-threshold", str(p["median_threshold"]),
                "--seq-id", str(p["seq_id"])]
        if subst_dir:
            argv += ["--subst", subst_dir]
        return (argv + list(self.config["flags"]) + list(self.traffic.get("flags", []))
                + list(self.extra_flags))


def forbidden_loaded(names=None):
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def reference_imports(ref_dir: str):
    """Top-level names the reference's sources import that it may not:
    FORBIDDEN and the program."""
    bad = set()
    for fn in sorted(os.listdir(ref_dir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fn)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".", 1)[0]
                if top in FORBIDDEN or top == PROGRAM:
                    bad.add(f"{fn}: {m}")
    return sorted(bad)


def _launches():
    from sift4g_tpu_torch.align import sw_grouped as g

    return {k: getattr(g, k) for k in ("kernel_launches", "resident_launches", "long_launches",
                                       "i16_launches", "f32_launches", "single_launches",
                                       "twin_calls_on_cuda")}


def _run_job(cell, man, job, out_dir, metrics, log_path):
    """One job through cli.main; (status, latency seconds)."""
    from sift4g_tpu_torch import cli

    os.makedirs(out_dir, exist_ok=True)
    argv = cell.argv(job["path"], man["subst_dir"], man["db_path"], out_dir)
    t0 = time.perf_counter()
    with open(log_path, "a") as log, contextlib.redirect_stderr(log):
        try:
            status = cli.main(argv, metrics=metrics)
        except SystemExit as exc:
            status = int(exc.code or 0)
        except Exception as exc:  # a job's failure is counted, not fatal
            print(f"error: {exc!r}", file=log)
            status = -1
    return status, time.perf_counter() - t0


def _schedule(done_job) -> str:
    """The order a job ran in: ``overlapped`` (search and K1 scoring
    together, ``pipeline._run_overlapped``) or ``two-phase``."""
    return "overlapped" if done_job["phases"].get("search", {}).get("overlapped") else "two-phase"


def compare(job, out_dir, expected) -> dict:
    """Files of ``job`` that differ from the reference's, or are missing,
    or were written where the reference writes none."""
    mismatched = missing = extra = 0
    for name in job["queries"]:
        path = os.path.join(out_dir, name + ".SIFTprediction")
        have = None
        if os.path.exists(path):
            with open(path) as fh:
                have = fh.read()
        want = expected[name]
        if want is None and have is not None:
            extra += 1
        elif want is not None and have is None:
            missing += 1
        elif want != have:
            mismatched += 1
    return {"mismatched": mismatched, "missing": missing, "extra": extra,
            "files": sum(v is not None for v in expected.values())}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, *,
             require_cuda: bool = True, config_edit=None, traffic_edit=None,
             program_flags=()) -> dict:
    """Run the cell once; returns the result object.  ``require_cuda``,
    ``config_edit`` and ``traffic_edit`` (functions that may change the
    loaded configuration and traffic) and ``program_flags`` (appended to
    every job's argv) serve the benchmark's own tests, which drive small
    runs without a card."""
    import numpy as np
    import torch

    cell = Cell(root, workload)
    cell.extra_flags = list(program_flags)
    if config_edit is not None:
        config_edit(cell.config)
    if traffic_edit is not None:
        traffic_edit(cell.traffic)
    seed = int(seed) % (1 << 63)
    chips = int(cell.workload["chips"])
    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"error: the cell needs {chips} CUDA card(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    bad_ref = reference_imports(os.path.join(cell.dir, "reference"))
    if bad_ref:
        raise SystemExit(f"error: the reference imports {bad_ref}")

    base = os.path.join(tempfile.gettempdir(), "sift4g_bench")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    os.environ["SIFT4G_TPU_IN_DAEMON"] = "1"
    os.environ["SIFT4G_TPU_CACHE_DIR"] = os.path.join(base, "cache")
    shm_before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()

    from benchmark.gen.synth import generate
    from benchmark.trace import SpanMetrics

    t_gen = time.perf_counter()
    man = generate(cell.config, seed, os.path.join(base, "data"), int(cell.traffic["job_queries"]))
    t_gen = time.perf_counter() - t_gen
    jobs = man["jobs"]
    log_path = os.path.join(base, "program.log")
    status, warm_s = _run_job(cell, man, jobs[0], os.path.join(base, "out", "warmup"),
                              None, log_path)
    if status != 0:
        with open(log_path) as fh:
            sys.stderr.write(fh.read()[-4000:])
        raise SystemExit(f"error: the warm-up job failed with status {status}")
    device = torch.device("cuda", 0) if require_cuda else None
    if device is not None:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T_START
    # the set-up's objects stay out of the window's garbage collections
    gc.collect()
    gc.freeze()

    # ------------------------------------------------------------ window
    launches0 = _launches()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device is not None else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_rf = record_function("bench.window")
        window_rf.__enter__()
    done = []
    k = 1
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        job = jobs[1 + (k - 1) % (len(jobs) - 1)]
        metrics = SpanMetrics(trace)
        out_dir = os.path.join(base, "out", f"job_{k:03d}")
        if trace:
            with record_function("bench.job"):
                status, lat = _run_job(cell, man, job, out_dir, metrics, log_path)
        else:
            status, lat = _run_job(cell, man, job, out_dir, metrics, log_path)
        done.append({"job": job, "out": out_dir, "status": status, "latency_s": lat,
                     "queries": len(job["queries"]),
                     "phases": metrics.phases})
        k += 1
    window_s = time.perf_counter() - w0
    if trace:
        window_rf.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    launches = {key: v - launches0[key] for key, v in _launches().items()}
    if k - 1 > len(jobs) - 1:
        print(f"* the window ran {k - 1} jobs; the pool holds {len(jobs) - 1}: jobs repeat *",
              file=sys.stderr)

    attempted = sum(d["queries"] for d in done)
    failed = sum(d["queries"] for d in done if d["status"] != 0)
    dev_info = {"platform": "gpu" if device is not None else "cpu",
                "kind": torch.cuda.get_device_name(0) if device is not None else "cpu",
                "count": chips if device is not None else 0,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device is not None else 0}

    # ---------------------------------------------- after the window
    from benchmark import bounds
    from benchmark.metrics import load
    from benchmark.reference import Reference
    from benchmark.trace import breakdown, reduce_profile, union_seconds

    reduced = None
    if trace:
        reduced = reduce_profile(prof)
        ops = reduced["device_ops"]
        dev_info["busy_s"] = union_seconds([(s, e) for _, s, e, _ in ops], 0.0, reduced["window_s"])
        dev_info["window_s"] = reduced["window_s"]
        del prof
    gc.collect()
    if device is not None:
        torch.cuda.empty_cache()

    rng = np.random.default_rng([seed, 1])
    finished = [d for d in done if d["status"] == 0]
    checked = finished[int(rng.integers(len(finished)))] if finished else None
    t_ref = time.perf_counter()
    ref = Reference(man["db_codes"], man["db_offsets"], cell.config["params"],
                    device if device is not None else "cpu")
    cmp = {"mismatched": 0, "missing": 0, "extra": 0, "files": 0}
    if checked is not None:
        names = checked["job"]["queries"]
        expected = ref.predictions({n: man["query_codes"][n] for n in names}, man["subst_dir"])
        cmp = compare(checked["job"], checked["out"], expected[False])
    ref_cells = None
    if trace:
        ref_cells = ref.candidate_cells({n: man["query_codes"][n]
                                         for d in finished for n in d["job"]["queries"]})
    ref.close()
    t_ref = time.perf_counter() - t_ref

    scored_on_card = (launches["kernel_launches"] + launches["resident_launches"]
                      + launches["long_launches"] + launches["i16_launches"]
                      + launches["f32_launches"])
    schedules = [_schedule(d) for d in done]

    # the cell's end-to-end metrics, or under tracing its per-layer ones,
    # each read by its own file in benchmark/metrics
    card = bounds.card() if trace and device is not None else None
    run = _Run(done, window_s, setup_s, reduced, card, ref_cells)
    metrics_out = {}
    for m in cell.metrics("per_layer" if trace else "end_to_end"):
        v = load(m["name"], os.path.join(cell.dir, "metrics"))(run)
        if v is not None:
            metrics_out[m["name"]] = {"value": v, "unit": m["unit"]}
    brk = breakdown(reduced) if trace else None

    # after every reader has run: main() looks once more before it prints
    forbidden = forbidden_loaded()
    # (value, limit): each value must be <= its limit, except where the
    # name says "at_least"
    checks = {
        "files_mismatched": (cmp["mismatched"], 0),
        "files_missing": (cmp["missing"], 0),
        "files_extra": (cmp["extra"], 0),
        "jobs_failed": (sum(d["status"] != 0 for d in done), 0),
        "jobs_off_schedule": (sum(s != cell.config["schedule"] for s in schedules), 0),
        "jax_modules_loaded": (len(forbidden), 0),
    }
    if device is not None:
        checks["plain_calls_on_card"] = (launches["twin_calls_on_cuda"], 0)
        checks["sw_launches_on_card_at_least"] = (scored_on_card, 1)
    correct = checked is not None and all(
        (v >= lim) if name.endswith("_at_least") else (v <= lim)
        for name, (v, lim) in checks.items())

    shm_after = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    info = {
        "generate_s": t_gen, "warmup_job_s": warm_s, "jobs": len(done), "window_s": window_s,
        "db_residues": man["db_residues"], "homologs": man["homologs"],
        "checked_job_queries": len(checked["job"]["queries"]) if checked else 0,
        "reference_s": t_ref, "reference_stages_s": ref.times, "launches": launches,
        "schedule": sorted(set(schedules)),
        "dev_shm_new": sorted(shm_after - shm_before),
        "job_s": [[round(d["latency_s"], 3)] + [round(d["phases"].get(p, {}).get("seconds", 0.0), 3)
                                                 for p in ("search", "align", "select", "predict")]
                  for d in done],
        "ref_cells": ref_cells,
    }
    if card is not None:
        info["card"] = card
    shutil.rmtree(base, ignore_errors=True)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics_out, "device": dev_info}
    if trace:
        result["breakdown"] = brk
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return {"result": result, "info": info}


class _Run:
    """What a metric's reader sees (benchmark/metrics/__init__.py)."""

    def __init__(self, jobs, window_s, setup_s, trace, card, ref_cells):
        self.jobs = jobs
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace
        self.card = card
        self.ref_cells = ref_cells


def main(argv=None, root: str = ROOT, **run_options) -> int:
    """The command line; ``root`` and ``run_options`` (``run_cell``'s
    keywords) serve the benchmark's own tests."""
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), **run_options)
    line = json.dumps(out["result"])
    print(json.dumps(out["info"]), file=sys.stderr)
    # the last look, once everything but the printing has run
    forbidden = forbidden_loaded()
    if forbidden:
        out["result"]["check"]["jax_modules_loaded"] = {"value": len(forbidden), "limit": 0}
        print(f"error: modules of JAX or the JAX package loaded: {forbidden}", file=sys.stderr)
    for k, c in out["result"]["check"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    if forbidden:
        return 3
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The harness: metric arithmetic, the result line, the import checks, and
a cell made only of added files (CPU, small runs on the native backend)."""

import json
import os
import shutil

import pytest

from benchmark import bounds
from benchmark.metrics import load
from benchmark.run import forbidden_loaded, reference_imports
from benchmark.trace import breakdown, gaps, label_at, union_seconds
from benchmark.tests import tiny

METRICS_DIR = os.path.join(tiny.ROOT, "benchmark", "metrics")


class _Run:
    def __init__(self, jobs=(), trace=None, card=None, ref_cells=None):
        self.jobs, self.trace, self.card, self.ref_cells = list(jobs), trace, card, ref_cells


def _job(queries, latency, status=0, **phases):
    return {"queries": queries, "latency_s": latency, "status": status,
            "phases": {k.replace("__", "."): v for k, v in phases.items()}}


def test_union_and_gaps():
    iv = [(0.5, 1.0), (0.8, 1.5), (2.0, 2.5), (-1.0, 0.1), (3.5, 9.0)]
    assert union_seconds(iv, 0.0, 4.0) == pytest.approx(0.1 + 1.0 + 0.5 + 0.5)
    assert gaps(iv, 0.0, 4.0) == [(0.1, 0.5), (1.5, 2.0), (2.5, 3.5)]
    assert gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def test_device_idle_share_from_kernel_intervals():
    ops = [("k1", 0.0, 1.0, True), ("k2", 0.5, 2.0, True), ("Memcpy HtoD", 5.0, 9.0, False)]
    run = _Run(trace={"window_s": 10.0, "device_ops": ops, "ranges": []})
    assert load("device_idle_pct.batch", METRICS_DIR)(run) == pytest.approx(80.0)
    assert load("device_idle_pct.batch", METRICS_DIR)(_Run()) is None


def test_sw_roofline_from_fixed_card():
    card = {"sw_cells_per_s": bounds.sw_cells_per_s(132, 1980.0)}
    assert card["sw_cells_per_s"] == pytest.approx(3717.12e9)
    ops = [("void sift4g::sw_tiled_kernel<0, sift4g::SlabRows>(int)", 0.0, 0.5, True),
           ("void sift4g::(anonymous namespace)::sw_long_kernel<0, false>(int)", 1.0, 1.5, True),
           ("at::native::topk", 2.0, 9.0, True), ("Memcpy HtoD", 0.0, 9.0, False)]
    run = _Run(trace={"window_s": 10.0, "device_ops": ops, "ranges": []}, card=card,
               ref_cells=int(3717.12e9 * 0.25))
    # 0.25 s of cells at the bound over 1.0 s of SW kernels
    assert load("sw_roofline_pct.batch", METRICS_DIR)(run) == pytest.approx(25.0)
    run.ref_cells = None
    assert load("sw_roofline_pct.batch", METRICS_DIR)(run) is None


def test_per_query_metrics_over_every_finished_job():
    jobs = [_job(10, 5.0, search={"seconds": 1.0}, align={"seconds": 2.0},
                 align__dispatch={"seconds": 0.2}, align__traceback={"seconds": 1.5},
                 select={"seconds": 0.3}, predict={"seconds": 1.0}),
            _job(30, 6.0, search={"seconds": 2.0, "overlapped": 1.0}, align={"seconds": 1.2},
                 select={"seconds": 0.4}, predict={"seconds": 2.0}),
            _job(50, 1.0, status=-1, search={"seconds": 9.0})]
    run = _Run(jobs)
    assert load("search_ms_per_query.batch", METRICS_DIR)(run) == pytest.approx(3000 / 40)
    assert load("dispatch_ms_per_query.batch", METRICS_DIR)(run) == pytest.approx(200 / 40)
    # the overlapped job's align phase is its traceback
    assert load("traceback_ms_per_query.batch", METRICS_DIR)(run) == pytest.approx(2700 / 40)
    assert load("predict_ms_per_query.batch", METRICS_DIR)(run) == pytest.approx(3000 / 40)
    outside = (5.0 - 4.3) + (6.0 - 5.6)
    assert load("outside_phases_ms_per_query.batch", METRICS_DIR)(run) == pytest.approx(1e3 * outside / 40)
    assert load("search_ms_per_query.batch", METRICS_DIR)(_Run()) is None


def test_breakdown_labels_idle_time_by_host_range():
    trace = {"window_s": 4.0,
             "device_ops": [("kA", 0.0, 1.0, True), ("kB", 1.0, 1.5, True), ("kA", 3.0, 3.5, True)],
             "ranges": [("bench.job", 0.0, 3.9), ("phase:search", 0.0, 1.2),
                        ("phase:predict", 1.6, 3.0)]}
    assert label_at(trace["ranges"], 1.4) == "job.outside_phases"
    assert label_at(trace["ranges"], 3.95) == "harness"
    b = breakdown(trace)
    assert b["device_ops"] == [["kA", 1.5], ["kB", 0.5]]
    # idle 1.5-3.0 is outside the phases until 1.6, then in predict; 3.5-4.0
    # is outside the phases until the job ends at 3.9, then the harness's
    assert dict((k, pytest.approx(v)) for k, v in b["idle_gaps"]) == {
        "predict": 1.4, "job.outside_phases": 0.5, "harness": 0.1}


def test_forbidden_modules_compared_by_whole_top_level_name():
    names = ["sift4g_tpu_torch", "sift4g_tpu_torch.cli", "jaxtyping", "flaxen", "numpy",
             "sift4g_tpu.align", "jaxlib.xla_client", "jax", "flax.linen"]
    assert forbidden_loaded(names) == ["flax.linen", "jax", "jaxlib.xla_client", "sift4g_tpu.align"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert reference_imports(os.path.join(tiny.ROOT, "benchmark", "reference")) == []
    (tmp_path / "a.py").write_text("import numpy\nfrom sift4g_tpu_torch.align import batch\n")
    (tmp_path / "b.py").write_text("import jax.numpy as jnp\nfrom . import a\nimport sift4g_tpu_torchx\n")
    assert reference_imports(str(tmp_path)) == ["a.py: sift4g_tpu_torch.align", "b.py: jax.numpy"]


def _check_line(res, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert json.loads(json.dumps(res)) == res
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert len(res["breakdown"]["device_ops"]) <= 10
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_small_run_of_each_cell_matches_the_reference(workload):
    out = tiny.run(workload)
    res = out["result"]
    _check_line(res, trace=False)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    # all the work over all the time: finished queries over the window
    assert res["metrics"]["queries_per_s"]["value"] == pytest.approx(
        res["attempted"] / out["info"]["window_s"])
    assert out["info"]["checked_job_queries"] == 6


def test_small_traced_run_reports_every_per_layer_metric_it_can_read():
    out = tiny.run("swissprot-subst.proteome", trace=True)
    res = out["result"]
    _check_line(res, trace=True)
    assert res["correct"] is True
    # on the CPU there is no device trace and no card: the readers of the
    # device's metrics find nothing and the metrics are left out
    assert set(res["metrics"]) == {"search_ms_per_query.batch", "dispatch_ms_per_query.batch",
                                   "traceback_ms_per_query.batch", "predict_ms_per_query.batch",
                                   "outside_phases_ms_per_query.batch", "device_idle_pct.batch"}
    assert res["metrics"]["device_idle_pct.batch"]["value"] == 100.0
    assert out["info"]["ref_cells"] > 0


def test_a_cell_of_added_files_runs_without_editing_any(tmp_path):
    """A later PR adds a traffic file, a metric reader and their entries."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    (root / "benchmark" / "traffic" / "pairs.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "job_queries": 2, "flags": [], "why": "two at a time"}))
    (root / "benchmark" / "metrics" / "jobs_in_window.pairs.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    spec["workloads"].append({"name": "swbench-matrix.pairs", "config": "swbench-matrix",
                              "traffic": "pairs", "chips": 1, "why": "pairs of queries"})
    spec["per_layer"].append({"name": "jobs_in_window.pairs", "unit": "jobs", "better": "higher",
                              "source": "host_clock", "layer": "CLI and job",
                              "moves": "queries_per_s", "workloads": ["swbench-matrix.pairs"]})
    spec["end_to_end"][0].setdefault("workloads", [w["name"] for w in spec["workloads"]])
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    from benchmark.run import run_cell

    out = run_cell(str(root), "swbench-matrix.pairs", 9, 0.5, True, require_cuda=False,
                   config_edit=tiny.config, program_flags=tiny.CPU_FLAGS)
    assert out["result"]["correct"] is True
    assert out["result"]["metrics"]["jobs_in_window.pairs"]["value"] >= 1
    assert out["info"]["checked_job_queries"] == 2
    for p, data in before.items():
        assert p.read_bytes() == data


def test_a_reader_that_loads_jax_leaves_the_run_without_a_result(tmp_path, capsys):
    """The look for JAX comes after every metric reader: one that loads a
    forbidden module (here it plants ``flax`` as ``import flax`` would)
    leaves no result line and a non-zero exit."""
    import sys

    from benchmark.run import main

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(tiny.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    (root / "benchmark" / "metrics" / "leaky_rate.py").write_text(
        "import sys\nimport types\n\nsys.modules['flax'] = types.ModuleType('flax')\n\n\n"
        "def read(run):\n    return 1.0\n")
    spec["end_to_end"].append({"name": "leaky_rate", "unit": "queries/s", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["swbench-matrix.long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    had = sys.modules.pop("flax", None)
    try:
        rc = main(["--workload", "swbench-matrix.long", "--seed", "11", "--seconds", "0.5",
                   "--trace", "0"], root=str(root), require_cuda=False,
                  config_edit=tiny.config, traffic_edit=tiny.traffic,
                  program_flags=tiny.CPU_FLAGS)
    finally:
        sys.modules.pop("flax", None)
        if had is not None:
            sys.modules["flax"] = had
    out, err = capsys.readouterr()
    assert rc != 0
    assert '"correct"' not in out
    assert "['flax']" in err and "check jax_modules_loaded: 1 (limit 0)" in err


def test_a_job_off_the_stated_schedule_is_not_correct():
    """The configuration states the schedule its jobs run in; a run whose
    jobs take the other one (here two-phase, ``--overlap off``) fails."""
    from benchmark.run import run_cell

    out = run_cell(tiny.ROOT, "swbench-matrix.long", 13, 0.5, False, require_cuda=False,
                   config_edit=tiny.config, traffic_edit=tiny.traffic,
                   program_flags=tiny.CPU_FLAGS + ("--overlap", "off"))
    assert out["info"]["schedule"] == ["two-phase"]
    assert out["result"]["check"]["jobs_off_schedule"]["value"] >= 1
    assert out["result"]["correct"] is False

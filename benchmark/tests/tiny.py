"""Small configurations and traffic for the benchmark's CPU tests: the
cells' shapes, cut to a few thousand sequences and short queries."""

import json
import os
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("swissprot-subst.proteome", "swbench-matrix.long")
CPU_FLAGS = ("--backend", "native", "-t", "2")
# cells whose configuration and traffic files are in benchmark/ but whose
# entries BENCHMARK.json does not hold (PERF.md, open questions: the
# subst-mode cell's runs spread more than any bound holds); the tests run
# them from a root that adds the entry beside the same files
SPARE = {"swissprot-subst.proteome": {"config": "swissprot-subst", "traffic": "proteome"}}


def root_for(workload: str) -> str:
    """ROOT where BENCHMARK.json names ``workload``; else a root under
    TMPDIR whose BENCHMARK.json adds it, with ``benchmark/`` linked."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    if any(w["name"] == workload for w in spec["workloads"]):
        return ROOT
    spec["workloads"].append({"name": workload, **SPARE[workload], "chips": 1,
                              "why": "a spare cell, run by the tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(workload)
    root = tempfile.mkdtemp(prefix="bench_root_")
    os.symlink(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root


def config(cfg):
    cfg["database"]["sequences"] = 3000
    cfg["database"]["families"]["max_size"] = 30
    q = cfg["queries"]["set_lengths"]
    if "lognormal" in q:
        q["lognormal"].update(count=6, median=120, mean=150, max=300)
    else:
        q["list"] = [60, 90, 150, 200, 250, 310]
    cfg["queries"]["sets"] = 4


def traffic(tr):
    tr["job_queries"] = 6


def load_config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    config(cfg)
    return cfg


def run(workload, seed=5, trace=False, seconds=1.0):
    from benchmark.run import run_cell

    return run_cell(root_for(workload), workload, seed, seconds, trace, require_cuda=False,
                    config_edit=config, traffic_edit=traffic, program_flags=CPU_FLAGS)

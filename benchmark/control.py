"""The control of ``correct``: the plain reference in the program's place,
every float one step below what SIFT4G states: the SIFT math in float32
(float64 stated) and the selection's entropies in bfloat16 (float32
stated, quirk Q9).

    python3 -m benchmark.control --workload NAME --seeds 1,2,3

For each seed it generates the cell's inputs as a run does, takes one job
of the cell's traffic (the first after the warm-up, of the size a run
checks), computes every .SIFTprediction text as stated and one step lower from
the same alignments, and compares them as a run compares the program's
files with the reference's.  A control that passes that comparison would
show that the comparison cannot tell the precision the configuration
states from the one below it.  One JSON line a seed.  The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

def control(root: str, workload: str, seed: int, device, config_edit=None,
            traffic_edit=None) -> dict:
    from benchmark.gen.synth import generate
    from benchmark.reference import Reference
    from benchmark.run import Cell

    cell = Cell(root, workload)
    if config_edit is not None:
        config_edit(cell.config)
    if traffic_edit is not None:
        traffic_edit(cell.traffic)
    base = os.path.join(tempfile.gettempdir(), "sift4g_bench_control")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    man = generate(cell.config, int(seed) % (1 << 63), base, int(cell.traffic["job_queries"]))
    job = man["jobs"][1]
    ref = Reference(man["db_codes"], man["db_offsets"], cell.config["params"], device)
    texts = ref.predictions({n: man["query_codes"][n] for n in job["queries"]}, man["subst_dir"],
                            lower=(False, True))
    ref.close()
    shutil.rmtree(base, ignore_errors=True)
    f64, f32 = texts[False], texts[True]
    differ = sum(f64[n] != f32[n] for n in job["queries"])
    return {"workload": workload, "seed": seed, "files": sum(v is not None for v in f64.values()),
            "files_mismatched": differ, "limit": 0, "control_correct": differ == 0,
            "seconds": time.perf_counter() - t0, "stages_s": ref.times}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control runs at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    from benchmark.run import ROOT

    for s in args.seeds.split(","):
        print(json.dumps(control(ROOT, args.workload, int(s), torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

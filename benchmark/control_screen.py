"""The control of ``correct`` for device predict in subst mode: the
program's finishers print the card's float32 screen as it is, without the
float64 re-derivation that ``sift/predict_subst.finish_subst_query`` makes
of every printed or threshold-adjacent value.

    python3 -m benchmark.control_screen --workload NAME --seeds 1,2,3

For each seed it runs the cell as ``benchmark.run`` does, for a short
window (the warm-up job and one job or more), with the finishers replaced
in this process and run on the writer threads (``SIFT4G_TPU_SUBST_PROCS``
0, so no pool process escapes the replacement), and reports how many of
the checked job's files differ from the plain reference's.  A control
that passes that comparison would show that the comparison cannot tell the
float64 the configuration states from the float32 below it.  One JSON
line a seed.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

# the window of a control run: the jobs that start in it run to their end
WINDOW_S = 1.0


def screen_only_finisher(scale: float = 1.0):
    """A finisher that writes ``scale`` times the float32 screen where
    ``finish_subst_query`` writes its float64 hybrid; the median sequence
    info stays the program's float64."""
    import numpy as np

    from sift4g_tpu_torch.sift import predict_subst as ps

    def finish(query, rows, subst_lines, f32_scores, out_path, eps_screen=None, log=None):
        L = len(query)
        screen = np.asarray(f32_scores[:L], dtype=np.float64) * scale
        total_seq = rows.shape[0]
        _, aas_stored = ps.create_matrix(rows, np.ones(total_seq))
        median_for_pos = ps.hash_predicted_pos(subst_lines)
        ps.add_pos_with_del_ref(query, screen, median_for_pos)
        ps.add_median_seq_info(rows, median_for_pos)
        ps.write_subst_predictions(subst_lines, median_for_pos, screen, aas_stored,
                                   total_seq, query, out_path)
        return ps.finish_counts(L, 0)

    return finish


@contextlib.contextmanager
def screen_only(scale: float = 1.0):
    """The program's subst finishers replaced by :func:`screen_only_finisher`
    while the block runs."""
    from sift4g_tpu_torch.sift import predict_subst as ps

    real, knob = ps.finish_subst_query, os.environ.get("SIFT4G_TPU_SUBST_PROCS")
    ps.finish_subst_query = screen_only_finisher(scale)
    os.environ["SIFT4G_TPU_SUBST_PROCS"] = "0"
    try:
        yield
    finally:
        ps.finish_subst_query = real
        if knob is None:
            os.environ.pop("SIFT4G_TPU_SUBST_PROCS", None)
        else:
            os.environ["SIFT4G_TPU_SUBST_PROCS"] = knob


def control(root: str, workload: str, seed: int, scale: float = 1.0, **run_options) -> dict:
    """One seed's control; ``run_options`` are ``benchmark.run.run_cell``'s
    keywords (the tests' small runs without a card)."""
    from benchmark.run import run_cell

    t0 = time.perf_counter()
    with screen_only(scale):
        out = run_cell(root, workload, seed, WINDOW_S, False, **run_options)
    check = out["result"]["check"]
    return {"workload": workload, "seed": seed, "scale": scale,
            "checked_queries": out["info"]["checked_job_queries"],
            "files_mismatched": check["files_mismatched"]["value"],
            "files_missing": check["files_missing"]["value"],
            "limit": 0, "control_correct": out["result"]["correct"],
            "jobs": out["info"]["jobs"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_screen")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control runs at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    from benchmark.run import ROOT

    for s in args.seeds.split(","):
        print(json.dumps(control(ROOT, args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

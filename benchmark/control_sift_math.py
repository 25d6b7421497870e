"""The control of ``correct`` with the SIFT math alone one step lower: the
plain reference's float64 SIFT math in float32, its selection entropies in
the float32 that SIFT4G states (``benchmark.control`` lowers both).

    python3 -m benchmark.control_sift_math --workload NAME --seeds 1,2,3

It runs ``benchmark.control`` with the reference's selection held at its
stated precision, so that the files that differ come from the SIFT math
alone: the layer that device predict's float32 screen and float64
re-derivation replace.  One JSON line a seed.  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


@contextlib.contextmanager
def selection_as_stated():
    """``reference.sift.alignments_select`` computes in float32 whatever
    ``lower`` it is given, while the block runs."""
    from benchmark.reference import sift

    real = sift.alignments_select

    def stated(rows, threshold, lower=False):
        return real(rows, threshold, False)

    sift.alignments_select = stated
    try:
        yield
    finally:
        sift.alignments_select = real


def control(root: str, workload: str, seed: int, device, **edits) -> dict:
    """One seed's control; ``edits`` are ``benchmark.control.control``'s
    ``config_edit`` and ``traffic_edit``."""
    from benchmark import control as lowered

    with selection_as_stated():
        out = lowered.control(root, workload, seed, device, **edits)
    out["lowered"] = "sift_math"
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control_sift_math")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control runs at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    from benchmark.run import ROOT

    for s in args.seeds.split(","):
        print(json.dumps(control(ROOT, args.workload, int(s), torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

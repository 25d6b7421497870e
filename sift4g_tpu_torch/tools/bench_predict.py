"""Device-predict phase benchmark on synthetic prepared rows.

    python -m sift4g_tpu_torch.tools.bench_predict --n 2000 [--qchunk 64] [--device cuda]

The port of ``tools/bench_predict.py``: isolates
``sift/predict_batch.py`` from the pipeline.  It makes ``--n`` queries
with the JAX tool's shape mix (seed 7: 280-439 residues, 350-400 rows of
random standard letters), runs ``predict_matrix_batch`` twice (cold, then
warm) and prints each run's time with its pack/fetch/write split, one
line each, then one JSON line with both runs, the chunk widths, the
card's name and power limit and the peak device bytes a cell of a chunk
took against ``predict_batch.BYTES_PER_CELL``.  ``--qchunk`` sets the
queries per chunk (0: sized to the card's free memory).  Without a card
``--device cuda`` (the default) exits 1; ``--device cpu`` runs on the
host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def make_inputs(n: int, seed: int = 7):
    """The JAX tool's synthetic mix: (queries, prepared rows)."""
    import numpy as np

    from ..core.chain import Chain

    rng = np.random.default_rng(seed)
    queries, prepared = [], []
    for i in range(n):
        L = int(rng.integers(280, 440))
        rows_n = int(rng.integers(350, 401))
        rows = rng.integers(0, 20, size=(rows_n, L)).astype(np.uint8)
        letters = (rows[0] + ord("A")).tobytes().decode()
        queries.append(Chain.from_string(f"q{i:05d}", letters))
        prepared.append(rows)
    return queries, prepared


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sift4g_tpu_torch.tools.bench_predict")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--qchunk", type=int, default=0,
                    help="queries per chunk (0: sized to the card's free memory)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default="",
                    help="directory for the .SIFTprediction files (default: a "
                    "temporary directory, removed after)")
    args = ap.parse_args(argv)

    import torch

    from ..align.roofline import nvidia_smi
    from ..sift import predict_batch as pb
    from ..utils import PhaseMetrics

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device is visible (ask for --device cpu)", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    queries, prepared = make_inputs(args.n)
    print(f"inputs: {args.n} queries in {time.perf_counter() - t0:.2f}s", flush=True)
    out = args.out or tempfile.mkdtemp(prefix="bench-predict-")
    os.makedirs(out, exist_ok=True)
    buckets = pb.bucket_shapes([r.shape[1] for r in prepared], [r.shape[0] for r in prepared])
    widths = pb.chunk_widths(buckets, device, args.qchunk)
    runs = []
    try:
        for tag in ("cold", "warm"):
            m = PhaseMetrics(log=sys.stderr, enabled=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            pb.predict_matrix_batch(queries, prepared, out, q_chunk=args.qchunk,
                                    metrics=m, device=device)
            dt = time.perf_counter() - t0
            run = {"tag": tag, "seconds": dt,
                   **{k: v.get("seconds", 0.0) for k, v in m.phases.items()}}
            if device.type == "cuda":
                peak = torch.cuda.max_memory_allocated(device) - base
                cells = max(k[0] * k[1] * widths[k] for k in buckets)
                run["peak_bytes"] = peak
                run["peak_bytes_per_cell"] = peak / cells
            runs.append(run)
            print(f"predict[{tag}] n={args.n} device={device}: {dt:.3f}s  "
                  + "  ".join(f"{k}={v:.3f}s" for k, v in run.items()
                              if k.startswith("predict.")), flush=True)
    finally:
        if not args.out:
            shutil.rmtree(out, ignore_errors=True)
    print(json.dumps({
        "n": args.n, "device": str(device),
        "card": ", ".join(nvidia_smi("name,power.limit")) if device.type == "cuda" else None,
        "bytes_per_cell_planned": pb.BYTES_PER_CELL,
        "buckets": len(buckets),
        "chunks": sum(-(-len(v) // widths[k]) for k, v in buckets.items()),
        "widths": sorted(set(widths.values())),
        "runs": runs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

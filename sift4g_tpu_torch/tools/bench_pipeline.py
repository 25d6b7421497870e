"""End-to-end pipeline benchmark of the port on a synthetic database.

Usage:
  python -m sift4g_tpu_torch.synthetic /tmp/synth --n-db 20000 --n-q 10
  python -m sift4g_tpu_torch.tools.bench_pipeline /tmp/synth [--backend cuda] [--max-candidates 5000]

The twin of ``tools/bench_pipeline.py``: runs the port's ``run_pipeline``
with ``PhaseMetrics`` and prints the per-phase timings and a queries/s
line per run on stderr.  ``--backend`` is ``cuda`` (the default: K1, or
K3 under ``--resident-db``, on the card), ``native`` (the threaded C++ DP)
or ``torch`` (the plain PyTorch scorer on the CPU); ``cuda`` without a
card exits 1 with ``error: no CUDA device ...``.

Multi-run protocol: ``--repeat`` runs cold then warm, ``--json F``
appends one JSON line per run (tag, total_s, queries, backend, phases),
and ``--aggregate F [F ...]`` prints, per file, the best-of-phases
composite over its warm runs beside the best single-run total.

``--predict-backend device`` scores the predictions in float32 on the
run's first device (the card under ``cuda``, the CPU under ``torch``);
``--overlap auto|on|off`` picks the schedule as the CLI does, and
``--overlap-ab`` runs cold (on), then warm off, on, off, on in one
process, the arms interleaved so that drift hits both, as the JAX tool
does.  ``--predict-ab`` does the same for ``--predict-backend`` (cold
device, then warm host, device, host, device), a port-only flag.  The JAX
tool's ``--cpu`` (a ``jax.config`` switch) is gone:
``--backend torch`` is the port's CPU path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def aggregate(paths):
    """Per input file: phase-level best-of composite over its warm runs
    + best single-run total.  One summary line per file and mode."""
    for path in paths:
        runs = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    runs.append(json.loads(line))
        warm = [r for r in runs if not r.get("tag", "").startswith("cold")]
        pool = warm or runs
        if not pool:
            print(f"{path}: no runs", file=sys.stderr)
            continue
        # subst-mode predict is a different computation: pool per mode
        by_mode = {}
        for r in pool:
            mode = "subst" if "subst" in r.get("tag", "") else "matrix"
            by_mode.setdefault(mode, []).append(r)
        for mode, mpool in sorted(by_mode.items()):
            # top-level phases only (align.fetch etc. nest inside)
            best = {}
            for r in mpool:
                for name, d in r.get("phases", {}).items():
                    if "." in name:
                        continue
                    s = d.get("seconds", 0.0)
                    if name not in best or s < best[name]:
                        best[name] = s
            composite = sum(best.values())
            best_total = min(r["total_s"] for r in mpool)
            q = mpool[0].get("queries", 0)
            phase_str = " ".join(f"{k}={v:.1f}" for k, v in sorted(best.items()))
            print(
                f"{path} [{mode}]: {len(mpool)} warm runs | "
                f"composite(best-of-phases) {composite:.1f}s "
                f"({q / composite:.1f} q/s) | best single run "
                f"{best_total:.1f}s | {phase_str}"
            )
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sift4g_tpu_torch.tools.bench_pipeline")
    ap.add_argument("data_dir", nargs="?")
    ap.add_argument("--aggregate", nargs="+", metavar="RUNS_JSONL",
                    help="aggregate mode: phase-level best-of composite "
                    "per runs file (no benchmark is executed)")
    ap.add_argument("--json", default="",
                    help="append one JSON line per run (tag, total_s, "
                    "queries, phases) to this file; feeds --aggregate")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "native", "torch"])
    ap.add_argument("--max-candidates", type=int, default=5000)
    ap.add_argument("--out", default="")
    ap.add_argument("--repeat", action="store_true",
                    help="run twice; the second (warm) run excludes the kernels' build")
    ap.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                    help="prefilter/align overlap mode (A/B knob)")
    ap.add_argument("--predict-backend", default="host", choices=["host", "device"],
                    help="prediction path (device = bucketed float32 batches on "
                    "the run's first device)")
    ap.add_argument("--subst", default="",
                    help="substitutions directory (subst-mode benchmark)")
    ap.add_argument("--also-subst", default="", metavar="DIR",
                    help="after the scheduled runs, run two more WARM "
                    "passes with --subst DIR in the same process")
    ap.add_argument("--resident-db", default="auto", choices=["auto", "on", "off"],
                    help="device-resident database scoring (A/B knob)")
    ap.add_argument("--overlap-ab", action="store_true",
                    help="cold + four warm runs A/B-ing overlap on/off in one "
                    "process")
    ap.add_argument("--predict-ab", action="store_true",
                    help="cold + four warm runs A/B-ing --predict-backend "
                    "host/device in one process")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.aggregate:
        return aggregate(args.aggregate)
    if not args.data_dir:
        ap.error("data_dir is required unless --aggregate is given")

    from ..align import resolve_backend
    from ..pipeline import PipelineConfig, ResidentRefused, run_pipeline
    from ..utils import PhaseMetrics

    try:
        backend, devices = resolve_backend(args.backend)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    out_dir = args.out or os.path.join(args.data_dir, "out")
    os.makedirs(out_dir, exist_ok=True)
    cfg = PipelineConfig(
        query_path=os.path.join(args.data_dir, "queries.fa"),
        database_path=os.path.join(args.data_dir, "db.fa"),
        out_path=out_dir,
        align_backend=backend,
        max_candidates=args.max_candidates,
        subst_path=args.subst,
        timings=True,
        overlap=args.overlap,
        predict_backend=args.predict_backend,
        resident_db=args.resident_db,
    )
    if args.overlap_ab and args.predict_ab:
        ap.error("--overlap-ab and --predict-ab are separate A/Bs")
    pb = args.predict_backend
    if args.overlap_ab:
        # one process: cold (on), then the warm arms interleaved
        schedule = [("cold", "on", pb), ("warm-off", "off", pb), ("warm-on", "on", pb),
                    ("warm-off2", "off", pb), ("warm-on2", "on", pb)]
    elif args.predict_ab:
        ov = args.overlap
        schedule = [("cold", ov, "device"), ("warm-host", ov, "host"),
                    ("warm-device", ov, "device"), ("warm-host2", ov, "host"),
                    ("warm-device2", ov, "device")]
    else:
        schedule = [(t, args.overlap, pb)
                    for t in (["cold", "warm"] if args.repeat else ["cold"])]
    if args.also_subst:
        schedule += [("subst-warm1", args.overlap, pb), ("subst-warm2", args.overlap, pb)]
    for tag, ov, pb in schedule:
        cfg.subst_path = args.also_subst if tag.startswith("subst") else args.subst
        cfg.overlap = ov
        cfg.predict_backend = pb
        cfg.metrics = PhaseMetrics(log=sys.stderr, enabled=True)
        t0 = time.perf_counter()
        try:
            queries = run_pipeline(cfg, devices)
        except ResidentRefused as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        dt = time.perf_counter() - t0
        print(
            f"pipeline[{tag}]: {len(queries)} queries in {dt:.2f}s "
            f"-> {len(queries) / dt:.3f} queries/s "
            f"[backend={args.backend} overlap={ov} "
            f"overlapped={int('overlapped' in cfg.metrics.phases.get('search', {}))} "
            f"predict={pb}]",
            file=sys.stderr,
        )
        if args.json:
            with open(args.json, "a") as fh:
                fh.write(json.dumps({
                    "tag": tag,
                    "total_s": round(dt, 3),
                    "queries": len(queries),
                    "backend": args.backend,
                    "overlap": ov,
                    "predict_backend": pb,
                    "phases": cfg.metrics.phases,
                }) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

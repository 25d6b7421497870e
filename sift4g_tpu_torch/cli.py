"""Command-line interface of the PyTorch port.

The flag surface and validation of ``sift4g_tpu/cli.py`` (the reference's
getopt surface, main.cpp:21-42 and :163-186).  The scorer backend picks
the devices: ``cuda`` (the default, also ``auto``) runs the grouped CUDA
kernel on the cards of ``--cards`` (a digit string, as the reference's
getCudaCards reads it, main.cpp:254-262) or, without it, on every visible
card, each launch split across them; ``torch`` runs its plain PyTorch
twin on the CPU and ``native`` the threaded C++ DP, both ignoring
``--cards``.  A host without a GPU is refused under ``cuda``; nothing
falls back to the CPU.  A card listed twice is refused: the JAX CLI
fails on it with a traceback from ``jax.device_put`` (its mesh needs
distinct devices).

``--resident-db`` works as in the JAX package, with the rule of
``pipeline._resident_refusal``; ``on`` that cannot hold the database
fails with the reason instead of quietly keeping the slab path.

``--predict-backend device`` scores predictions in float32 on the first
device of the run (``--cards``' first card or ``cuda:0`` under ``cuda``,
the CPU under ``torch`` and ``native``), through
``sift/predict_batch.py``.  ``--overlap`` overlaps the database search
with device scoring (``pipeline._overlap_cache``): ``auto`` takes it
under ``--backend cuda`` on a host with at least 8 available cores and a
parse cache, as the JAX package does on an accelerator; ``on`` forces it
(the CPU tests); an overlapped run never builds the resident database.

``--serve SOCKET`` runs the daemon of ``serve.py`` (jobs back to back in
one warm process), ``--connect SOCKET`` ships the rest of the command
line to it as a job, and ``--connect SOCKET --shutdown`` stops it; these
are read before the full parse, as in the JAX CLI.  A multi-host run
(``SIFT4G_COORDINATOR``/``_NUM_PROCESSES``/``_PROCESS_ID``, or
``SIFT4G_MULTIHOST=auto`` under ``torchrun``) joins a gloo process group
after the flags are validated and runs each query file through
``parallel/multihost.py``, sharded by ``--mh-shard``; every process runs
on its own devices (``--cards``, or every card it sees).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .align import BACKENDS, resolve_backend
from .core.scorers import create_scorer
from .parallel.multihost import init_distributed_from_env, run_pipeline_multihost


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sift4g-tpu-torch",
        description="SIFT4G on an NVIDIA GPU (PyTorch + CUDA): predicts whether "
        "amino-acid substitutions are TOLERATED or DELETERIOUS.",
    )
    p.add_argument("-q", "--query", required=True,
                   help="input fasta query file, or a directory of .fa/.fasta "
                   "files processed sequentially in one process")
    p.add_argument("-d", "--database", required=True, help="input fasta database file")
    p.add_argument("-g", "--gap-open", type=int, default=10,
                   help="gap opening penalty (default: 10)")
    p.add_argument("-e", "--gap-extend", type=int, default=1,
                   help="gap extension penalty (default: 1; must be <= gap-open)")
    p.add_argument("--matrix", default="BLOSUM_62",
                   help="similarity matrix: BLOSUM_30/45/50/62/70/80/90/250 "
                   "(default: BLOSUM_62)")
    p.add_argument("--evalue", type=float, default=0.0001,
                   help="evalue threshold; higher-evalue alignments are filtered")
    p.add_argument("--max-aligns", type=int, default=400,
                   help="maximum number of alignments (default: 400)")
    p.add_argument("--algorithm", default="SW", choices=["SW", "NW", "HW", "OV"],
                   help="alignment algorithm (default: SW)")
    p.add_argument("--out", default="", help="output directory for SIFT predictions")
    p.add_argument("--sub-results", action="store_true",
                   help="write alignment file and per-query selected alignments")
    p.add_argument("--outfmt", default="bm9", choices=["bm0", "bm8", "bm9", "light"],
                   help="alignment file format (default: bm9)")
    p.add_argument("--kmer-length", type=int, default=5,
                   help="k-mer length for database search: 3, 4 or 5 (default: 5)")
    p.add_argument("--max-candidates", type=int, default=5000,
                   help="sequences forwarded to the alignment phase (default: 5000)")
    p.add_argument("--median-threshold", type=float, default=2.75,
                   help="alignment diversity threshold (default: 2.75)")
    p.add_argument("--subst", default="",
                   help="directory containing per-query .subst files")
    p.add_argument("--seq-id", type=int, default=100,
                   help="drop alignments this %% identical to the query (default: 100)")
    p.add_argument("-t", "--threads", type=int, default=8,
                   help="host threads for search, traceback, selection and "
                   "prediction (default: 8)")
    p.add_argument("--cards", default="",
                   help="CUDA cards used for alignment, as a digit string like "
                   "the reference's (e.g. '02' = cuda:0 and cuda:2); default: "
                   "every visible card. Ignored by --backend torch and native")
    p.add_argument("--backend", default="auto", choices=list(BACKENDS),
                   help="alignment scoring backend (default: auto = cuda, the "
                   "grouped CUDA kernel; torch = its PyTorch twin on the CPU; "
                   "native = the threaded C++ DP)")
    p.add_argument("--predict-backend", default="host", choices=["host", "device"],
                   help="prediction math: host (float64, the default) or device "
                   "(batched float32 on the run's first device; subst-mode "
                   "files stay byte-identical to host)")
    p.add_argument("--timings", action="store_true",
                   help="print per-phase wall-clock and throughput counters")
    p.add_argument("--cache-dir", default="",
                   help="directory for the binary FASTA parse caches "
                   "(default: next to each input file). Equivalent to "
                   "SIFT4G_TPU_CACHE_DIR")
    p.add_argument("--overlap", default="auto", choices=["auto", "on", "off"],
                   help="overlap the prefilter scan with device scoring (auto: "
                   "under --backend cuda with >= 8 available cores and a parse "
                   "cache; on: always; off: the reference's two-phase order)")
    p.add_argument("--resident-db", default="auto", choices=["auto", "on", "off"],
                   help="device-resident database scoring: upload the slot-packed "
                   "database once and ship offsets instead of target bytes. "
                   "auto = on a CUDA card when the candidates' bytes exceed the "
                   "database's (default); on = always (fails if it cannot); "
                   "no effect under --backend native")
    p.add_argument("--resume", action="store_true",
                   help="skip queries whose .SIFTprediction already exists "
                   "in --out (remaining outputs are byte-identical to a full "
                   "run). Incompatible with --sub-results")
    p.add_argument("--mh-shard", default="db", choices=["db", "queries"],
                   help="multi-host partition axis: shard the database "
                   "(merge candidates and winners; few queries x a large "
                   "database) or shard the queries (each host owns a slice "
                   "end to end; the many-query missense mode)")
    p.add_argument("--serve", default="", metavar="SOCKET",
                   help="run as a long-lived daemon on this UNIX socket, "
                   "keeping the CUDA context, the kernels and the resident "
                   "database warm across jobs")
    p.add_argument("--connect", default="", metavar="SOCKET",
                   help="submit this invocation to a --serve daemon "
                   "instead of running locally")
    p.add_argument("--shutdown", action="store_true",
                   help="with --connect: stop the daemon and exit")
    p.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    return p


def _fail(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return -1


def _flag_value(argv, flag):
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return ""


def main(argv=None, metrics=None) -> int:
    """Run the CLI; ``metrics`` is an optional ``PhaseMetrics`` the phase
    timings accumulate into (benchmark harnesses read it back)."""
    raw_argv = list(sys.argv[1:] if argv is None else argv)

    # daemon and client modes run before the full parse: -q/-d are
    # required for a pipeline run, but a daemon starts without a job and
    # a client leaves validation to the daemon
    serve_sock = _flag_value(raw_argv, "--serve")
    if serve_sock:
        from .serve import serve_forever

        return serve_forever(serve_sock)
    connect_sock = _flag_value(raw_argv, "--connect")
    if connect_sock:
        from .serve import _strip_flag, submit

        if "--shutdown" in raw_argv:
            return submit(connect_sock, [], shutdown=True)
        return submit(connect_sock, _strip_flag(raw_argv, "--connect"))

    args = build_parser().parse_args(raw_argv)
    if args.shutdown:
        return _fail("--shutdown requires --connect SOCKET")

    if args.cache_dir:
        if not os.path.isdir(args.cache_dir):
            try:
                os.makedirs(args.cache_dir, exist_ok=True)
            except OSError as exc:
                return _fail(f"cannot create cache directory '{args.cache_dir}': {exc}")
        os.environ["SIFT4G_TPU_CACHE_DIR"] = args.cache_dir

    if os.path.isdir(args.query):
        query_files = sorted(
            os.path.join(args.query, f)
            for f in os.listdir(args.query)
            if f.endswith((".fa", ".fasta")) and not f.endswith(".s4gc")
        )
        if not query_files:
            return _fail(f"no .fa/.fasta files in directory '{args.query}'")
    elif os.path.isfile(args.query):
        query_files = [args.query]
    else:
        return _fail(f"invalid query file path '{args.query}'")
    if not os.path.isfile(args.database):
        return _fail(f"invalid database file path '{args.database}'")
    if not (2 < args.kmer_length < 6):
        return _fail("kmer_length possible values = 3,4,5")
    if args.max_candidates <= 0:
        return _fail("invalid max candidates number")
    if args.evalue <= 0:
        return _fail("invalid evalue")
    if args.max_aligns <= 0:
        return _fail("invalid max alignments number")
    if args.threads <= 0:
        return _fail("invalid thread number")
    if args.cards and not args.cards.isdigit():
        return _fail(f"invalid cards list '{args.cards}' (digits only, e.g. '02')")
    if len(set(args.cards)) < len(args.cards):
        return _fail(f"invalid cards list '{args.cards}' (a card is listed more than once)")
    if args.out and not os.path.isdir(args.out):
        return _fail(f"invalid out directory path '{args.out}'")
    if args.resume and args.sub_results:
        return _fail("--resume is incompatible with --sub-results (the global "
                     "alignments.txt would cover only the resumed subset)")
    if args.subst and not os.path.isdir(args.subst):
        return _fail(f"invalid substitutions directory path '{args.subst}'")
    try:
        create_scorer(args.matrix, args.gap_open, args.gap_extend)
    except ValueError as exc:
        return _fail(str(exc))
    try:
        backend, devices = resolve_backend(
            args.backend, tuple(int(c) for c in args.cards) or None
        )
    except (RuntimeError, ValueError) as exc:
        return _fail(str(exc))

    import torch.distributed as dist

    # a multi-host job?  A group this call creates is left when the run
    # ends, failed or not: one left open can hang the interpreter at exit
    owned = not dist.is_initialized()
    try:
        host_ctx = init_distributed_from_env()
    except (RuntimeError, ValueError) as exc:
        return _fail(f"cannot join the multi-host job: {exc}")
    try:
        return _run_files(args, query_files, backend, devices, metrics, host_ctx)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run_files(args, query_files, backend, devices, metrics, host_ctx) -> int:
    # imported here, not with the module: a spawn worker of the subst
    # finishers' pool re-runs the main script, which under the console
    # script imports this module, and needs no PyTorch
    from .pipeline import PipelineConfig, ResidentRefused, run_pipeline

    for query_path in query_files:
        if len(query_files) > 1:
            print(f"** Processing query file: {query_path} **", file=sys.stderr)
        cfg = PipelineConfig(
            query_path=query_path,
            database_path=args.database,
            kmer_length=args.kmer_length,
            max_candidates=args.max_candidates,
            gap_open=args.gap_open,
            gap_extend=args.gap_extend,
            matrix=args.matrix,
            max_alignments=args.max_aligns,
            max_evalue=args.evalue,
            algorithm=args.algorithm,
            median_threshold=args.median_threshold,
            subst_path=args.subst,
            out_path=args.out,
            sub_results=args.sub_results,
            resume=args.resume,
            out_format=args.outfmt,
            sequence_identity=args.seq_id,
            align_backend=backend,
            predict_backend=args.predict_backend,
            timings=args.timings,
            threads=args.threads,
            overlap=args.overlap,
            resident_db=args.resident_db,
            multihost_shard=args.mh_shard,
            metrics=metrics,
            cards=tuple(int(c) for c in args.cards) or None,
        )
        try:
            if host_ctx is not None:
                run_pipeline_multihost(cfg, host_ctx, devices)
            else:
                run_pipeline(cfg, devices)
        except ResidentRefused as exc:
            return _fail(str(exc))
    return 0


if __name__ == "__main__":
    sys.exit(main())

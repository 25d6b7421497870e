#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. device and build: versions, the card's name and power limit, and the
   build of the CUDA kernel from ``sift4g_tpu_torch/csrc``;
2. the kernel against its plain PyTorch twin on the card, exact, in all
   four alignment modes: ragged lengths with garbage tails, zero-length
   rows, a zero-length group, a 4096-wide rung and an 8192-residue query;
   the E-value screen's words must agree too;
3. kernel and twin timed with CUDA events at the bench launch shape
   (G=64 groups, B=1024 targets of 512 residues, a 360-residue query);
4. the port's CLI at Swiss-Prot scale (570,000 synthetic sequences, about
   200 M residues; 50 queries with 20 substitutions each; default flags)
   with ``--backend cuda``, held byte for byte to ``--backend native``,
   and a matrix-mode pass on 5 queries held the same way.  The kernel's
   launch counter must show the main path went through it;
5. every kernel launch of that run held to the twin on its own inputs
   (the packed slabs, uninitialized tails included), exact, and the
   largest of them timed, kernel and twin, with CUDA events.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it the card's name and power limit, and before that one JSON line
with the kernel's launches, error and times (at the main path's largest
launch).  The script never imports JAX.
"""

import sys

sys.modules["jax"] = None   # the port must run without JAX

import contextlib  # noqa: E402
import filecmp  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
MODES = ("SW", "NW", "HW", "OV")
KERNEL = {
    "name": "sw_grouped",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_grouped.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:200",
}


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def random_matrix(rng) -> np.ndarray:
    """A symmetric (26, 26) substitution table in BLOSUM's range."""
    m = rng.integers(-4, 12, (26, 26))
    return np.triu(m) + np.triu(m, 1).T


def grouped_inputs(rng, G, B, N, qlens, dev, zero_len=True):
    """Ragged grouped scorer inputs on the card: random int8 garbage past
    every target length and, with ``zero_len``, zero-length rows."""
    import torch

    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(0 if zero_len else N, N + 1, size=(G, B)).astype(np.int32)
    if zero_len:
        lens[:, -1] = 0
        lens[0, 0] = N
    mask = np.arange(N)[None, None, :] < lens[..., None]
    targets[mask] = rng.integers(0, 26, int(mask.sum()))
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets, lens)]


def phase_build():
    import torch

    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA card")
    sys.path.insert(0, ROOT)
    import sift4g_tpu_torch

    check(
        os.path.dirname(os.path.abspath(sift4g_tpu_torch.__file__)).startswith(ROOT),
        f"sift4g_tpu_torch imported from outside {ROOT}",
    )
    card = card_line()
    say(f"card: {card}  ({torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible)")
    from sift4g_tpu_torch.align import _build

    t0 = time.perf_counter()
    _build.load()
    say(f"[1] built {KERNEL['source']} with nvcc in {_build.build_seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"[1]   ptxas: {line.strip()}")
    return card


def phase_parity(dev):
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    rng = np.random.default_rng(0)
    cases = [
        # name, G, B, N, query lengths, gaps
        ("ragged", 6, 300, 512, (361, 0, 17, 128, 255, 1), (10, 1)),
        ("long rung", 2, 64, 4096, (300, 77), (11, 2)),
        ("8192-aa query", 1, 32, 512, (8192,), (10, 1)),
    ]
    max_err = 0
    for name, G, B, N, qlens, (go, ge) in cases:
        m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
        args = grouped_inputs(rng, G, B, N, qlens, dev)
        smin = torch.full((G,), 25, dtype=torch.int32, device=dev)
        for mode in MODES:
            t0 = time.perf_counter()
            got = sw_grouped.sw_scores_grouped(*args, m32, mode=mode, gap_open=go, gap_extend=ge)
            ref = scan.align_scores_grouped(*args, m32, mode=mode, gap_open=go, gap_extend=ge)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            max_err = max(max_err, err)
            check(got.shape == (G, B) and got.dtype == torch.int32, f"{name} {mode}: shape/dtype")
            check(err == 0, f"{name} {mode}: kernel differs from twin by up to {err}")
            k = min(B, 400)
            check(
                torch.equal(scan.screen_topk_words(got, smin, k),
                            scan.screen_topk_words(ref, smin, k)),
                f"{name} {mode}: screened words differ",
            )
            torch.cuda.synchronize()
            say(f"[2] {name:14s} {mode}: G={G} B={B} N={N} qlens={qlens}: kernel == twin "
                f"(max |diff| 0, {time.perf_counter() - t0:.2f} s)")
    return max_err


def _time_ms(fn, iters, warmup):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(dev, card):
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    G, B, N, m = 64, 1024, 512, 360
    rng = np.random.default_rng(42)
    m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
    args = grouped_inputs(rng, G, B, N, (m,) * G, dev, zero_len=False)

    def kernel():
        return sw_grouped.sw_scores_grouped(*args, m32)

    def twin():
        return scan.align_scores_grouped(*args, m32)

    err = int((kernel().long() - twin().long()).abs().max())
    check(err == 0, f"bench shape: kernel differs from twin by up to {err}")
    ms = _time_ms(kernel, iters=10, warmup=2)
    plain_ms = _time_ms(twin, iters=2, warmup=1)
    cells = G * B * N * m
    say(f"[3] bench shape G={G} B={B} N={N} m={m} ({cells / 1e9:.2f} G cells), {card}: "
        f"kernel {ms:.3f} ms = {cells / ms / 1e6:.2f} GCUPS; twin {plain_ms:.3f} ms = "
        f"{cells / plain_ms / 1e6:.2f} GCUPS")
    return ms, plain_ms, err


@contextlib.contextmanager
def recorded_launches():
    """Make the port's aligner keep each scorer launch's device inputs and
    output (references only: nothing is copied or synchronised), so that
    the main path's own launches can be held to the twin afterwards."""
    from sift4g_tpu_torch.align import batch

    real, launches = batch.sw_scores_grouped, []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        launches.append((args, kw, out))
        return out

    batch.sw_scores_grouped = recorded
    try:
        yield launches
    finally:
        batch.sw_scores_grouped = real


def _run_cli(args, metrics=None):
    from sift4g_tpu_torch.cli import main

    rc = main(args, metrics=metrics)
    check(rc == 0, f"CLI {' '.join(args)} exited {rc}")


def _same_tree(a, b, what):
    names = sorted(os.listdir(a))
    check(names == sorted(os.listdir(b)), f"{what}: different output file sets")
    preds = [n for n in names if n.endswith(".SIFTprediction")]
    check(bool(preds), f"{what}: no .SIFTprediction written")
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    check(not mismatch and not errors, f"{what}: files differ: {mismatch + errors}")
    return len(preds)


def phase_main_path(tmp):
    from sift4g_tpu_torch.align import sw_grouped
    from sift4g_tpu_torch.pipeline import PhaseMetrics

    data = os.path.join(tmp, "swissprot-scale")
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synthetic_db.py"), data,
         "--n-db", "570000", "--n-q", "50", "--subst-per-query", "20", "--seed", "0"],
        check=True, stdout=subprocess.DEVNULL,
    )
    say(f"[4] synthetic database: 570000 sequences, 50 queries ({time.perf_counter() - t0:.1f} s)")
    os.environ["SIFT4G_TPU_CACHE_DIR"] = os.path.join(tmp, "cache")
    q, db = os.path.join(data, "queries.fa"), os.path.join(data, "db.fa")

    outs = {b: os.path.join(tmp, f"out-{b}") for b in ("native", "cuda")}
    for o in outs.values():
        os.mkdir(o)
    # native first: it also builds the parse cache both runs then read
    t0 = time.perf_counter()
    _run_cli(["--backend", "native", "-q", q, "-d", db, "--subst", data, "--out", outs["native"]])
    native_s = time.perf_counter() - t0

    metrics = PhaseMetrics(log=sys.stderr, enabled=True)
    with recorded_launches() as recorded:
        sw_grouped.reset_counters()
        t0 = time.perf_counter()
        _run_cli(["--backend", "cuda", "--timings", "-q", q, "-d", db, "--subst", data,
                  "--out", outs["cuda"]], metrics)
        cuda_s = time.perf_counter() - t0
        launches, twin_calls = sw_grouped.kernel_launches, sw_grouped.twin_calls_on_cuda
    check(launches > 0, "the main path launched the kernel no time")
    check(twin_calls == 0, f"the main path called the twin on CUDA {twin_calls} times")
    n_pred = _same_tree(outs["cuda"], outs["native"], "subst mode")

    for name, d in metrics.phases.items():
        extra = " ".join(f"{k}={v:g}" for k, v in d.items() if k != "seconds")
        say(f"[4]   phase {name:16s} {d.get('seconds', 0.0):9.3f} s  {extra}")
    align = metrics.phases["align"]
    say(f"[4] --backend cuda: {cuda_s:.2f} s wall, align {align['cells'] / 1e9:.2f} G cells, "
        f"{align['cells'] / align['seconds'] / 1e9:.2f} GCUPS over the align phase, "
        f"kernel_launches={launches}, twin_calls_on_cuda={twin_calls}; "
        f"--backend native: {native_s:.2f} s wall; {n_pred} .SIFTprediction files "
        f"byte-identical")

    with open(q) as fh:
        records = fh.read().split(">")[1:6]
    q5 = os.path.join(tmp, "queries5.fa")
    with open(q5, "w") as fh:
        fh.write("".join(">" + r for r in records))
    for b in ("native", "cuda"):
        os.mkdir(outs[b] + "-matrix")
        _run_cli(["--backend", b, "-q", q5, "-d", db, "--out", outs[b] + "-matrix"])
    n_mat = _same_tree(outs["cuda"] + "-matrix", outs["native"] + "-matrix", "matrix mode")
    say(f"[4] matrix mode, 5 queries: {n_mat} files byte-identical to --backend native")
    check(len(recorded) == launches, f"{len(recorded)} launches recorded, {launches} counted")
    return launches, recorded


def phase_main_launches(recorded, card):
    """The main path's own kernel outputs against the twin on the same
    device inputs; the launch with the most padded cells is then timed."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    max_err, largest = 0, None
    for args, kw, out in recorded:
        q_lens, targets, lens = args[2], args[3], args[4]
        G, B, N = targets.shape
        ref = scan.align_scores_grouped(*args, **kw)
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max()) if out.numel() else 0
        max_err = max(max_err, err)
        padded = int(q_lens.long().sum()) * B * N
        true = int((q_lens.long() * lens.long().sum(dim=1)).sum())
        say(f"[5] launch {kw['mode']} G={G} B={B} N={N} qmax={int(q_lens.max())}: "
            f"{padded / 1e9:.3f} G padded cells, {true / 1e9:.3f} G true; kernel == twin "
            f"(max |diff| {err})")
        check(err == 0, f"main-path launch G={G} B={B} N={N}: kernel differs from twin by {err}")
        if largest is None or padded > largest[0]:
            largest = (padded, true, args, kw)
    padded, true, args, kw = largest
    ms = _time_ms(lambda: sw_grouped.sw_scores_grouped(*args, **kw), iters=5, warmup=1)
    plain_ms = _time_ms(lambda: scan.align_scores_grouped(*args, **kw), iters=1, warmup=0)
    G, B, N = args[3].shape
    say(f"[5] largest main-path launch G={G} B={B} N={N}, {card}: kernel {ms:.3f} ms = "
        f"{padded / ms / 1e6:.2f} GCUPS padded, {true / ms / 1e6:.2f} true; twin "
        f"{plain_ms:.3f} ms")
    return ms, plain_ms, max_err


def main() -> int:
    card = phase_build()
    import torch

    dev = torch.device("cuda", 0)
    max_err = phase_parity(dev)
    _, _, err = phase_timing(dev, card)
    tmp = tempfile.mkdtemp(prefix="sift4g-smoke-")
    try:
        launches, recorded = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ms, plain_ms, main_err = phase_main_launches(recorded, card)
    say(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max(max_err, err, main_err),
        ms=ms, plain_ms=plain_ms,
    )]}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

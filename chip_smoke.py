#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:

1. device and build: versions, the card's name and power limit, and the
   build of the CUDA kernels from ``sift4g_tpu_torch/csrc`` (one nvcc per
   source, started together);
2. K1 (target slabs) against its plain PyTorch version on the card,
   exact, in all four alignment modes: ragged lengths with garbage tails,
   zero-length rows, a zero-length group, a 4096-wide rung and an
   8192-residue query; the E-value screen's words must agree too;
2b. K3 (the resident database) against its plain version, exact, in all
   four modes: ragged lengths, zero-length rows, windows that run into
   the next sequence and past the last one, a 4096-wide rung and an
   8192-residue query; K3 also against K1 fed the same windows as a slab,
   and the screened words of all three;
3. K1 and its plain version timed with CUDA events at the bench launch
   shape (G=64 groups, B=1024 targets of 512 residues, a 360-residue
   query);
4. the port's CLI at Swiss-Prot scale (570,000 synthetic sequences, about
   200 M residues; 50 queries with 20 substitutions each; default flags,
   where ``--resident-db auto`` keeps the slab path at this query count)
   with ``--backend cuda``, held byte for byte to ``--backend native``,
   and a matrix-mode pass on 5 queries held the same way.  K1's launch
   counter must show the main path went through it;
4b. the resident path: the same 50-query run with ``--resident-db on``,
   byte-identical to phase 4's ``--backend native`` outputs; then 300
   queries (the 50 and 250 database sequences, 20 substitutions each) at
   default flags, where ``auto`` must pick the resident database, held
   byte for byte to ``--resident-db off`` on the same queries.  The
   300-query runs go off, auto (cold: the upload is made), auto (warm:
   the live upload is reused), off.  Every resident run must launch K3
   and call no plain version on the card; upload time and bytes, the
   phase tables and align GCUPS are printed;
5. every K1 launch of phase 4's run held to the plain version on its own
   inputs (the packed slabs, uninitialized tails included), exact, and the
   largest of them timed, kernel and plain version, with CUDA events;
5b. every K3 launch of phase 4b's cold default-flag run held the same
   way, and the largest timed, with K1 on the same windows as a slab.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it the card's name and power limit, and before that one JSON line
with each kernel's launches, error, times at the main path's largest
launch and bound.  The script imports neither JAX nor the JAX package.
"""

import sys

sys.modules["jax"] = None          # the port must run without JAX ...
sys.modules["sift4g_tpu"] = None   # ... and without the JAX package

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
K1 = {
    "name": "sw_grouped",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_grouped.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:200",
}
K3 = {
    "name": "sw_grouped_resident",
    "route": "cuda",
    "source": "sift4g_tpu_torch/csrc/sw_grouped_resident.cu",
    "replaces": "sift4g_tpu/align/pallas_sw.py:774",
}
# H100 SXM peaks from NVIDIA's datasheet: device memory bandwidth, and
# the non-tensor 32-bit rate, which int32 add/sub/max cannot exceed
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
# int32 add/sub/max of one DP cell in the kernels' recurrence (F 3, G 2,
# E 3, H 1, and the SW zero floor and running best)
OPS_PER_CELL = {"SW": 11, "NW": 9, "HW": 9, "OV": 9}


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


def query_inputs(rng, qlens):
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    return q_all, offs, qlens


def grouped_inputs(rng, G, B, N, qlens, dev, zero_len=True):
    """Ragged grouped scorer inputs on the card: random int8 garbage past
    every target length and, with ``zero_len``, zero-length rows."""
    import torch

    q_all, offs, qlens = query_inputs(rng, qlens)
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(0 if zero_len else N, N + 1, size=(G, B)).astype(np.int32)
    if zero_len:
        lens[:, -1] = 0
        lens[0, 0] = N
    mask = np.arange(N)[None, None, :] < lens[..., None]
    targets[mask] = rng.integers(0, 26, int(mask.sum()))
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets, lens)]


def resident_inputs(rng, G, B, N, qlens, dev):
    """A resident database of G*B+9 ragged sequences (zero-length ones
    included, the last but one N long, the last 5 long) and (G, B) rows
    drawn from it in ascending order, the last sequence among them: its
    window runs past the data into the tail pad, and every shorter row's
    into the next sequences."""
    import torch
    from sift4g_tpu_torch.align.resident import ResidentDB

    n_seq = G * B + 9
    lens_seq = rng.integers(0, N + 1, n_seq).astype(np.int64)
    lens_seq[rng.integers(0, n_seq, 5)] = 0
    lens_seq[-2:] = (N, 5)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, dev)
    ids = np.sort(rng.choice(n_seq - 1, G * B, replace=False))
    ids[-1] = n_seq - 1
    ids = ids.reshape(G, B)
    host = query_inputs(rng, qlens) + (rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a).to(dev) for a in host]
    return q, o, ql, rdb.dev, st, tl


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
    say(f"[1] built {K1['source']} and {K3['source']} with nvcc in "
        f"{_build.build_seconds:.2f} s (load {time.perf_counter() - t0:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"[1]   ptxas: {line.strip()}")
    from sift4g_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    say(f"[1] native host library {os.path.relpath(native.library_path(), ROOT)} "
        f"ready in {time.perf_counter() - t0:.2f} s")
    return card


def _screen_equal(a, b, G, B):
    import torch
    from sift4g_tpu_torch.align import scan

    smin = torch.full((G,), 25, dtype=torch.int32, device=a.device)
    k = min(B, 400)
    return torch.equal(scan.screen_topk_words(a, smin, k), scan.screen_topk_words(b, smin, k))


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
        for mode in MODES:
            t0 = time.perf_counter()
            got = sw_grouped.sw_scores_grouped(*args, m32, mode=mode, gap_open=go, gap_extend=ge)
            ref = scan.align_scores_grouped(*args, m32, mode=mode, gap_open=go, gap_extend=ge)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            max_err = max(max_err, err)
            check(got.shape == (G, B) and got.dtype == torch.int32, f"{name} {mode}: shape/dtype")
            check(err == 0, f"{name} {mode}: kernel differs from twin by up to {err}")
            check(_screen_equal(got, ref, G, B), f"{name} {mode}: screened words differ")
            torch.cuda.synchronize()
            say(f"[2] {name:14s} {mode}: G={G} B={B} N={N} qlens={qlens}: kernel == twin "
                f"(max |diff| 0, {time.perf_counter() - t0:.2f} s)")
    return max_err


def phase_resident_parity(dev):
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    rng = np.random.default_rng(1)
    cases = [
        ("ragged", 6, 300, 512, (361, 0, 17, 128, 255, 1), (10, 1)),
        ("long rung", 2, 64, 4096, (300, 77), (11, 2)),
        ("8192-aa query", 1, 32, 512, (8192,), (10, 1)),
    ]
    max_err = 0
    for name, G, B, N, qlens, (go, ge) in cases:
        m32 = scan.matrix32_from_scorer(SimpleNamespace(matrix=random_matrix(rng)), dev)
        q, o, ql, db, st, tl = resident_inputs(rng, G, B, N, qlens, dev)
        # the tail pad is N bytes (the largest rung of this database)
        check(int(st.max()) + N > int(db.numel()) - N, f"{name}: no window reaches the tail pad")
        slab = db[st[..., None] + torch.arange(N, device=dev)].view(torch.int8).contiguous()
        for mode in MODES:
            t0 = time.perf_counter()
            kw = dict(mode=mode, gap_open=go, gap_extend=ge)
            got = sw_grouped.sw_scores_grouped_resident(q, o, ql, db, st, tl, m32, N, **kw)
            ref = scan.align_scores_grouped_resident(q, o, ql, db, st, tl, m32, N, **kw)
            k1 = sw_grouped.sw_scores_grouped(q, o, ql, slab, tl, m32, **kw)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            max_err = max(max_err, err, int((got.long() - k1.long()).abs().max()))
            check(got.shape == (G, B) and got.dtype == torch.int32, f"{name} {mode}: shape/dtype")
            check(err == 0, f"K3 {name} {mode}: differs from its plain version by up to {err}")
            check(torch.equal(got, k1), f"K3 {name} {mode}: differs from K1 on the same windows")
            check(_screen_equal(got, ref, G, B) and _screen_equal(got, k1, G, B),
                  f"K3 {name} {mode}: screened words differ")
            say(f"[2b] {name:14s} {mode}: G={G} B={B} N={N} qlens={qlens}: K3 == plain == K1 "
                f"on the same windows (max |diff| 0, {time.perf_counter() - t0:.2f} s)")
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
    torch.cuda.synchronize()
    return err


@contextlib.contextmanager
def recorded_launches(name):
    """Make the port's aligner keep each launch's device inputs and output
    of the scorer ``name`` (references only: nothing is copied or
    synchronised), so that the main path's own launches can be held to the
    plain version afterwards."""
    from sift4g_tpu_torch.align import batch

    real, launches = getattr(batch, name), []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        launches.append((args, kw, out))
        return out

    setattr(batch, name, recorded)
    try:
        yield launches
    finally:
        setattr(batch, name, real)


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


def _counted_run(args, tag, record=None):
    """One CLI run with ``--timings``: the counters are set to 0 just
    before it and read just after.  Returns (wall s, metrics, counters,
    recorded launches)."""
    from sift4g_tpu_torch.align import sw_grouped
    from sift4g_tpu_torch.utils import PhaseMetrics

    metrics = PhaseMetrics(log=sys.stderr, enabled=True)
    ctx = recorded_launches(record) if record else contextlib.nullcontext([])
    with ctx as recorded:
        sw_grouped.reset_counters()
        t0 = time.perf_counter()
        _run_cli([*args, "--timings"], metrics)
        wall = time.perf_counter() - t0
        counts = {
            "kernel_launches": sw_grouped.kernel_launches,
            "resident_launches": sw_grouped.resident_launches,
            "twin_calls_on_cuda": sw_grouped.twin_calls_on_cuda,
        }
    for name, d in metrics.phases.items():
        extra = " ".join(f"{k}={v:g}" for k, v in d.items() if k != "seconds")
        say(f"[{tag}]   phase {name:16s} {d.get('seconds', 0.0):9.3f} s  {extra}")
    align = metrics.phases["align"]
    say(f"[{tag}] {wall:.2f} s wall, align {align['cells'] / 1e9:.2f} G cells, "
        f"{align['cells'] / align['seconds'] / 1e9:.2f} GCUPS over the align phase, "
        + ", ".join(f"{k}={v}" for k, v in counts.items()))
    return wall, metrics, counts, list(recorded)


def phase_main_path(tmp):
    from sift4g_tpu_torch.synthetic import main as make_db

    data = os.path.join(tmp, "swissprot-scale")
    t0 = time.perf_counter()
    make_db([data, "--n-db", "570000", "--n-q", "50", "--subst-per-query", "20", "--seed", "0"])
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

    _, _, counts, recorded = _counted_run(
        ["--backend", "cuda", "-q", q, "-d", db, "--subst", data, "--out", outs["cuda"]],
        "4", record="sw_scores_grouped",
    )
    launches = counts["kernel_launches"]
    check(launches > 0, "the main path launched K1 no time")
    check(counts["resident_launches"] == 0, "phase 4 left the slab path")
    check(counts["twin_calls_on_cuda"] == 0,
          f"the main path called the twin on CUDA {counts['twin_calls_on_cuda']} times")
    n_pred = _same_tree(outs["cuda"], outs["native"], "subst mode")
    say(f"[4] --backend native: {native_s:.2f} s wall; {n_pred} .SIFTprediction files "
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
    return SimpleNamespace(data=data, q=q, db=db, native_out=outs["native"],
                           launches=launches, recorded=recorded)


def _write_query_set(main, tmp, n_extra, seed):
    """The 50 generated queries plus ``n_extra`` database sequences (100 to
    1,000 residues) as queries, each with 20 random substitutions."""
    from sift4g_tpu_torch.io.fasta import FastaStream

    rng = np.random.default_rng(seed)
    subst = os.path.join(tmp, f"subst-{50 + n_extra}")
    os.mkdir(subst)
    for f in os.listdir(main.data):
        if f.endswith(".subst"):
            shutil.copy(os.path.join(main.data, f), subst)
    std = np.array([ord(c) - ord("A") for c in "ACDEFGHIKLMNPQRSTVWY"])
    path = os.path.join(tmp, f"queries{50 + n_extra}.fa")
    with FastaStream(main.db) as fs, open(path, "w") as out:
        with open(main.q) as fh:
            out.write(fh.read())
        lens = np.diff(fs._offsets)
        pick = np.flatnonzero((lens >= 100) & (lens <= 1000))
        for i in np.sort(rng.choice(pick, n_extra, replace=False)):
            codes = fs.codes_at(int(i))
            name = fs.name_at(int(i))
            seq = "".join(chr(int(c) + ord("A")) for c in codes)
            out.write(f">{name}\n{seq}\n")
            with open(os.path.join(subst, name + ".subst"), "w") as sf:
                for p in np.sort(rng.choice(len(codes), 20, replace=False)):
                    sf.write(f"{seq[p]}{p + 1}{chr(int(rng.choice(std)) + ord('A'))}\n")
    return path, subst


def phase_resident_path(main, tmp):
    from sift4g_tpu_torch.align.resident import _RESIDENT_CACHE, drop_resident_db

    # 4b.1: the 50-query run with --resident-db on
    out_on = os.path.join(tmp, "out-resident-on")
    os.mkdir(out_on)
    drop_resident_db()
    _, m_on, c_on, _ = _counted_run(
        ["--backend", "cuda", "--resident-db", "on", "-q", main.q, "-d", main.db,
         "--subst", main.data, "--out", out_on], "4b on")
    check(c_on["resident_launches"] > 0, "--resident-db on launched K3 no time")
    check(c_on["kernel_launches"] == 0, "--resident-db on still launched K1")
    check(c_on["twin_calls_on_cuda"] == 0, "--resident-db on called a plain version on CUDA")
    n_on = _same_tree(out_on, main.native_out, "--resident-db on")
    rdb = _RESIDENT_CACHE["db"]
    say(f"[4b] --resident-db on, 50 queries: {n_on} files byte-identical to --backend native; "
        f"upload {rdb.nbytes} bytes slotted ({rdb.host_slotted.nbytes} with the tail pad) in "
        f"{rdb.upload_seconds * 1e3:.1f} ms after {rdb.pack_seconds * 1e3:.1f} ms of slot "
        f"packing")

    # 4b.2: 300 queries at default flags (auto) against --resident-db off;
    # their candidates (about 1.5 MB a query) outweigh the 0.2 GB slotted
    # database, so auto must take the resident path
    q300, subst300 = _write_query_set(main, tmp, 250, seed=7)
    base = ["--backend", "cuda", "-q", q300, "-d", main.db, "--subst", subst300]
    runs, outs = {}, {}
    for tag in ("off", "auto cold", "auto warm", "off again"):
        out = outs[tag] = os.path.join(tmp, "out-300-" + tag.replace(" ", "-"))
        os.mkdir(out)
        flags = ["--resident-db", "off"] if tag.startswith("off") else []
        if tag == "auto cold":
            drop_resident_db()   # auto decides on the candidate bytes, not a live upload
        record = "sw_scores_grouped_resident" if tag == "auto cold" else None
        _, m, c, rec = _counted_run([*base, *flags, "--out", out], f"4b {tag}", record=record)
        if tag.startswith("off"):
            check(c["resident_launches"] == 0 and c["kernel_launches"] > 0,
                  "--resident-db off left the slab path")
        else:
            check(c["resident_launches"] > 0, f"{tag}: auto did not pick the resident database")
            check(c["kernel_launches"] == 0, f"{tag}: the resident run still launched K1")
            check(c["twin_calls_on_cuda"] == 0, f"{tag}: a plain version ran on CUDA")
        n = _same_tree(out, outs["off"], f"300 queries {tag} vs off")
        runs[tag] = (m, c, rec, n)
    m_cold, c_cold, recorded, n_cold = runs["auto cold"]
    check(len(recorded) == c_cold["resident_launches"],
          f"{len(recorded)} K3 launches recorded, {c_cold['resident_launches']} counted")
    check("align.upload" not in runs["auto warm"][0].phases or
          runs["auto warm"][0].phases["align.upload"]["seconds"] < 0.05,
          "the warm run uploaded the database again")
    up = m_cold.phases["align.upload"]
    say(f"[4b] 300 queries: auto chose the resident database ({c_cold['resident_launches']} K3 "
        f"launches, 0 K1); {n_cold} files of every run byte-identical to the first "
        f"--resident-db off run; cold upload phase {up['seconds']:.3f} s for {up['bytes']:g} "
        f"bytes")
    cols = ("search", "align.upload", "align", "align.dispatch", "align.fetch",
            "align.traceback", "select", "predict")
    say("[4b] phase seconds, 300 queries: " + " | ".join(cols) + " | align GCUPS")
    for tag, (m, _, _, _) in runs.items():
        secs = [m.phases.get(c, {}).get("seconds", 0.0) for c in cols]
        a = m.phases["align"]
        say(f"[4b]   {tag:10s} " + " | ".join(f"{x:.3f}" for x in secs)
            + f" | {a['cells'] / a['seconds'] / 1e9:.2f}")
    return c_cold["resident_launches"], recorded


def _bound(kind, args, kw):
    """(bound_ms, bound_by, true cells) of one launch from its inputs:
    each input byte read once and the output written once, against the
    int32 operations of the true cells."""
    q_all, q_lens = args[0], args[2]
    if kind == "slab":
        targets, lens = args[3], args[4]
        G, B, _ = targets.shape
        row_bytes = targets.numel()
    else:
        starts, lens = args[4], args[5]
        G, B = starts.shape
        row_bytes = int(lens.long().sum()) + 8 * starts.numel()
    true = int((q_lens.long() * lens.long().sum(dim=1)).sum())
    nbytes = row_bytes + 4 * (q_all.numel() + 2 * G + 2 * G * B) + 4 * 32 * 32
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = true * OPS_PER_CELL[kw["mode"]] / INT32_OPS_PER_S * 1e3
    return max(ms_bytes, ms_ops), ("bytes" if ms_bytes >= ms_ops else "operations"), true


def phase_main_launches(recorded, card, kind, tag):
    """The main path's own launches against the plain version on the same
    device inputs; the launch with the most padded cells is then timed."""
    import torch
    from sift4g_tpu_torch.align import scan, sw_grouped

    if kind == "slab":
        kernel, plain = sw_grouped.sw_scores_grouped, scan.align_scores_grouped
    else:
        kernel, plain = sw_grouped.sw_scores_grouped_resident, scan.align_scores_grouped_resident
    max_err, largest = 0, None
    for args, kw, out in recorded:
        q_lens, lens = args[2], (args[4] if kind == "slab" else args[5])
        G, B = lens.shape
        N = args[3].shape[2] if kind == "slab" else args[7]
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        err = int((out.long() - ref.long()).abs().max()) if out.numel() else 0
        max_err = max(max_err, err)
        padded = int(q_lens.long().sum()) * B * N
        true = int((q_lens.long() * lens.long().sum(dim=1)).sum())
        say(f"[{tag}] launch {kw['mode']} G={G} B={B} N={N} qmax={int(q_lens.max())}: "
            f"{padded / 1e9:.3f} G padded cells, {true / 1e9:.3f} G true; kernel == plain "
            f"(max |diff| {err})")
        check(err == 0, f"main-path launch G={G} B={B} N={N}: kernel differs from plain by {err}")
        del ref
        if largest is None or padded > largest[0]:
            largest = (padded, true, args, kw, (G, B, N))
    padded, true, args, kw, (G, B, N) = largest
    ms = _time_ms(lambda: kernel(*args, **kw), iters=5, warmup=1)
    plain_ms = _time_ms(lambda: plain(*args, **kw), iters=1, warmup=0)
    bound_ms, bound_by, _ = _bound(kind, args, kw)
    say(f"[{tag}] largest main-path launch G={G} B={B} N={N}, {card}: kernel {ms:.3f} ms = "
        f"{padded / ms / 1e6:.2f} GCUPS padded, {true / ms / 1e6:.2f} true; plain "
        f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}); design bound "
        f"(17 B/cell at 3.35 TB/s) {true * 17 / HBM_BYTES_PER_S * 1e3:.3f} ms")
    if kind == "resident":
        # K1 on the same windows as a slab, timed between K3's turns
        q, o, ql, db, st, tl = args[:6]
        slab = db[st[..., None] + torch.arange(N, device=db.device)].view(torch.int8).contiguous()
        k1_ms = _time_ms(lambda: sw_grouped.sw_scores_grouped(q, o, ql, slab, tl, args[6], **kw),
                         iters=5, warmup=1)
        ms2 = _time_ms(lambda: kernel(*args, **kw), iters=5, warmup=1)
        say(f"[{tag}] same launch, {card}: K3 {ms:.3f} then {ms2:.3f} ms; K1 on the same "
            f"windows as a slab {k1_ms:.3f} ms ({true / k1_ms / 1e6:.2f} true GCUPS)")
        del slab
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def main() -> int:
    card = phase_build()
    import torch

    dev = torch.device("cuda", 0)
    err_k1 = phase_parity(dev)
    err_k3 = phase_resident_parity(dev)
    err_k1 = max(err_k1, phase_timing(dev, card))
    tmp = tempfile.mkdtemp(prefix="sift4g-smoke-")
    try:
        main_path = phase_main_path(tmp)
        k3_launches, k3_recorded = phase_resident_path(main_path, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k1 = phase_main_launches(main_path.recorded, card, "slab", "5")
    k3 = phase_main_launches(k3_recorded, card, "resident", "5b")
    k1["max_abs_err"] = max(k1["max_abs_err"], err_k1)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_k3)
    say(json.dumps({"kernels": [
        dict(K1, launches=main_path.launches, **k1),
        dict(K3, launches=k3_launches, **k3),
    ]}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

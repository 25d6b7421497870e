"""Measure the tiled K1/K3 body (``csrc/sw_tiled.cuh``) on a card.

    python -m sift4g_tpu_torch.tools.bench_tiled threads
    python -m sift4g_tpu_torch.tools.bench_tiled profile

``threads`` runs K1 (``sw_grouped.sw_scores_grouped``) at every forced T
on four launch shapes: the bench launch, a launch of the shape of the
50-query run's largest (G=36, B=4096, N=384, lengths 193-384) with
380-residue queries and with queries of 100-700 residues, and K2's
Titin-class shape (G=1, B=32, N=35,008; T below 8 is left out there,
where one launch of them takes 60-210 ms).  Each T's scores must equal
those at the geometry's own T; each is timed with CUDA events.

``profile`` asks what the block-wide ``__syncthreads`` around the query
profile costs.  The profile holds 512 query rows, so a longer query
builds it again at row 512, behind a barrier that waits for the block's
slowest warp.  One launch (the bench launch, or the main-like launch)
runs at the geometry's T with every query 1, 2, ..., 6 passes of T x 16
rows long, on the same targets and grid, timed in turns (1 to 6, then 6
to 1).  Each pass's time is the difference between consecutive lengths;
the pass that starts at row 512 rebuilds the profile, and its excess over
the median of the other passes is the rebuild's cost.

Each line printed is one JSON object naming the card and its power limit.
Without a card: ``error: no CUDA device`` and exit 1.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..align import sw_grouped
from ..align.roofline import event_ms, nvidia_smi, require_cuda


def _ms(fn, dev, iters):
    """The best of ``iters`` CUDA-event times of ``fn()``, in ms."""
    return min(event_ms(fn, dev) for _ in range(iters))


def _launch(rng, dev, m32, G, B, N, m_lo, m_hi, len_lo):
    """K1 inputs: G random queries of m_lo..m_hi - 1 residues against B
    random targets each of len_lo..N residues on an N-wide slab."""
    m = rng.integers(m_lo, m_hi, G).astype(np.int32)
    q = torch.from_numpy(rng.integers(0, 26, int(m.sum()) + 1).astype(np.int32)).to(dev)
    o = torch.from_numpy(np.concatenate(([0], np.cumsum(m)[:-1])).astype(np.int32)).to(dev)
    ql = torch.from_numpy(m).to(dev)
    tl = torch.from_numpy(rng.integers(len_lo, N + 1, (G, B)).astype(np.int32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 26, (G, B, N)).astype(np.int8)).to(dev)
    return q, o, ql, t, tl, m32


def _cells(args):
    return int((args[2].long()[:, None] * args[4].long()).sum())


def shapes(dev, names, seed=5):
    """{name: K1 inputs} of the named launch shapes."""
    from ..bench import grouped_launch

    rng = np.random.default_rng(seed)
    qa, qo, lens, m32, q_lens, new_slab = grouped_launch(dev)
    make = {
        "bench G=64 B=1024 N=512 m=360":
            lambda: (qa, qo, q_lens(360), new_slab(), lens, m32),
        "bench G=64 B=1024 N=512 m=768":
            lambda: _launch(rng, dev, m32, 64, 1024, 512, 768, 769, 512),
        "main-like G=36 B=4096 N=384 m=380":
            lambda: _launch(rng, dev, m32, 36, 4096, 384, 380, 381, 193),
        "main-like G=36 B=4096 N=384 m=100-700":
            lambda: _launch(rng, dev, m32, 36, 4096, 384, 100, 701, 193),
        "main-like G=36 B=4096 N=384 m=768":
            lambda: _launch(rng, dev, m32, 36, 4096, 384, 768, 769, 193),
        "Titin-class G=1 B=32 N=35008 m=360":
            lambda: _launch(rng, dev, m32, 1, 32, 35008, 360, 361, 35008),
    }
    return {name: make[name]() for name in names}


def pass_lengths(T, passes=6):
    """Query lengths of 1..passes whole passes at T threads per target."""
    return [k * T * sw_grouped.TILE_ROWS for k in range(1, passes + 1)]


def _card():
    return ", ".join(nvidia_smi("name,power.limit"))


def run_threads(dev, iters=3):
    card = _card()
    names = ("bench G=64 B=1024 N=512 m=360", "main-like G=36 B=4096 N=384 m=380",
             "main-like G=36 B=4096 N=384 m=100-700", "Titin-class G=1 B=32 N=35008 m=360")
    for shape, args in shapes(dev, names).items():
        G, B, N = args[3].shape
        auto = sw_grouped.launch_geometry(G, B, N, dev)
        want = sw_grouped.sw_scores_grouped(*args)
        cells = _cells(args)
        for T in sw_grouped.GROUP_THREADS:
            if "Titin" in shape and T < 8:
                continue

            def k1(T=T):
                return sw_grouped.sw_scores_grouped(*args, threads_per_target=T)

            if not torch.equal(k1(), want):
                raise SystemExit(f"FAIL: T={T} differs from T={auto[0]} at {shape}")
            ms = _ms(k1, dev, iters)
            print(json.dumps({"shape": shape, "T": T, "auto": auto, "ms": ms,
                              "gcups": cells / ms / 1e6, "card": card}), flush=True)
    return 0


def run_profile(dev, iters=5):
    card = _card()
    names = ("bench G=64 B=1024 N=512 m=768", "main-like G=36 B=4096 N=384 m=768")
    for shape, args in shapes(dev, names).items():
        q, o, ql, t, tl, m32 = args
        G, B, N = t.shape
        T = sw_grouped.launch_geometry(G, B, N, dev)[0]
        lens = pass_lengths(T)
        qls = {m: torch.full_like(ql, m) for m in lens}
        fns = {m: (lambda m=m: sw_grouped.sw_scores_grouped(
            q, o, qls[m], t, tl, m32, threads_per_target=T)) for m in lens}
        times = {m: [] for m in lens}
        for m in lens + lens[::-1]:
            fns[m]()
            times[m].append(_ms(fns[m], dev, iters))
        best = [min(times[m]) for m in lens]
        per_pass = [b - a for a, b in zip(best, best[1:])]   # passes 2..6
        rebuild = [k for k, m in enumerate(lens[:-1]) if m % (32 * sw_grouped.TILE_ROWS) == 0]
        others = sorted(d for k, d in enumerate(per_pass) if k not in rebuild)
        median = others[len(others) // 2] if others else None
        print(json.dumps({"shape": shape, "T": T, "query_lengths": lens, "ms": times,
                          "pass_ms": per_pass, "rebuild_pass_from_row": [lens[k] for k in rebuild],
                          "rebuild_excess_ms": [per_pass[k] - median for k in rebuild]
                          if others else None, "card": card}), flush=True)
    return 0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args not in (["threads"], ["profile"]):
        print("usage: bench_tiled threads|profile", file=sys.stderr)
        return 2
    try:
        dev = require_cuda("cuda")
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return run_threads(dev) if args[0] == "threads" else run_profile(dev)


if __name__ == "__main__":
    sys.exit(main())

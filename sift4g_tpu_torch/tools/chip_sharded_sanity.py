"""The grouped scorer (K1) split over the visible cards at the production
launch shape, held to the unsharded kernel, and its launch rate.

The port of ``tools/chip_sharded_sanity.py``: G=64 groups of B=1024
targets of N=512 residues against 360-residue queries go through
``parallel.sharded.make_grouped_sharded`` on every visible card (the
group axis split across them; one card gives one shard), the scores must
equal ``sw_scores_grouped`` on one card bit for bit, and six launches on
new inputs (targets and lengths) are timed with CUDA events on every
card, the slowest card's time counting.  Beside it, on the first card,
the same launches unsharded and, over several cards, one card's share of
them alone (the time the split can at best reach).

    python -m sift4g_tpu_torch.tools.chip_sharded_sanity

Exits 1 with ``error: no CUDA device`` on a host without a card.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main() -> int:
    import torch

    from ..align import scan, sw_grouped
    from ..core.scorers import create_scorer
    from ..parallel.sharded import make_grouped_sharded, make_mesh

    if not torch.cuda.is_available():
        print("error: no CUDA device is visible", file=sys.stderr)
        return 1
    mesh = make_mesh()
    print("devices:", ", ".join(f"{d} ({torch.cuda.get_device_name(d)})" for d in mesh))
    G, B, N, m = 64, 1024, 512, 360
    if G % len(mesh):
        print(f"error: {G} groups do not divide over {len(mesh)} cards", file=sys.stderr)
        return 1
    home = mesh[0]
    scorer = create_scorer("BLOSUM_62", 10, 1)
    m32 = scan.matrix32_from_scorer(scorer, home)
    rng = np.random.default_rng(7)

    m_pad = -(-m // 64) * 64
    q_all = np.full(G * m_pad, scan.PAD_CODE, dtype=np.int32)
    for g in range(G):
        q_all[g * m_pad : g * m_pad + m] = rng.integers(0, 26, m)
    q_off = (np.arange(G) * m_pad).astype(np.int32)
    q_len = np.full(G, m, dtype=np.int32)

    def new_inputs():
        return (torch.from_numpy(rng.integers(0, 26, (G, B, N)).astype(np.int8)).to(home),
                torch.from_numpy(rng.integers(N // 2, N, (G, B)).astype(np.int32)).to(home))

    fn = make_grouped_sharded(mesh, max_qlen=m_pad, max_sub=int(scorer.matrix.max()))
    args = [torch.from_numpy(a).to(home) for a in (q_all, q_off, q_len)]
    tg, tl = new_inputs()

    def sync():
        for d in dict.fromkeys(mesh):
            torch.cuda.synchronize(d)

    t0 = time.perf_counter()
    sharded = fn(*args, tg, tl, m32)
    sync()
    print(f"sharded cold (build included): {time.perf_counter() - t0:.1f}s")
    got = torch.cat([s.to(home) for s in sharded])
    plain = sw_grouped.sw_scores_grouped(*args, tg, tl, m32)
    if not torch.equal(got, plain):
        print("error: the sharded scores differ from the unsharded kernel", file=sys.stderr)
        return 1
    print("bit-equality sharded == unsharded grouped kernel: OK")

    cells = float(G) * m * B * N  # padded upper bound; the rate is indicative
    staged = [new_inputs() for _ in range(6)]

    def best_of_6(call, devices):
        """The best of six calls on the staged inputs, each timed by CUDA
        events on every device, the slowest device's time counting."""
        times = []
        for tg_i, tl_i in staged:
            sync()
            events = {d: (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)) for d in devices}
            for d, (start, _) in events.items():
                start.record(torch.cuda.current_stream(d))
            call(tg_i, tl_i)
            for d, (_, end) in events.items():
                end.record(torch.cuda.current_stream(d))
            sync()
            times.append(max(start.elapsed_time(end) for start, end in events.values()))
        return min(times)

    best = best_of_6(lambda tg_i, tl_i: fn(*args, tg_i, tl_i, m32), list(dict.fromkeys(mesh)))
    print(f"sharded warm best-of-6 over {len(mesh)} card(s): {best:.3f} ms = "
          f"{cells / best / 1e6:.1f} padded GCUPS")
    # the same launch unsharded, and one card's share of it alone, on the
    # first card: the split gains what the share's time allows
    one = best_of_6(lambda tg_i, tl_i: sw_grouped.sw_scores_grouped(*args, tg_i, tl_i, m32),
                    [home])
    print(f"unsharded on {home}: {one:.3f} ms = {cells / one / 1e6:.1f} padded GCUPS")
    if len(mesh) > 1:
        s = G // len(mesh)
        share = best_of_6(lambda tg_i, tl_i: sw_grouped.sw_scores_grouped(
            args[0], args[1][:s], args[2][:s], tg_i[:s], tl_i[:s], m32), [home])
        print(f"one card's share ({s} groups) alone on {home}: {share:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

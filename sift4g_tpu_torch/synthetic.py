"""Generate a seeded synthetic protein FASTA database + queries.

The port's copy of ``tools/make_synthetic_db.py``: for the same arguments
and seed it writes the same files, byte for byte.  Sequences are random
draws from the background amino-acid frequency (constants.AA_FREQUENCY
restricted to the 20 standard letters), with a fraction of database
sequences built as mutated copies of the queries so the prefilter and
aligner see realistic homology structure.

Usage: python -m sift4g_tpu_torch.synthetic OUT_DIR [--n-db 20000] [--n-q 10]
"""

import argparse
import os

import numpy as np

from .constants import AA_FREQUENCY

STD = np.array([ord(c) - ord("A") for c in "ACDEFGHIKLMNPQRSTVWY"])


def _freqs():
    f = AA_FREQUENCY[STD]
    return f / f.sum()


def random_seq(rng, n, p):
    return rng.choice(STD, size=n, p=p).astype(np.uint8)


def mutate(rng, codes, p, sub_rate=0.35, indel_rate=0.06):
    # vectorized: per-position fate draw (delete / insert-before / keep),
    # then a vectorized substitution mask over the kept+inserted residues
    n = len(codes)
    r = rng.random(n)
    keep = r >= indel_rate / 2
    ins = (r >= indel_rate / 2) & (r < indel_rate)
    # expand: each kept position contributes 1 residue, +1 more if ins
    reps = keep.astype(np.int64) + ins.astype(np.int64)
    out = np.repeat(codes, reps)
    # the first residue of every ins pair is a fresh random draw
    starts = np.cumsum(reps) - reps
    ins_pos = starts[ins]
    out[ins_pos] = rng.choice(STD, size=len(ins_pos), p=p)
    sub = rng.random(len(out)) < sub_rate
    if ins_pos.size:  # inserted residues are already random; don't re-sub
        sub[ins_pos] = False
    out[sub] = rng.choice(STD, size=int(sub.sum()), p=p)
    return out.astype(np.uint8)


def write_fasta(path, names, seqs):
    with open(path, "w") as fh:
        for name, codes in zip(names, seqs):
            s = "".join(chr(c + ord("A")) for c in codes)
            fh.write(f">{name}\n")
            for i in range(0, len(s), 60):
                fh.write(s[i : i + 60] + "\n")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m sift4g_tpu_torch.synthetic")
    ap.add_argument("out_dir")
    ap.add_argument("--n-db", type=int, default=20000)
    ap.add_argument("--n-q", type=int, default=10)
    ap.add_argument("--mean-len", type=int, default=350)
    ap.add_argument("--homolog-frac", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--subst-per-query", type=int, default=0, metavar="K",
        help="also write a QUERY_i.subst file per query with K random "
        "substitution lines (the reference's product mode, "
        "test_files/README.md:11-17) — enables subst-mode benchmarking",
    )
    return ap


def main(argv=None) -> int:
    """Write queries.fa, db.fa and (with --subst-per-query) the .subst
    files into OUT_DIR; returns the total residue count written."""
    args = build_parser().parse_args(argv)

    rng = np.random.default_rng(args.seed)
    p = _freqs()
    os.makedirs(args.out_dir, exist_ok=True)

    q_seqs = [
        random_seq(rng, int(np.clip(rng.normal(args.mean_len, 60), 80, 2000)), p)
        for _ in range(args.n_q)
    ]
    q_names = [f"QUERY_{i}" for i in range(args.n_q)]
    write_fasta(os.path.join(args.out_dir, "queries.fa"), q_names, q_seqs)

    if args.subst_per_query > 0:
        for name, codes in zip(q_names, q_seqs):
            k = min(args.subst_per_query, len(codes))
            pos = np.sort(rng.choice(len(codes), size=k, replace=False))
            with open(os.path.join(args.out_dir, name + ".subst"), "w") as fh:
                fh.write("# synthetic substitution list\n")
                for sp in pos:
                    ref = chr(int(codes[sp]) + ord("A"))
                    new = chr(int(rng.choice(STD)) + ord("A"))
                    fh.write(f"{ref}{int(sp) + 1}{new}\n")

    n_hom = int(args.n_db * args.homolog_frac)
    n_rand = args.n_db - n_hom
    # vectorized bulk generation: one big residue draw, split by lengths
    lengths = np.clip(
        rng.normal(args.mean_len, 100, size=n_rand), 30, 3000
    ).astype(np.int64)
    bounds = np.concatenate(([0], np.cumsum(lengths)))
    letters = np.frombuffer(
        bytes(bytearray((STD + ord("A")).astype(np.uint8))), dtype="S1"
    )
    pool = rng.choice(letters, size=int(bounds[-1]), p=p)

    total = int(bounds[-1])
    out_path = os.path.join(args.out_dir, "db.fa")
    with open(out_path, "w") as fh:
        # homologs first (mutated query copies), then the bulk random pool
        for i in range(n_hom):
            src = q_seqs[rng.integers(len(q_seqs))]
            s = "".join(chr(c + ord("A")) for c in mutate(rng, src, p))
            total += len(s)
            fh.write(f">HOM_{i}\n{s}\n")
        for i in range(n_rand):
            s = pool[bounds[i] : bounds[i + 1]].tobytes().decode("ascii")
            fh.write(f">DB_{i}\n{s}\n")
    print(f"wrote {args.n_q} queries, {args.n_db} db seqs, {total} residues")
    return total


if __name__ == "__main__":
    main()

"""Seeded inputs of one cell: a protein database, a pool of queries, .subst files.

A vectorised, reshaped copy of the sampling in ``sift4g_tpu_torch/synthetic.py``
(commit eca6a4da): residues are drawn from the background amino-acid
frequencies restricted to the 20 standard letters, and a homolog is its
query passed through the same per-residue fate draw as ``mutate`` (delete,
insert a fresh residue before, keep; then substitute kept residues).  What
changed is the shape:

* lengths are stratified quantiles of a log-normal fitted to a median and a
  mean, clipped, so every seed gets the same multiset of lengths, only in
  another order;
* each query of a set has a family of ``floor(10**U) - 1`` homologs, U taken
  at stratified points of [0, log10(max_size + 1)], each homolog with its own
  substitution rate from evenly spaced points of the configured range;
* the pairing of a set's lengths with its family sizes comes from the
  configuration's ``shape_seed``, not from the run's seed, so every set (and
  so every job of the default traffic) carries the same work.

The run's seed draws the residues, the order of the queries inside each set,
the substitution positions and letters, and the order of the database.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
from scipy.special import ndtri

STD_LETTERS = "ACDEFGHIKLMNPQRSTVWY"
STD = np.frombuffer(STD_LETTERS.encode(), dtype=np.uint8) - ord("A")
# background frequencies of the 20 standard letters (sift4g constants.hpp,
# frozen from sift4g_tpu_torch/constants.py AA_FREQUENCY)
_FREQ = {
    "A": 0.07587, "C": 0.01666, "D": 0.05287, "E": 0.06377, "F": 0.04096,
    "G": 0.06847, "H": 0.02246, "I": 0.05817, "K": 0.05957, "L": 0.09427,
    "M": 0.02376, "N": 0.04456, "P": 0.04906, "Q": 0.03976, "R": 0.05166,
    "S": 0.07127, "T": 0.05677, "V": 0.06587, "W": 0.01236, "Y": 0.03186,
}
_P = np.array([_FREQ[c] for c in STD_LETTERS], dtype=np.float64)
_CDF = np.cumsum(_P / _P.sum())
_CDF[-1] = 1.0


def lognormal_quantiles(count: int, median: float, mean: float, lo: int, hi: int) -> np.ndarray:
    """Stratified quantiles (at (i + 0.5) / count) of the log-normal with this
    median and mean, rounded and clipped to [lo, hi]; ascending."""
    sigma = math.sqrt(2.0 * math.log(mean / median))
    z = ndtri((np.arange(count) + 0.5) / count)
    v = np.rint(np.exp(math.log(median) + sigma * z))
    return np.clip(v, lo, hi).astype(np.int64)


def family_sizes(count: int, max_size: int) -> np.ndarray:
    """floor(10**U) - 1 at stratified points U of [0, log10(max_size + 1)]."""
    u = (np.arange(count) + 0.5) / count * math.log10(max_size + 1)
    return (np.floor(10.0 ** u) - 1).astype(np.int64)


def set_shape(queries: dict, families: dict, shape_seed: int):
    """(lengths, family sizes) of one query set, paired by ``shape_seed``."""
    spec = queries["set_lengths"]
    if "list" in spec:
        lengths = np.asarray(spec["list"], dtype=np.int64)
    else:
        ln = spec["lognormal"]
        lengths = lognormal_quantiles(ln["count"], ln["median"], ln["mean"], ln["min"], ln["max"])
    fam = family_sizes(len(lengths), families["max_size"])
    perm = np.random.default_rng(shape_seed).permutation(len(lengths))
    return lengths, fam[perm]


def _residues(rng, n: int) -> np.ndarray:
    idx = np.searchsorted(_CDF, rng.random(n, dtype=np.float32), side="right")
    return STD[np.minimum(idx, len(STD) - 1)]


def _ranges(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated index ranges [starts[i], starts[i] + lens[i])."""
    total = int(lens.sum())
    excl = np.cumsum(lens) - lens
    return np.repeat(starts - excl, lens) + np.arange(total, dtype=np.int64)


def mutate_many(rng, src: np.ndarray, src_of: np.ndarray, n_src: int,
                rates: np.ndarray, indel_rate: float):
    """``synthetic.mutate`` over many sequences at once: ``src`` holds their
    residues back to back, ``src_of`` the sequence of each residue and
    ``rates`` each sequence's substitution rate.  Returns (codes, lengths)."""
    r = rng.random(src.shape[0], dtype=np.float32)
    keep = r >= indel_rate / 2
    ins = keep & (r < indel_rate)
    reps = keep.astype(np.int64) + ins
    out = np.repeat(src, reps)
    out_of = np.repeat(src_of, reps)
    ins_pos = (np.cumsum(reps) - reps)[ins]
    out[ins_pos] = _residues(rng, ins_pos.shape[0])
    sub = rng.random(out.shape[0], dtype=np.float32) < rates[out_of].astype(np.float32)
    sub[ins_pos] = False
    out[sub] = _residues(rng, int(sub.sum()))
    return out, np.bincount(out_of, minlength=n_src).astype(np.int64)


def _write_fasta(path: str, names: List[str], codes: np.ndarray, offsets: np.ndarray,
                 order=None) -> None:
    """One line a sequence; ``order`` picks and orders the records."""
    letters = (codes + ord("A")).astype(np.uint8)
    order = range(len(names)) if order is None else order
    parts = []
    for i in order:
        parts.append(b">" + names[i].encode() + b"\n")
        parts.append(letters[offsets[i]:offsets[i + 1]].tobytes() + b"\n")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))


def generate(config: dict, seed: int, out_dir: str, job_queries: int) -> Dict:
    """Write the cell's inputs into ``out_dir`` and return their manifest:
    ``db.fa`` (the database), ``jobs/job_NNN.fa`` (the pool cut into jobs of
    ``job_queries`` consecutive queries), ``subst/<query>.subst``.  The
    manifest also holds the database's and the queries' codes as written,
    which the plain reference reads."""
    rng = np.random.default_rng(int(seed))
    db_cfg, q_cfg = config["database"], config["queries"]
    fam_cfg = db_cfg["families"]
    set_len, set_fam = set_shape(q_cfg, fam_cfg, config["shape_seed"])
    n_sets = int(q_cfg["sets"])
    # the pool: each set in its own seeded order
    order = np.concatenate([rng.permutation(len(set_len)) for _ in range(n_sets)])
    q_len, q_fam = set_len[order], set_fam[order]
    n_q = q_len.shape[0]
    q_off = np.concatenate(([0], np.cumsum(q_len)))
    q_codes = _residues(rng, int(q_off[-1]))
    q_names = [f"Q{i:05d}" for i in range(n_q)]

    # homolog families: query i's homologs are mutated copies of it, the
    # k-th of f with substitution rate lo + (hi - lo) * (k + 0.5) / f
    lo, hi = fam_cfg["sub_rate"]
    hom_q = np.repeat(np.arange(n_q), q_fam)
    k_in = np.arange(hom_q.shape[0]) - np.repeat(np.cumsum(q_fam) - q_fam, q_fam)
    rates = lo + (hi - lo) * (k_in + 0.5) / np.maximum(q_fam[hom_q], 1)
    n_hom = int(hom_q.shape[0])
    src = q_codes[_ranges(q_off[hom_q], q_len[hom_q])]
    src_of = np.repeat(np.arange(n_hom), q_len[hom_q])
    hom_codes, hom_len = mutate_many(rng, src, src_of, n_hom, rates, fam_cfg["indel_rate"])
    if n_hom and hom_len.min() < 1:
        raise ValueError("a homolog lost every residue; raise the queries' minimum length")

    n_db = int(db_cfg["sequences"])
    n_bg = n_db - n_hom
    if n_bg < 0:
        raise ValueError(f"{n_hom} homologs exceed the database's {n_db} sequences")
    bl = db_cfg["background_length"]
    bg_len = rng.permutation(lognormal_quantiles(n_bg, bl["median"], bl["mean"], bl["min"], bl["max"]))
    bg_codes = _residues(rng, int(bg_len.sum()))

    # the database in file order: homologs and background shuffled together
    db_order = rng.permutation(n_db)
    both_len = np.concatenate([hom_len, bg_len])
    both_off = np.concatenate(([0], np.cumsum(both_len)))
    db_codes = np.concatenate([hom_codes, bg_codes])[_ranges(both_off[db_order], both_len[db_order])]
    db_off = np.concatenate(([0], np.cumsum(both_len[db_order])))
    os.makedirs(out_dir, exist_ok=True)
    db_path = os.path.join(out_dir, "db.fa")
    _write_fasta(db_path, [f"SP{i:06d}" for i in range(n_db)], db_codes, db_off)

    subst_dir = ""
    k_sub = int(q_cfg.get("subst_per_query", 0))
    if k_sub > 0:
        subst_dir = os.path.join(out_dir, "subst")
        os.makedirs(subst_dir, exist_ok=True)
        letters = STD_LETTERS
        for i in range(n_q):
            codes = q_codes[q_off[i]:q_off[i + 1]]
            pos = np.sort(rng.choice(codes.shape[0], size=min(k_sub, codes.shape[0]), replace=False))
            new = rng.integers(0, len(letters), size=pos.shape[0])
            lines = ["# synthetic substitution list\n"]
            lines += [f"{chr(int(codes[p]) + 65)}{int(p) + 1}{letters[n]}\n" for p, n in zip(pos, new)]
            with open(os.path.join(subst_dir, q_names[i] + ".subst"), "w") as fh:
                fh.write("".join(lines))

    jobs_dir = os.path.join(out_dir, "jobs")
    os.makedirs(jobs_dir, exist_ok=True)
    jobs = []
    for j in range(n_q // job_queries):
        members = list(range(j * job_queries, (j + 1) * job_queries))
        path = os.path.join(jobs_dir, f"job_{j:03d}.fa")
        _write_fasta(path, q_names, q_codes, q_off, order=members)
        jobs.append({"path": path, "queries": [q_names[m] for m in members],
                     "residues": int(q_len[members].sum())})
    return {
        "db_path": db_path,
        "db_sequences": n_db,
        "db_residues": int(db_off[-1]),
        "homologs": n_hom,
        "homolog_residues": int(hom_len.sum()),
        "subst_dir": subst_dir,
        "db_codes": db_codes,
        "db_offsets": db_off,
        "query_codes": {q_names[i]: q_codes[q_off[i]:q_off[i + 1]] for i in range(n_q)},
        "jobs": jobs,
    }

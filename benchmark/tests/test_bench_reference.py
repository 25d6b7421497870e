"""The plain reference against the program's plain versions and the
scalar transcription of the C++, and the generator's inputs (CPU)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.gen import synth
from benchmark.reference import prefilter, sift, sw, tables
from benchmark.tests import second_oracle
from benchmark.tests import tiny


def _homolog(rng, q, rate):
    t, _ = synth.mutate_many(rng, q, np.zeros(q.shape[0], dtype=np.int64), 1,
                             np.array([rate]), 0.2)
    return t if t.shape[0] else synth._residues(rng, 3)


def test_tables_are_the_programs():
    from sift4g_tpu_torch import constants
    from sift4g_tpu_torch.core import evalue
    from sift4g_tpu_torch.core.scorers import create_scorer

    assert np.array_equal(tables.BLOSUM62, create_scorer("BLOSUM_62", 10, 1).matrix)
    for name in ("RANK_MATRIX", "DIRI_Q", "AA_FREQUENCY", "DIRI_ALTOT", "DIRI_ALPHA",
                 "VALID_AA_MASK"):
        assert np.array_equal(getattr(tables, name), getattr(constants, name)), name
    for name in ("LOG_2_20", "TOLERANCE_PROB_THRESHOLD", "ADEQUATE_SEQ_INFO", "MAX_SEQUENCES"):
        assert getattr(tables, name) == getattr(constants, name), name
    assert tables.GAPPED_BLOSUM62_10_1 == evalue._GAPPED[("BLOSUM_62", 9, 1)]


@pytest.mark.parametrize("max_candidates", [40, 5000])
def test_prefilter_keeps_the_programs_candidates(tmp_path, max_candidates):
    from sift4g_tpu_torch.io.fasta import read_fasta
    from sift4g_tpu_torch.prefilter.search import search_database

    man = synth.generate(tiny.load_config("swissprot-subst"), 2**31 + 3, str(tmp_path), 6)
    queries = read_fasta(man["jobs"][0]["path"])
    want, cells = search_database(man["db_path"], queries, kmer_length=5,
                                  max_candidates=max_candidates, log=open(os.devnull, "w"))
    db = prefilter.Database(man["db_codes"], man["db_offsets"], 5, "cpu")
    got = prefilter.candidates(db, [q.codes for q in queries], max_candidates, batch_kmers=300)
    assert cells == db.total_residues
    assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]


@pytest.mark.parametrize("chunk", [4, 1024])
def test_sw_scores_and_tracebacks_are_dp_numpys(monkeypatch, chunk):
    from sift4g_tpu_torch.align.dp_numpy import align_pair
    from sift4g_tpu_torch.core.scorers import create_scorer

    monkeypatch.setattr(sw, "SCAN_CHUNK", chunk)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    rng = np.random.default_rng(11)
    for _ in range(8):
        qs = [synth._residues(rng, int(rng.integers(1, 90))) for _ in range(3)]
        ts, owner = [], []
        for _ in range(int(rng.integers(1, 9))):
            o = int(rng.integers(0, 3))
            ts.append(_homolog(rng, qs[o], rng.uniform(0.05, 0.8)) if rng.random() < 0.6
                      else synth._residues(rng, int(rng.integers(1, 120))))
            owner.append(o)
        got_s = sw.scores(qs, sw.packed(ts), owner, tables.BLOSUM62, 10, 1, "cpu")
        got_a = sw.align(qs, sw.packed(ts), owner, tables.BLOSUM62, 10, 1, "cpu")
        for t, o, s, (score, q0, t0, moves) in zip(ts, owner, got_s, got_a):
            want = align_pair(qs[o], t, scorer, "SW")
            assert s == score == want.score
            assert (q0, t0) == (want.query_start, want.target_start)
            assert np.array_equal(moves, want.moves)


def _letters(codes):
    return "".join(chr(int(c) + 65) for c in codes)


@pytest.mark.parametrize("subst", [True, False])
def test_sift_text_is_the_scalar_transcriptions(subst):
    """sift.py (the vectorised copy) against second_oracle.py on real
    alignments of mutated homologs."""
    rng = np.random.default_rng(5 if subst else 6)
    for _ in range(3):
        q = synth._residues(rng, int(rng.integers(30, 80)))
        ts = [_homolog(rng, q, r) for r in np.linspace(0.1, 0.7, int(rng.integers(2, 12)))]
        ts += [synth._residues(rng, 60)]
        recs = sw.align([q], sw.packed(ts), [0] * len(ts), tables.BLOSUM62, 10, 1, "cpu")
        recs = sorted(((s, i, q0, t0, m) for i, (s, q0, t0, m) in enumerate(recs) if s > 20),
                      key=lambda r: (-r[0], r[1]))
        tuples = [(q0, t0, m, ts[i]) for _, i, q0, t0, m in recs]
        rows = sift.alignment_rows(q.shape[0], tuples)
        lines = None
        if subst:
            pos = np.sort(rng.choice(q.shape[0], size=8, replace=False))
            lines = [f"{chr(int(q[p]) + 65)}{p + 1}{'ACDEFGHIKLMNPQRSTVWY'[int(rng.integers(20))]}"
                     for p in pos]
        got = sift.prediction(q, rows, lines, 2.75, 100.0)
        # the scalar oracle from the same records
        records = [SimpleNamespace(query_codes=q, target_codes=t, query_start=q0,
                                   target_start=t0, moves=m, target_name=f"T{k}")
                   for k, (q0, t0, m, t) in enumerate(tuples)]
        named = second_oracle.alignments_extract(_letters(q), records)
        assert [s for _, s in named] == [_letters(r) for r in rows]
        if not named:
            assert got is None
            continue
        n_sel = second_oracle.alignments_select([s for _, s in named], _letters(q), 2.75)
        want = second_oracle.thread_sift_predictions(_letters(q), named[:n_sel], lines, 100.0)
        assert got == want


def test_generator_is_seeded_and_shaped(tmp_path):
    cfg = tiny.load_config("swissprot-subst")
    a = synth.generate(cfg, 2**31 + 17, str(tmp_path / "a"), 6)
    b = synth.generate(cfg, 2**31 + 17, str(tmp_path / "b"), 6)
    c = synth.generate(cfg, 2**31 + 18, str(tmp_path / "c"), 6)
    files = ["db.fa", "jobs/job_000.fa", "subst/Q00000.subst"]
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()
    assert (tmp_path / "a" / "db.fa").read_bytes() != (tmp_path / "c" / "db.fa").read_bytes()
    assert a["db_sequences"] == np.diff(a["db_offsets"]).shape[0] == cfg["database"]["sequences"]
    lengths, fam = synth.set_shape(cfg["queries"], cfg["database"]["families"], cfg["shape_seed"])
    # every seed: the same lengths and homolog count, in another order
    for man in (a, c):
        got = np.array([man["query_codes"][n].shape[0] for n in sorted(man["query_codes"])])
        assert sorted(got.tolist()) == sorted(np.tile(lengths, cfg["queries"]["sets"]).tolist())
        assert man["homologs"] == cfg["queries"]["sets"] * fam.sum()
    ln = cfg["queries"]["set_lengths"]["lognormal"]
    assert lengths.min() >= ln["min"] and lengths.max() <= ln["max"]
    sizes = synth.family_sizes(10000, 400)
    assert sizes.min() == 0 and sizes.max() <= 400
    assert 15 <= np.median(sizes) <= 23 and 60 <= sizes.mean() <= 70
    full = synth.lognormal_quantiles(100000, 415, 560, 50, 35000)
    assert abs(np.median(full) - 415) <= 2 and abs(full.mean() - 560) / 560 < 0.02
    text = (tmp_path / "a" / "db.fa").read_text()
    assert text.count(">") == cfg["database"]["sequences"]

"""The port's CLI end to end against the JAX package's, on a seeded
synthetic database.  Tolerance: every output file byte-identical."""

import filecmp
import os
import subprocess
import sys

import pytest
import torch

from sift4g_tpu_torch.cli import main as torch_main

# the suite runs several worker processes at once: torch's OpenMP threads
# on top of them oversubscribe the cores and slow every test many times
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    d = tmp_path_factory.mktemp("syn")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_db.py"), str(d),
         "--n-db", "2000", "--n-q", "3", "--subst-per-query", "5", "--seed", "1"],
        check=True, capture_output=True,
    )
    return {"q": str(d / "queries.fa"), "d": str(d / "db.fa"), "subst": str(d), "root": d,
            "jax": {}}


def _out(syn, name):
    p = syn["root"] / name
    p.mkdir()
    return str(p)


def _jax_cli(syn, out, *extra):
    """``python -m sift4g_tpu --platform cpu --backend xla --overlap off``
    in a subprocess on one CPU device."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    syn["jax"][extra] = out
    subprocess.run(
        [sys.executable, "-m", "sift4g_tpu", "--platform", "cpu", "--backend", "xla",
         "--overlap", "off", "-q", syn["q"], "-d", syn["d"], "--out", out, *extra],
        check=True, capture_output=True, cwd=REPO, env=env,
    )


def _torch_cli(syn, out, *extra, backend="torch"):
    rc = torch_main(["--backend", backend, "-q", syn["q"], "-d", syn["d"], "--out", out, *extra])
    assert rc == 0


def _assert_same_tree(a, b):
    names_a, names_b = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert names_a == names_b
    assert any(n.endswith(".SIFTprediction") for n in names_a)
    match, mismatch, errors = filecmp.cmpfiles(a, b, names_a, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.mark.parametrize(
    "extra",
    [("--subst", None, "--sub-results"), ()],
    ids=["subst-subresults", "matrix"],
)
def test_cli_matches_jax_xla(syn, extra):
    extra = tuple(syn["subst"] if a is None else a for a in extra)
    tag = "subst" if extra else "matrix"
    ref = _jax_ref(syn, extra, tag)
    got = _out(syn, f"torch-{tag}")
    _torch_cli(syn, got, *extra)
    _assert_same_tree(ref, got)
    if extra:
        assert os.path.exists(os.path.join(got, "alignments.txt"))


def _jax_ref(syn, extra, tag):
    """The JAX CLI's output directory for ``extra``, run once per module."""
    if extra not in syn["jax"]:
        _jax_cli(syn, _out(syn, f"xla-ref-{tag}"), *extra)
    return syn["jax"][extra]


@pytest.mark.parametrize(
    "extra",
    [("--subst", None, "--sub-results"), ()],
    ids=["subst-subresults", "matrix"],
)
def test_cli_resident_matches_jax_xla(syn, extra, capsys):
    """``--backend torch --resident-db on``: the resident path through the
    plain resident scorer on the CPU, byte-identical to the JAX CLI."""
    extra = tuple(syn["subst"] if a is None else a for a in extra)
    tag = "subst" if extra else "matrix"
    ref = _jax_ref(syn, extra, tag)
    got = _out(syn, f"torch-resident-{tag}")
    _torch_cli(syn, got, "--resident-db", "on", *extra)
    assert "HBM-resident database" in capsys.readouterr().err
    _assert_same_tree(ref, got)


def test_resident_on_without_parse_cache_fails(syn, monkeypatch, capsys):
    monkeypatch.setenv("SIFT4G_TPU_NO_FASTA_CACHE", "1")
    out = _out(syn, "resident-nocache")
    rc = torch_main(["--backend", "torch", "--resident-db", "on", "-q", syn["q"],
                     "-d", syn["d"], "--out", out])
    assert rc == -1
    err = capsys.readouterr().err
    assert "error: --resident-db on: the database has no parse cache" in err


def test_resident_flag_has_no_effect_under_native(syn, capsys):
    ref, got = _out(syn, "native-res-off"), _out(syn, "native-res-on")
    args = ("--subst", syn["subst"])
    _torch_cli(syn, ref, "--resident-db", "off", *args, backend="native")
    capsys.readouterr()
    _torch_cli(syn, got, "--resident-db", "on", *args, backend="native")
    err = capsys.readouterr().err
    assert "--resident-db has no effect under --backend native" in err
    assert "HBM-resident" not in err
    _assert_same_tree(ref, got)


def test_resident_auto_keeps_slab_path_on_cpu(syn, capsys):
    out = _out(syn, "torch-auto")
    _torch_cli(syn, out, "--subst", syn["subst"])
    assert "HBM-resident" not in capsys.readouterr().err
    _assert_same_tree(_out_dir_of(syn, "torch-subst-plain"), out)


def _out_dir_of(syn, name):
    """A plain ``--backend torch --resident-db off`` subst run, made once."""
    p = syn["root"] / name
    if not p.exists():
        p.mkdir()
        _torch_cli(syn, str(p), "--resident-db", "off", "--subst", syn["subst"])
    return str(p)


@pytest.mark.parametrize("algorithm", ["NW", "HW", "OV"])
def test_cli_modes_match_native(syn, algorithm):
    ref, got = _out(syn, f"native-{algorithm}"), _out(syn, f"torch-{algorithm}")
    args = ("--algorithm", algorithm, "--subst", syn["subst"])
    _torch_cli(syn, ref, *args, backend="native")
    _torch_cli(syn, got, *args)
    _assert_same_tree(ref, got)


def test_resume_sweeps_only_exact_temp_names(syn):
    full, resumed = _out(syn, "resume-full"), _out(syn, "resume")
    args = ("--subst", syn["subst"])
    _torch_cli(syn, full, *args)
    # a finished query, a crashed writer's stray and a user's own file
    done = "QUERY_0.SIFTprediction"
    with open(os.path.join(full, done), "rb") as src, \
            open(os.path.join(resumed, done), "wb") as dst:
        dst.write(src.read())
    stray = os.path.join(resumed, "QUERY_1.SIFTprediction.tmp.4242.7")
    notes = os.path.join(resumed, "x.tmp.notes")
    for p in (stray, notes):
        with open(p, "w") as fh:
            fh.write("partial\n")
        os.utime(p, (1_000_000_000, 1_000_000_000))   # well past the grace window
    _torch_cli(syn, resumed, *args, "--resume")
    assert not os.path.exists(stray)
    assert os.path.exists(notes)
    os.unlink(notes)
    _assert_same_tree(full, resumed)


@pytest.mark.parametrize("max_alignments", [400, 3])
def test_align_parts_merge_best_first(syn, max_alignments):
    """The two-phase align phase over many database parts merges each
    part's records best-first under the cap: the files equal those of a
    run over one part.  The database is written in reverse, so a query's
    better homologs come in later parts."""
    import io

    from sift4g_tpu_torch.pipeline import PipelineConfig, run_pipeline

    with open(syn["d"]) as fp:
        records = [">" + r for r in fp.read().split(">") if r]
    db = syn["root"] / f"db-reversed-{max_alignments}.fa"
    db.write_text("".join(reversed(records)))
    outs = []
    for chunk in (1_000_000_000, 2_000):
        out = _out(syn, f"parts-{max_alignments}-{chunk}")
        run_pipeline(PipelineConfig(
            query_path=syn["q"], database_path=str(db), subst_path=syn["subst"],
            out_path=out, sub_results=True, align_backend="native", overlap="off",
            max_alignments=max_alignments, align_chunk_bytes=chunk, log=io.StringIO(),
        ))
        outs.append(out)
    _assert_same_tree(*outs)

def _brute_cut(ids, scores, evals, max_evalue, cap):
    """The reference's keep, in plain Python: E-value filter, then (score
    desc, id asc), then the cap."""
    kept = [i for i in range(len(ids)) if evals[i] <= max_evalue]
    return sorted(kept, key=lambda i: (-int(scores[i]), int(ids[i])))[:cap]


@pytest.mark.parametrize("case", ["threshold", "no_threshold", "ties_and_cap", "evalues"])
def test_keep_and_trace_cut(case, monkeypatch):
    """The one keep-and-trace step of both align schedules: the integer
    threshold keeps what the E-value filter keeps, the filter stands in
    where ``min_passing_score`` cannot invert, ties go to the smaller
    database id, the cap holds, and each record's E-value is that of
    ``evalues()`` over the whole candidate array."""
    import dataclasses

    import numpy as np

    from sift4g_tpu_torch import pipeline as tpipe
    from sift4g_tpu_torch.align.records import AlignmentRecord
    from sift4g_tpu_torch.core.chain import Chain
    from sift4g_tpu_torch.core.evalue import create_evalue_params, evalues, min_passing_score
    from sift4g_tpu_torch.core.scorers import create_scorer
    from sift4g_tpu_torch.utils import PhaseMetrics

    traced = []

    def fake_align(qcodes, targets, scorer, mode, threads=0, metrics=None):
        traced.append([int(t[0]) for t in targets])
        return [AlignmentRecord(0, 0, 0, 0, 0, np.zeros(0, np.uint8)) for _ in targets]

    monkeypatch.setattr(tpipe, "align_pairs_batch", fake_align)
    rng = np.random.default_rng(41)
    scorer = create_scorer("BLOSUM_62", 10, 1)
    query = Chain.from_string("q", "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 300)))
    params = create_evalue_params(150_000_000, scorer)
    max_evalue, cap = 1e-4, 400
    smin = min_passing_score(max_evalue, len(query), params)
    assert smin is not None and smin >= 1
    n = 2000
    if case == "no_threshold":
        # E-values that grow with the score: the statistics cannot invert
        params = dataclasses.replace(params, lam=-params.lam)
        max_evalue = 1e12
        smin = min_passing_score(max_evalue, len(query), params)
        assert smin is None
        scores = rng.integers(0, 60, n)
    elif case == "ties_and_cap":
        scores = rng.integers(smin - 1, smin + 3, n)
        cap = 37
    else:
        scores = rng.integers(smin - 20, smin + 20, n)
        scores[:4] = [smin - 1, smin, smin - 1, smin]
        if case == "threshold":
            cap = n  # the cut alone decides
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    evals = evalues(scores, len(query), params)

    def cut(smin_q):
        traced.clear()
        recs = tpipe._keep_and_trace(
            query, ids, scores, smin_q, params, max_evalue, cap, scorer, "SW", 1,
            PhaseMetrics(enabled=False),
            lambda t: np.array([t], dtype=np.int64), lambda t: f"seq{t}",
        )
        return recs, traced[0]

    recs, targets = cut(smin)
    want = _brute_cut(ids, scores, evals, max_evalue, cap)
    assert want, "the case keeps no row"
    assert [r.target_idx for r in recs] == targets == ids[want].tolist()
    assert [r.target_name for r in recs] == [f"seq{t}" for t in ids[want]]
    if case == "threshold":
        kept = set(scores[want].tolist())
        assert smin in kept and smin - 1 not in kept
        recs_f, _ = cut(None)
        assert [(r.target_idx, r.evalue) for r in recs_f] == \
            [(r.target_idx, r.evalue) for r in recs]
    elif case == "ties_and_cap":
        assert len(recs) == cap < int((scores >= smin).sum())
        pairs = [(-int(s), int(t)) for s, t in zip(scores[want], ids[want])]
        assert pairs == sorted(pairs) and len({s for s, _ in pairs}) < len(pairs)
    # "evalues": the cap binds (about 1,000 rows pass), so the kept rows
    # are not a prefix of the candidates
    assert [r.evalue for r in recs] == evals[want].tolist()

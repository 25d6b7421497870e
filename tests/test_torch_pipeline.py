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

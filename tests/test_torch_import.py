"""The port runs without JAX, refuses what it has not ported, and never
falls back to the CPU when asked for the GPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

from sift4g_tpu_torch import align as talign
from sift4g_tpu_torch.cli import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sift4g_tpu_torch")

_JAX_ABSENT_RUN = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import sift4g_tpu_torch
for m in pkgutil.walk_packages(sift4g_tpu_torch.__path__, "sift4g_tpu_torch."):
    if m.name != "sift4g_tpu_torch.__main__":
        importlib.import_module(m.name)
from sift4g_tpu_torch.cli import main
d = sys.argv[1]
rc = main(["--backend", "torch", "-q", os.path.join(d, "queries.fa"),
           "-d", os.path.join(d, "db.fa"), "--subst", d, "--out", sys.argv[2]])
sys.exit(rc)
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synthetic_db.py"), str(tmp_path),
         "--n-db", "300", "--n-q", "2", "--subst-per-query", "3", "--seed", "4"],
        check=True, capture_output=True,
    )
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_ABSENT_RUN, str(tmp_path), str(out)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "jax" not in proc.stderr.lower()
    assert any(p.endswith(".SIFTprediction") for p in os.listdir(out))


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pat.search(fh.read()):
                        offenders.append(f)
    assert not offenders


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_gpu_backend_refused_without_gpu(no_gpu, backend, capsys, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talign.resolve_backend(backend)
    from sift4g_tpu.core.scorers import create_scorer
    from sift4g_tpu_torch.align.batch import BatchAligner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchAligner(create_scorer("BLOSUM_62", 10, 1), backend=backend)
    q, d = tmp_path / "q.fa", tmp_path / "d.fa"
    q.write_text(">q\nMKV\n")
    d.write_text(">d\nMKV\n")
    argv = ["-q", str(q), "-d", str(d)] + (["--backend", backend] if backend != "auto" else [])
    assert torch_main(argv) == -1
    assert "no CUDA device" in capsys.readouterr().err


def test_cpu_backends_need_no_gpu(no_gpu):
    for name in ("torch", "native"):
        assert talign.resolve_backend(name) == (name, torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown backend"):
        talign.resolve_backend("pallas")


@pytest.mark.parametrize(
    "argv, env, item",
    [
        (["--serve", "/tmp/s.sock"], {}, 12),
        (["--connect", "/tmp/s.sock"], {}, 12),
        (["--shutdown"], {}, 12),
        ([], {"SIFT4G_COORDINATOR": "localhost:1234"}, 12),
        (["--predict-backend", "device"], {}, 9),
        (["--overlap", "on"], {}, 10),
        (["--resident-db", "on"], {}, 8),
        (["--cards", "01"], {}, 11),
    ],
    ids=["serve", "connect", "shutdown", "multihost", "device-predict", "overlap", "resident",
         "two-cards"],
)
def test_unported_surface_is_refused(argv, env, item, monkeypatch, capsys, tmp_path):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    q, d = tmp_path / "q.fa", tmp_path / "d.fa"
    q.write_text(">q\nMKV\n")
    d.write_text(">d\nMKV\n")
    assert torch_main(["-q", str(q), "-d", str(d), "--backend", "torch", *argv]) == -1
    err = capsys.readouterr().err
    assert f"not ported yet (ROADMAP item {item})" in err and err.startswith("error: ")

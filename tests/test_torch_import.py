"""The port runs without JAX and without the JAX package, refuses what it
has not ported, and never falls back to the CPU when asked for the GPU."""

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
sys.modules["sift4g_tpu"] = None   # ... and so does any import of the JAX package
import sift4g_tpu_torch
for m in pkgutil.walk_packages(sift4g_tpu_torch.__path__, "sift4g_tpu_torch."):
    if m.name != "sift4g_tpu_torch.__main__":
        importlib.import_module(m.name)
from sift4g_tpu_torch.cli import main
d = sys.argv[1]
rc = main(["--backend", "torch", "-q", os.path.join(d, "queries.fa"),
           "-d", os.path.join(d, "db.fa"), "--subst", d, "--out", sys.argv[2]])
loaded = sorted(m for m in sys.modules
                if (m == "sift4g_tpu" or m.startswith("sift4g_tpu.")) and sys.modules[m] is not None)
with open("/proc/self/maps") as fh:
    maps = fh.read()
print("LOADED", loaded)
print("JAX_NATIVE_MAPPED", os.path.join("sift4g_tpu", "native") in maps)
print("PORT_NATIVE_MAPPED", "libsift4g_native_" in maps)
sys.exit(rc)
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    from sift4g_tpu_torch.synthetic import main as make_db

    make_db([str(tmp_path), "--n-db", "300", "--n-q", "2", "--subst-per-query", "3",
             "--seed", "4"])
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
    # no module of the JAX package was loaded, and its native library was
    # never mapped: the port ran on its own copy
    assert "LOADED []" in proc.stdout
    assert "JAX_NATIVE_MAPPED False" in proc.stdout
    assert "PORT_NATIVE_MAPPED True" in proc.stdout


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_port_source_imports_jax():
    pat = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(path)
    assert not offenders


def test_no_port_source_imports_jax_package():
    pat = re.compile(r"^\s*(from|import) sift4g_tpu([ .]|$)", re.M)
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            if pat.search(fh.read()):
                offenders.append(path)
    assert not offenders


def test_native_library_is_the_ports_own():
    """The port's loader builds from ``sift4g_tpu_torch/native/*.cpp`` into
    ``sift4g_tpu_torch/_build/`` and never points at the JAX package's."""
    from sift4g_tpu_torch import native

    lib = native.load()
    assert lib is not None
    assert os.path.dirname(native.library_path()) == os.path.join(PKG, "_build")
    assert os.path.exists(native.library_path())
    assert lib._name == native.library_path()
    srcs = {os.path.basename(p) for p in native._sources()}
    assert {"search.cpp", "fasta.cpp", "aligner.cpp", "pack.cpp", "select.cpp",
            "sw_simd.cpp", "sw_simd.h", "median.cpp"} <= srcs


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from sift4g_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build(str(tmp_path / "lib.so"))
    monkeypatch.delenv("CXX")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build(str(tmp_path / "lib.so"))


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("backend", ["cuda", "auto"])
def test_gpu_backend_refused_without_gpu(no_gpu, backend, capsys, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        talign.resolve_backend(backend)
    from sift4g_tpu_torch.align.batch import BatchAligner
    from sift4g_tpu_torch.core.scorers import create_scorer

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
        (["--resident-db", "on"], {}, None),
        (["--cards", "01"], {}, 11),
    ],
    ids=["serve", "connect", "shutdown", "multihost", "device-predict", "overlap", "resident",
         "two-cards"],
)
def test_unported_surface_is_refused(argv, env, item, monkeypatch, capsys, tmp_path):
    """Each unported flag is refused naming its ROADMAP item; a flag that
    has since been ported (item None) runs and writes predictions."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if item is None:
        from sift4g_tpu_torch.synthetic import main as make_db

        make_db([str(tmp_path), "--n-db", "300", "--n-q", "2", "--seed", "4"])
        out = tmp_path / "out"
        out.mkdir()
        rc = torch_main(["-q", str(tmp_path / "queries.fa"), "-d", str(tmp_path / "db.fa"),
                         "--backend", "torch", "--out", str(out), *argv])
        assert rc == 0
        assert "HBM-resident database" in capsys.readouterr().err
        assert any(p.endswith(".SIFTprediction") for p in os.listdir(out))
        return
    q, d = tmp_path / "q.fa", tmp_path / "d.fa"
    q.write_text(">q\nMKV\n")
    d.write_text(">d\nMKV\n")
    assert torch_main(["-q", str(q), "-d", str(d), "--backend", "torch", *argv]) == -1
    err = capsys.readouterr().err
    assert f"not ported yet (ROADMAP item {item})" in err and err.startswith("error: ")

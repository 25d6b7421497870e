"""The port's bench entry points on a host without a card.

``python -m sift4g_tpu_torch.bench`` and the card-measuring subcommands of
``tools/bench_ab`` exit non-zero with ``no CUDA device`` and print no
metric line; ``ab``/``unroll`` are refused by name; ``bench_ab native``
and ``tools/bench_pipeline`` with a CPU backend run here, because the
host is what they measure."""

import json
import os
import subprocess
import sys

import pytest
import torch

from sift4g_tpu_torch.tools import bench_ab, bench_pipeline

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run a module as "python -m" would, with JAX and the JAX package unimportable
_RUN = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["sift4g_tpu"] = None
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
runpy.run_module(mod, run_name="__main__", alter_sys=True)
"""


def _run_module(*argv):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", _RUN, *argv], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)


@pytest.mark.parametrize("argv", [("sift4g_tpu_torch.bench",),
                                  ("sift4g_tpu_torch.tools.bench_ab", "roofline"),
                                  ("sift4g_tpu_torch.tools.chip_sharded_sanity",),
                                  ("sift4g_tpu_torch.tools.bench_predict", "--n", "4")],
                         ids=["bench", "bench_ab-roofline", "chip_sharded_sanity",
                              "bench_predict"])
def test_card_entry_points_fail_without_a_card(argv):
    proc = _run_module(*argv)
    assert proc.returncode != 0
    assert "error: no CUDA device" in proc.stderr
    assert "{" not in proc.stdout and "jax" not in proc.stderr.lower()


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("marginal", [None, 1500.0], ids=["no-marginal", "marginal"])
def test_roofline_pct_divides_by_the_operations_bound(marginal):
    """16.727 T int32 max-family instructions/s (the H100's peak at 1980
    MHz) over 4.5 a cell bound K1 at 3717.12 GCUPS; K5's rate divides
    nothing."""
    from sift4g_tpu_torch import bench

    peak = 64 * 132 * 1980e6
    got = bench.roofline_fields(1857.0, marginal, peak)
    bound = peak / 4.5 / 1e9
    assert got["roofline_ops_gcups"] == pytest.approx(3717.12, abs=0.01)
    assert got["roofline_pct"] == pytest.approx(100 * 1857.0 / bound)
    assert 0 < got["roofline_pct"] <= 105
    if marginal:
        assert got["marginal_roofline_pct"] == pytest.approx(100 * marginal / bound)
    else:
        assert "marginal_roofline_pct" not in got
    # a rate at the bound is 100 %
    assert bench.roofline_fields(bound, None, peak)["roofline_pct"] == pytest.approx(100.0)


@pytest.mark.parametrize("cmd", ["roofline2", "roofline4", "roofline16", "dprow", "g64", "g128",
                                 "ab"])
def test_bench_ab_card_commands_fail_without_a_card(no_gpu, cmd, capsys):
    assert bench_ab.main([cmd]) == 1
    out = capsys.readouterr()
    assert "error: no CUDA device" in out.err and out.out == ""


@pytest.mark.parametrize("cmd", ["unroll", "unroll4"])
def test_bench_ab_refuses_tpu_knobs(cmd, capsys):
    assert bench_ab.main([cmd]) == 2
    err = capsys.readouterr().err
    assert err.startswith(f"error: bench_ab {cmd} ") and "ROADMAP queue 3" in err


def test_bench_ab_unknown_command(capsys):
    assert bench_ab.main(["nope"]) == 2
    assert "unknown command" in capsys.readouterr().err


def test_bench_ab_native_runs_on_the_host(no_gpu):
    rec = bench_ab.run_native(n_targets=64, n=64, m=40)
    assert rec["metric"] == "native_cpu_score_gcups" and rec["gcups"] > 0


@pytest.fixture(scope="module")
def tiny_db(tmp_path_factory):
    from sift4g_tpu_torch.synthetic import main as make_db

    d = tmp_path_factory.mktemp("synth")
    make_db([str(d), "--n-db", "300", "--n-q", "2", "--subst-per-query", "3", "--seed", "4"])
    return d


def test_bench_pipeline_repeat_json_and_aggregate(tiny_db, tmp_path, capsys):
    runs = tmp_path / "runs.jsonl"
    rc = bench_pipeline.main([str(tiny_db), "--backend", "torch", "--repeat", "--json",
                              str(runs), "--subst", str(tiny_db), "--out",
                              str(tmp_path / "out")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "pipeline[cold]: 2 queries" in err and "pipeline[warm]: 2 queries" in err
    lines = [json.loads(x) for x in runs.read_text().splitlines()]
    assert [r["tag"] for r in lines] == ["cold", "warm"]
    assert all(r["queries"] == 2 and r["backend"] == "torch" for r in lines)
    assert {"search", "align", "select", "predict"} <= set(lines[1]["phases"])
    assert any(p.endswith(".SIFTprediction") for p in os.listdir(tmp_path / "out"))
    assert bench_pipeline.main(["--aggregate", str(runs)]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{runs} [matrix]: 1 warm runs | composite(best-of-phases)")
    assert "q/s" in out


@pytest.mark.parametrize("flags, item", [(["--overlap", "on"], None), (["--overlap-ab"], None),
                                         (["--predict-backend", "device"], None)],
                         ids=["overlap-on", "overlap-ab", "device-predict"])
def test_bench_pipeline_refuses_unported_flags(tiny_db, flags, item, capsys, tmp_path):
    """The flags once refused here (item None: since ported) run and say
    which schedule each run took."""
    assert item is None
    assert bench_pipeline.main([str(tiny_db), "--backend", "torch", "--out",
                                str(tmp_path / "out"), *flags]) == 0
    err = capsys.readouterr().err
    assert "not ported" not in err
    if "--overlap-ab" in flags:
        tags = ["cold", "warm-off", "warm-on", "warm-off2", "warm-on2"]
        assert [line.split("]")[0].split("[")[1] for line in err.splitlines()
                if line.startswith("pipeline[")] == tags
        assert "overlap=on" in err and "overlap=off" in err
    if "--predict-backend" in flags:
        assert "predict=device" in err and "predict.pack" in err
    assert any(p.endswith(".SIFTprediction") for p in os.listdir(tmp_path / "out"))


def test_bench_predict_runs_on_the_cpu_when_asked(tmp_path):
    """``bench_predict --device cpu``: the JAX tool's mix, cold and warm,
    one JSON line naming the CPU and no card."""
    proc = _run_module("sift4g_tpu_torch.tools.bench_predict", "--n", "6", "--device", "cpu",
                       "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[1].startswith("predict[cold] n=6 device=cpu")
    assert lines[2].startswith("predict[warm] n=6 device=cpu")
    rec = json.loads(lines[-1])
    assert rec["device"] == "cpu" and rec["card"] is None and rec["widths"] == [64]
    assert [r["tag"] for r in rec["runs"]] == ["cold", "warm"]
    assert all("predict.pack" in r and "peak_bytes" not in r for r in rec["runs"])
    assert sorted(os.listdir(tmp_path)) == [f"q{i:05d}.SIFTprediction" for i in range(6)]


def test_bench_pipeline_cuda_fails_without_a_card(no_gpu, tiny_db, capsys):
    assert bench_pipeline.main([str(tiny_db)]) == 1
    assert "error: no CUDA device" in capsys.readouterr().err

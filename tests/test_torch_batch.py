"""The port's BatchAligner (backend "torch": the grouped launch policy on
the CPU twin) against the JAX package's BatchAligner ("xla" and "numpy").
Tolerance: exact integer equality."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from sift4g_tpu.align.batch import BatchAligner as JaxAligner
from sift4g_tpu.align.batch import PackedTargets as JaxPacked
from sift4g_tpu.core.scorers import create_scorer
from sift4g_tpu_torch.align.batch import BatchAligner
from sift4g_tpu_torch.align.host import PackedTargets

# the suite runs several worker processes at once: torch's OpenMP threads
# on top of them oversubscribe the cores and slow every test many times
torch.set_num_threads(1)

SCORER = create_scorer("BLOSUM_62", 10, 1)


def _items(rng, n_queries=3, per_query=(0, 5, 23), tmax=300):
    items = []
    for qi in range(n_queries):
        q = rng.integers(0, 26, int(rng.integers(20, 90))).astype(np.uint8)
        targets = [
            rng.integers(0, 26, int(rng.integers(3, tmax))).astype(np.uint8)
            for _ in range(per_query[qi % len(per_query)])
        ]
        items.append((q, targets))
    return items


def _packed(targets, cls=PackedTargets):
    lens = np.array([t.shape[0] for t in targets], dtype=np.int32)
    starts = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    codes = np.concatenate(targets) if targets else np.zeros(0, np.uint8)
    return cls(codes, starts, lens)


def _as_jax(items):
    """The same items with the JAX package's PackedTargets."""
    return [(q, JaxPacked(t.codes, t.starts, t.lens) if isinstance(t, PackedTargets) else t)
            for q, t in items]


def _jax(mode, backend, **kw):
    al = JaxAligner(SCORER, mode=mode, backend=backend, **kw)
    al._mesh = None   # the CPU test platform has 8 virtual devices
    return al


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["SW", "NW", "HW", "OV"])
@pytest.mark.parametrize("packed", [False, True], ids=["lists", "packed"])
def test_scores_match_jax_backends(mode, packed):
    items = _items(np.random.default_rng(77))
    if packed:
        items = [(q, _packed(t)) for q, t in items]
    al = BatchAligner(SCORER, mode=mode, backend="torch", b_cap=8)
    got = al.scores_many(items)
    _assert_all_equal(got, _jax(mode, "numpy").scores_many(_as_jax(items)))
    _assert_all_equal(got, _jax(mode, "xla", batch=8).scores_many(_as_jax(items)))
    assert al.launches > 0


@pytest.mark.parametrize("packed", [False, True], ids=["lists", "packed"])
def test_screened_keep_lists_match_jax(packed):
    """Screened launches return only each group's top-k survivors; after
    the pipeline's ``score >= smin`` filter the keep lists equal the JAX
    package's screened xla path and the unscreened oracle."""
    rng = np.random.default_rng(5)
    items = _items(rng, n_queries=4, per_query=(40, 9, 30, 0))
    if packed:
        items = [(q, _packed(t)) for q, t in items]
    ref = _jax("SW", "numpy").scores_many(_as_jax(items))
    smins = [max(1, int(np.median(r))) if len(r) else 1 for r in ref]
    k = 6
    got = BatchAligner(SCORER, backend="torch", b_cap=16).scores_many_async(
        items, screen=(smins, k))()
    jx = _jax("SW", "xla", b_cap=16).scores_many_async(_as_jax(items), screen=(smins, k))()

    def keep(scores, smin):
        idx = np.flatnonzero(scores >= smin)
        return sorted(idx.tolist(), key=lambda i: (-int(scores[i]), i))[:k]

    for g, j, r, s in zip(got, jx, ref, smins):
        assert keep(g, s) == keep(r, s) == keep(j, s)
        np.testing.assert_array_equal(g[keep(g, s)], r[keep(r, s)])


def test_screen_gate_refuses_bad_thresholds():
    rng = np.random.default_rng(9)
    q = rng.integers(0, 26, 50).astype(np.uint8)
    targets = [rng.integers(0, 26, 70).astype(np.uint8) for _ in range(9)]
    ref = _jax("SW", "numpy").scores_many([(q, targets)])[0]
    al = BatchAligner(SCORER, backend="torch", b_cap=32)
    for bad in ([None], [0], [-3]):
        got = al.scores_many_async([(q, targets)], screen=(bad, 5))()[0]
        np.testing.assert_array_equal(got, ref)


def test_tail_policies_score_identically():
    rng = np.random.default_rng(13)
    q = rng.integers(0, 26, 64).astype(np.uint8)
    # 700 targets at one rung: full packs 512 + a 512-wide tail for the
    # 188 remainder; pow2 packs 512 + 256
    targets = [rng.integers(0, 26, int(rng.integers(30, 120))).astype(np.uint8)
               for _ in range(700)]
    ref = _jax("SW", "numpy").scores_many([(q, targets)])[0]
    for policy in ("full", "pow2"):
        al = BatchAligner(SCORER, backend="torch", b_cap=512, tail_policy=policy)
        np.testing.assert_array_equal(al.scores_many([(q, targets)])[0], ref)
    pow2 = BatchAligner(SCORER, backend="torch", b_cap=512)
    assert pow2.tail_policy == "pow2"
    assert [pow2._group_width(n, 512) for n in (512, 188, 10)] == [512, 256, 256]
    assert pow2._group_width(300, 4096) == 512
    full = BatchAligner(SCORER, backend="torch", b_cap=512, tail_policy="full")
    assert full._group_width(188, 512) == 512
    with pytest.raises(ValueError, match="tail_policy"):
        BatchAligner(SCORER, backend="torch", tail_policy="half")


def test_tail_coalescing_merges_rungs():
    """Remainders of three rungs merge into one group (one launch) and the
    scores stay exact."""
    rng = np.random.default_rng(29)
    q = rng.integers(0, 26, 64).astype(np.uint8)
    targets = (
        [rng.integers(0, 26, int(rng.integers(10, 120))).astype(np.uint8) for _ in range(40)]
        + [rng.integers(0, 26, int(rng.integers(180, 250))).astype(np.uint8) for _ in range(30)]
        + [rng.integers(0, 26, int(rng.integers(300, 380))).astype(np.uint8) for _ in range(20)]
    )
    ref = _jax("SW", "numpy").scores_many([(q, targets)])[0]
    launches = {}
    for coalesce in (True, False):
        al = BatchAligner(SCORER, backend="torch", b_cap=512, tail_coalesce=coalesce)
        np.testing.assert_array_equal(al.scores_many([(q, targets)])[0], ref)
        launches[coalesce] = al.launches
    assert launches[True] == 1 and launches[False] == 3


@pytest.mark.parametrize("mode", ["SW", "OV"])
def test_rung_past_old_planes_cutoff_uses_grouped_scorer(mode):
    """Targets past the JAX package's 14 MiB planes cutoff (rung 3072) go
    to its long-target route, and in the port to K2 (its plain version
    here: the grouped scorer's), one launch with the short target its
    tail took along.  Held to the JAX xla backend, which scans those
    targets."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 26, 70).astype(np.uint8)
    targets = [
        rng.integers(0, 26, 2500).astype(np.uint8),
        rng.integers(0, 26, 2900).astype(np.uint8),
        rng.integers(0, 26, 140).astype(np.uint8),
    ]
    al = BatchAligner(SCORER, mode=mode, backend="torch")
    got = al.scores_many([(q, targets)])[0]
    np.testing.assert_array_equal(got, _jax(mode, "xla", batch=8).scores_many([(q, targets)])[0])
    assert al.launches == 1


def test_many_groups_split_across_launches_by_scratch_budget():
    """A launch holds as many groups as the scratch budget admits."""
    rng = np.random.default_rng(21)
    items = _items(rng, n_queries=6, per_query=(30,), tmax=120)
    al = BatchAligner(SCORER, backend="torch", b_cap=32)
    al.scratch_bytes = 8 * 32 * 128 * 2      # two (B=32, rung 128) groups
    got = al.scores_many(items)
    _assert_all_equal(got, _jax("SW", "numpy").scores_many(items))
    assert al.launches == 3


def test_native_backend_matches_numpy():
    items = _items(np.random.default_rng(8))
    got = BatchAligner(SCORER, backend="native").scores_many(items)
    _assert_all_equal(got, _jax("SW", "numpy").scores_many(items))


def test_refuses_backend_device_mismatch():
    with pytest.raises(ValueError, match="CUDA device"):
        BatchAligner(SCORER, backend="cuda", devices=torch.device("cpu"))


def test_python_pack_without_native_library(monkeypatch):
    """Without the native library the slabs are packed in Python (PAD
    tails); the scores do not change."""
    from sift4g_tpu_torch.align import batch as tbatch

    items = _items(np.random.default_rng(12))
    items = [(q, _packed(t)) if i % 2 else (q, t) for i, (q, t) in enumerate(items)]
    monkeypatch.setattr(tbatch, "load_native", lambda: None)
    got = BatchAligner(SCORER, backend="torch", b_cap=8).scores_many(items)
    _assert_all_equal(got, _jax("SW", "numpy").scores_many(_as_jax(items)))

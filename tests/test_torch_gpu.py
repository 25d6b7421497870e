"""The CUDA kernels (K1 on slabs, K3 on the resident database) against
their plain PyTorch versions, on the card.

These tests need a CUDA device and skip without one.  They import no JAX,
so they run on a GPU host that has none:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Tolerance: exact int32 equality (the scores are integers)."""

import numpy as np
import pytest
import torch

from sift4g_tpu_torch.align import scan, sw_grouped

MODES = ["SW", "NW", "HW", "OV"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _blosum62():
    from sift4g_tpu_torch.core.scorers import create_scorer

    return create_scorer("BLOSUM_62", 10, 1)


def _inputs(seed, G, B, N, qlens, dev):
    """Ragged lengths, a zero-length group, zero-length rows and int8
    garbage past every length, as device tensors."""
    rng = np.random.default_rng(seed)
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    targets = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(0, N + 1, size=(G, B)).astype(np.int32)
    lens[0, 0], lens[0, -1] = N, 0
    for g in range(G):
        for b in range(B):
            targets[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return [torch.from_numpy(a).to(dev) for a in (q_all, offs, qlens, targets, lens)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape",
    [(5, 200, 256, (51, 17, 0, 64, 300)), (2, 40, 4096, (120, 33))],
    ids=["ragged", "long-rung"],
)
def test_kernel_matches_twin(cuda, mode, shape):
    G, B, N, qlens = shape
    args = _inputs(7, G, B, N, qlens, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    launches = sw_grouped.kernel_launches
    got = sw_grouped.sw_scores_grouped(*args, m32, mode=mode)
    ref = scan.align_scores_grouped(*args, m32, mode=mode)
    torch.cuda.synchronize()
    assert sw_grouped.kernel_launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (G, B)
    assert torch.equal(got, ref)
    smin = torch.full((G,), 20, dtype=torch.int32, device=cuda)
    assert torch.equal(
        scan.screen_topk_words(got, smin, 16), scan.screen_topk_words(ref, smin, 16)
    )


@pytest.mark.gpu
def test_kernel_refuses_unaligned_rows(cuda):
    args = _inputs(1, 1, 4, 24, (10,), cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    with pytest.raises(ValueError, match="16-byte"):
        sw_grouped.sw_scores_grouped(*args, m32)


def _resident_inputs(seed, G, B, N, qlens, dev):
    """A resident database of ragged sequences (16-byte slots, tail pad),
    rows drawn from it in ascending order, zero-length rows, and the last
    sequence (5 residues) among them: its window runs past the data."""
    from sift4g_tpu_torch.align.resident import ResidentDB

    rng = np.random.default_rng(seed)
    lens_seq = rng.integers(0, N + 1, G * B + 7).astype(np.int64)
    lens_seq[-2:] = (N, 5)
    offsets = np.concatenate(([0], np.cumsum(lens_seq)))
    codes = rng.integers(0, 26, int(offsets[-1])).astype(np.uint8)
    rdb = ResidentDB(codes, offsets, dev)
    ids = np.sort(rng.choice(G * B + 6, G * B, replace=False)).reshape(G, B)
    ids[-1, -1] = G * B + 6
    qlens = np.asarray(qlens, dtype=np.int32)
    offs = np.concatenate(([0], np.cumsum(qlens)[:-1])).astype(np.int32)
    q_all = np.full(int(qlens.sum()) + 1, 31, dtype=np.int32)
    q_all[: qlens.sum()] = rng.integers(0, 26, int(qlens.sum()))
    host = (q_all, offs, qlens, rdb.slot_off[ids], lens_seq[ids].astype(np.int32))
    q, o, ql, st, tl = [torch.from_numpy(a).to(dev) for a in host]
    return rdb, (q, o, ql, rdb.dev, st, tl)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "shape",
    [(5, 200, 256, (51, 17, 0, 64, 300)), (2, 40, 4096, (120, 33))],
    ids=["ragged", "long-rung"],
)
def test_resident_kernel_matches_plain_and_slab_kernel(cuda, mode, shape):
    G, B, N, qlens = shape
    rdb, args = _resident_inputs(11, G, B, N, qlens, cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    launches = sw_grouped.resident_launches
    got = sw_grouped.sw_scores_grouped_resident(*args, m32, N, mode=mode)
    ref = scan.align_scores_grouped_resident(*args, m32, N, mode=mode)
    torch.cuda.synchronize()
    assert sw_grouped.resident_launches == launches + 1
    assert got.dtype == torch.int32 and got.shape == (G, B)
    assert torch.equal(got, ref)
    # K1 fed the same windows as a slab
    st = args[4]
    slab = args[3][st[..., None] + torch.arange(N, device=cuda)].view(torch.int8).contiguous()
    k1 = sw_grouped.sw_scores_grouped(*args[:3], slab, args[5], m32, mode=mode)
    assert torch.equal(got, k1)


@pytest.mark.gpu
def test_resident_kernel_refuses_bad_window(cuda):
    rdb, args = _resident_inputs(1, 1, 8, 64, (10,), cuda)
    m32 = scan.matrix32_from_scorer(_blosum62(), cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        sw_grouped.sw_scores_grouped_resident(*args, m32, 24)
    with pytest.raises(TypeError, match="int64"):
        sw_grouped.sw_scores_grouped_resident(*args[:4], args[4].int(), args[5], m32, 64)

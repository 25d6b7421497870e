"""The CUDA kernel against its plain PyTorch twin, on the card.

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
    from sift4g_tpu.core.scorers import create_scorer

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

"""The port's probes (align/roofline.py) against the JAX package's kernels.

The JAX functions return timings only, so the Pallas kernel and keyword
arguments each of them hands ``pallas_call`` are captured (a stand-in
``pallas_call`` raises before any timing) and run in interpret mode on
``[M, salt]``.  K5: ``sift4g_tpu/align/roofline.py:dp_row_roofline``;
K6: ``tools/bench_ab.py`` ``run_roofline`` and ``run_roofline_ilp``,
loaded from their file without running the script.  A serial Gotoh
reference in numpy pins the equivalence K5's CUDA design relies on.
Tolerance: exact int32 equality (every value is an integer)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from sift4g_tpu_torch.align import roofline  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Captured(Exception):
    def __init__(self, kern, kw):
        super().__init__("captured")
        self.kern, self.kw = kern, kw


def _capture(monkeypatch, fn, **kwargs):
    """The Pallas kernel and keyword arguments ``fn(**kwargs)`` passes to
    ``pallas_call``, and the real ``pallas_call``."""
    real = pl.pallas_call

    def stand_in(kern, **kw):
        raise _Captured(kern, kw)

    monkeypatch.setattr(pl, "pallas_call", stand_in)
    with pytest.raises(_Captured) as info:
        fn(**kwargs)
    monkeypatch.setattr(pl, "pallas_call", real)
    return real, info.value


def _run_captured(real, cap, M, salt):
    out = real(cap.kern, interpret=True, **cap.kw)(jnp.asarray(np.array([M, salt], np.int32)))
    return np.asarray(out).reshape(-1)


def _bench_ab():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_ab", os.path.join(REPO, "tools", "bench_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gotoh_row_numpy(M, salt, N, go, ge):
    """One row of K5, cell by cell: serial Gotoh with E_0 = -go and
    E_j = max(E_{j-1} - ge, G_{j-1} - go), the form the CUDA kernel runs."""
    s0 = [j % 11 - 4 + salt for j in range(N)]
    s1 = [(j + 5) % 13 - 6 - salt for j in range(N)]
    H = [0] * N
    F = [roofline.NEGL] * N
    best = 0
    for i in range(M):
        diag, e, gprev = 0, -go + ge, -(1 << 28)
        for j in range(N):
            f = max(H[j] - go, F[j] - ge)
            s = s0[j] if (j + i) % 2 == 0 else s1[j]
            g = max(diag + s, f, 0)
            e = max(e - ge, gprev - go)
            h = max(g, e)
            diag, gprev = H[j], g
            H[j], F[j] = h, f
            best = max(best, h)
    return best


# (B, N, go, ge, M, salt); the first three rows are the documented cases
# (expected 35, 340, 47)
K5_CASES = [
    (8, 16, 10, 1, 5, 3),
    (4, 128, 10, 1, 40, 7),
    (4, 48, 11, 2, 33, 0),
    (4, 64, 5, 2, 20, 101),
    (4, 128, 5, 2, 30, -20),
    (16, 48, 11, 2, 0, 9),
]


@pytest.mark.parametrize("case", K5_CASES, ids=lambda c: "B{}-N{}-g{}/{}-M{}-s{}".format(*c))
def test_dp_row_plain_matches_pallas(monkeypatch, case):
    from sift4g_tpu.align.roofline import dp_row_roofline

    B, N, go, ge, M, salt = case
    real, cap = _capture(monkeypatch, dp_row_roofline, B=B, N=N, go=go, ge=ge)
    ref = _run_captured(real, cap, M, salt)
    got = roofline.dp_row_probe_plain(M, salt, B=B, N=N, go=go, ge=ge)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    expected = {(8, 16, 5, 3): 35, (4, 128, 40, 7): 340, (4, 48, 33, 0): 47}
    if (B, N, M, salt) in expected:
        assert (ref == expected[(B, N, M, salt)]).all()


@pytest.mark.parametrize("case", K5_CASES + [(2, 200, 3, 1, 17, -5)],
                         ids=lambda c: "B{}-N{}-g{}/{}-M{}-s{}".format(*c))
def test_dp_row_plain_matches_serial_gotoh(case):
    B, N, go, ge, M, salt = case
    got = roofline.dp_row_probe_plain(M, salt, B=B, N=N, go=go, ge=ge)
    assert (got == gotoh_row_numpy(M, salt, N, go, ge)).all()


# (B, N, M, salt): B > N + 2 salt makes b - salt beat n + salt, so rows differ
K6_CASES = [(8, 16, 7, 3), (64, 16, 7, 3), (40, 24, 13, -4), (33, 5, 0, 2)]


@pytest.mark.parametrize("case", K6_CASES, ids=lambda c: "B{}-N{}-M{}-s{}".format(*c))
def test_int32_plain_matches_run_roofline(monkeypatch, case):
    B, N, M, salt = case
    real, cap = _capture(monkeypatch, _bench_ab().run_roofline, B=B, N=N)
    ref = _run_captured(real, cap, M, salt)
    if (B, N, M, salt) == (8, 16, 7, 3):
        assert (ref == 25).all()
    got = roofline.int32_probe_plain(M, salt, B=B, N=N, pairs=1)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    if B > N + 2 * salt + M:
        assert len(np.unique(ref)) > 1


@pytest.mark.parametrize("pairs", [2, 4])
@pytest.mark.parametrize("case", K6_CASES[:3], ids=lambda c: "B{}-N{}-M{}-s{}".format(*c))
def test_int32_plain_matches_run_roofline_ilp(monkeypatch, pairs, case):
    B, N, M, salt = case
    real, cap = _capture(monkeypatch, _bench_ab().run_roofline_ilp, B=B, N=N, pairs=pairs)
    ref = _run_captured(real, cap, M, salt)
    if (B, N, M, salt, pairs) == (8, 16, 7, 3, 2):
        assert (ref == 26).all()
    got = roofline.int32_probe_plain(M, salt, B=B, N=N, pairs=pairs)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrappers_on_cpu_run_the_plain_versions():
    before = (roofline.dp_row_launches, roofline.int32_launches)
    got = roofline.dp_row_probe(12, 5, B=3, N=40, go=11, ge=2, device="cpu")
    assert torch.equal(got, roofline.dp_row_probe_plain(12, 5, B=3, N=40, go=11, ge=2))
    out = torch.empty(3, dtype=torch.int32)
    assert roofline.dp_row_probe(12, 5, B=3, N=40, go=11, ge=2, device="cpu", out=out) is out
    assert torch.equal(out, got)
    for pairs in roofline.INT32_PAIRS:
        got = roofline.int32_probe(9, -2, B=20, N=8, pairs=pairs, device="cpu")
        assert torch.equal(got, roofline.int32_probe_plain(9, -2, B=20, N=8, pairs=pairs))
    # the CPU never counts as a launch
    assert (roofline.dp_row_launches, roofline.int32_launches) == before


@pytest.mark.parametrize("probe", [roofline.dp_row_probe, roofline.int32_probe],
                         ids=["dp_row_probe", "int32_probe"])
def test_wrappers_refuse_bad_arguments(probe):
    with pytest.raises(TypeError, match="int32"):
        probe(4, 1, B=4, N=16, device="cpu", out=torch.empty(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape|contiguous"):
        probe(4, 1, B=4, N=16, device="cpu", out=torch.empty(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="out is on"):
        probe(4, 1, B=4, N=16, device="cpu",
              out=torch.empty(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        probe(4, 1, B=4, N=16, device="meta")
    with pytest.raises(ValueError, match="positive"):
        probe(4, 1, B=0, N=16, device="cpu")
    with pytest.raises(ValueError, match="round count"):
        probe(-1, 1, B=4, N=16, device="cpu")
    with pytest.raises(ValueError, match="salt"):
        probe(4, 1 << 21, B=4, N=16, device="cpu")


def test_wrapper_limits():
    with pytest.raises(ValueError, match="exceeds"):
        roofline.dp_row_probe(1, 0, B=1, N=roofline.MAX_DP_ROW_N + 1, device="cpu")
    with pytest.raises(ValueError, match="pairs"):
        roofline.int32_probe(1, 0, B=1, N=4, pairs=3, device="cpu")


def test_timing_entry_points_refuse_the_cpu(monkeypatch):
    with pytest.raises(RuntimeError, match="not cpu"):
        roofline.dp_row_roofline(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.int32_roofline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.dp_row_roofline()


# an excerpt of what cuobjdump -sass prints for sm_90a: an outer loop
# (0x0050-0x00c0) holding the hot loop (0x0060-0x00a0), and the final
# branch to itself
_SASS = """
	code for sm_90a
		Function : _ZN6sift4g12_GLOBAL__N_118int32_probe_kernelILi2EEEviiiPi
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                       /* 0x0000000000007919 */
        /*0050*/                   IMAD.MOV.U32 R2, RZ, RZ, R3 ;            /* 0x000000ffff027224 */
        /*0060*/                   VIADDMNMX R4, R2, 0x1, R3, !PT ;         /* 0x0000000102047846 */
        /*0070*/                   VIADDMNMX R3, R3, 0xffffffff, R2, !PT ;  /* 0x0000000103037846 */
        /*0080*/                   VIADD R8, R8, 0xfffffffc ;               /* 0xfffffffc08087836 */
        /*0090*/                   ISETP.NE.AND P1, PT, R8, RZ, PT ;        /* 0x000000ff0800720c */
        /*00a0*/               @P1 BRA 0x60 ;                               /* 0xfffffffc00e41947 */
        /*00b0*/              @!P0 VIMNMX3 R2, R4, R3, R2, !PT ;            /* 0x0000000204027c0f */
        /*00c0*/              @!P2 BRA 0x50 ;                               /* 0xfffffffc00e4a947 */
        /*00d0*/                   EXIT ;                                   /* 0x000000000000794d */
        /*00e0*/                   BRA 0xe0;                                /* 0xfffffffc00fc7947 */
		Function : _ZN6sift4g12_GLOBAL__N_119dp_row_probe_kernelEiiiiiiP4int2Pi
        /*0000*/                   EXIT ;                                   /* 0x000000000000794d */
"""


def test_sass_loop_parser():
    loops = roofline.sass_loops(_SASS)
    k6 = loops["_ZN6sift4g12_GLOBAL__N_118int32_probe_kernelILi2EEEviiiPi"]
    assert k6 == {"VIADDMNMX": 2, "VIADD": 1, "ISETP": 1, "BRA": 1}
    assert sum(loops["_ZN6sift4g12_GLOBAL__N_119dp_row_probe_kernelEiiiiiiP4int2Pi"].values()) == 0
    m = roofline._K6_NAME.search(next(iter(loops)))
    assert int(m.group(1)) == 2
    insns = roofline.sass_instructions(_SASS)
    assert list(insns) == list(loops)
    assert insns["_ZN6sift4g12_GLOBAL__N_118int32_probe_kernelILi2EEEviiiPi"][3] == (
        "VIADDMNMX R4, R2, 0x1, R3, !PT")
    assert insns["_ZN6sift4g12_GLOBAL__N_119dp_row_probe_kernelEiiiiiiP4int2Pi"] == ["EXIT"]

"""The port's probes (align/roofline.py) against the JAX package's kernels.

The JAX functions return timings only, so the Pallas kernel and keyword
arguments each of them hands ``pallas_call`` are captured (a stand-in
``pallas_call`` raises before any timing) and run in interpret mode on
``[M, salt]``.  K5: ``sift4g_tpu/align/roofline.py:dp_row_roofline``;
K6: ``tools/bench_ab.py`` ``run_roofline`` and ``run_roofline_ilp``,
loaded from their file without running the script.  A serial Gotoh
reference in numpy pins the equivalence K5's CUDA design relies on, and
a transcription of the kernel's schedule (lanes, shuffles, strips, row
tiles and padding columns, at small lane, column and tile counts) is held
to it.  Tolerance: exact int32 equality (every value is an integer)."""

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


def wavefront_numpy(M, salt, N, go, ge, T, C, R):
    """One row of K5 as csrc/dp_row_roofline.cu schedules it: T lanes of
    C columns a strip, lane t on query row s - t at step s, the E and
    last-column H passed one lane right after each step, columns past N
    scoring 0 and entering ``best`` unmasked; a row wider than T x C runs
    its strips in turn over tiles of R rows, the right edge handed on in
    two alternating buffers and each strip's bottom row kept between
    tiles."""
    W = T * C
    strips = -(-N // W)
    wide = strips > 1
    lanes = np.arange(T)
    bottom = [(np.zeros((T, C), np.int64), np.full((T, C), roofline.NEGL, np.int64))] * strips
    best = np.zeros(T, np.int64)
    edge = [[(0, 0)] * R, [(0, 0)] * R]
    for r0 in range(0, M, R) if wide else [0]:
        rows = min(R, M - r0) if wide else M
        corner = 0
        for strip in range(strips):
            cols = strip * W + lanes[:, None] * C + np.arange(C)
            s0 = np.where(cols < N, cols % 11 - 4 + salt, 0)
            s1 = np.where(cols < N, (cols + 5) % 13 - 6 - salt, 0)
            even = (r0 - lanes[:, None] + cols) % 2 == 0
            sa, sb = np.where(even, s0, s1), np.where(even, s1, s0)
            h, f = (x.copy() for x in bottom[strip])
            corner_next = h[T - 1, C - 1]
            ein, eout = edge[(strip + 1) % 2], edge[strip % 2]

            def left(i):
                return ein[min(i, R - 1)] if strip > 0 else (-go, 0)

            diag = np.zeros(T, np.int64)
            diag[0] = corner
            e = np.zeros(T, np.int64)
            hl = np.concatenate([[0], h[:-1, C - 1]])
            e[0], hl[0] = left(0)
            eo = np.zeros(T, np.int64)
            # whole pairs, at least T & ~1 steps, as the kernel's loops run
            for s in range(max(rows + T - 1 + (rows + T - 1) % 2, T & ~1)):
                sc = sa if s % 2 == 0 else sb
                for t in range(T):
                    if not 0 <= s - t < rows:
                        continue
                    d, ee, gl, hp = diag[t], e[t], 0, 0
                    for k in range(C):
                        if k > 0:
                            ee = max(ee - ge, gl - go)
                        fk = max(h[t, k] - go, f[t, k] - ge)
                        g = max(d + sc[t, k], fk, 0)
                        hk = max(g, ee)
                        d, h[t, k], f[t, k], gl = h[t, k], hk, fk, g
                        if k % 2:
                            best[t] = max(best[t], hp, hk)
                        hp = hk
                    eo[t] = max(ee - ge, gl - go)
                    if wide and t == T - 1 and strip + 1 < strips:
                        eout[s - t] = (eo[t], h[t, C - 1])
                diag = hl.copy()
                e = np.concatenate([[0], eo[:-1]])
                hl = np.concatenate([[0], h[:-1, C - 1]])
                e[0], hl[0] = left(s + 1)
            bottom[strip] = (h, f)
            corner = corner_next
    return int(best.max())


# (B, N, go, ge, M, salt); the first three rows are the documented cases
# (expected 35, 340, 47); then go < ge, and a row one column past a strip
K5_CASES = [
    (8, 16, 10, 1, 5, 3),
    (4, 128, 10, 1, 40, 7),
    (4, 48, 11, 2, 33, 0),
    (4, 64, 5, 2, 20, 101),
    (4, 128, 5, 2, 30, -20),
    (16, 48, 11, 2, 0, 9),
    (4, 48, 1, 3, 20, 2),
    (2, 513, 10, 1, 9, 4),
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


# (T, C, R): lanes, columns a lane and rows a tile of the kernel's schedule,
# small so that strips, tiles, padding and the wavefront's ramps all show
WAVEFRONT_SHAPES = [(4, 4, 8), (2, 4, 5), (1, 4, 6), (8, 2, 7)]


@pytest.mark.parametrize("shape", WAVEFRONT_SHAPES, ids=lambda c: "T{}-C{}-R{}".format(*c))
def test_wavefront_schedule_matches_serial_gotoh(shape):
    T, C, R = shape
    rng = np.random.default_rng(T * 100 + C * 10 + R)
    W = T * C
    for N in sorted({1, 3, W - 1, W, W + 1, 3 * W + 2}):
        for M in sorted({0, 1, 2, T - 1, T, T + 1, R - 1, R, R + 1, 2 * R + 3}):
            for go, ge in [(10, 1), (11, 2), (1, 3), (0, 0)]:
                salt = int(rng.integers(-30, 30))
                got = wavefront_numpy(M, salt, N, go, ge, T, C, R)
                assert got == gotoh_row_numpy(M, salt, N, go, ge), (N, M, go, ge, salt)


@pytest.mark.parametrize("case", [
    ((65536, 512, 132), (32, 16, 128, 1)),   # the bench's shape
    ((1024, 512, 132), (32, 16, 128, 1)),    # the JAX default
    ((1024, 1, 132), (1, 16, 32, 1)),
    ((1024, 17, 132), (2, 16, 32, 1)),
    ((1, 200, 132), (16, 16, 32, 1)),
    ((1024, 513, 132), (32, 16, 128, 2)),
    ((1024, 6144, 132), (32, 16, 128, 12)),
], ids=["bench", "B1024", "N1", "N17", "B1-N200", "N513", "N6144"])
def test_dp_row_geometry(case):
    args, want = case
    assert roofline.dp_row_geometry(*args) == want
    T, C, block, strips = want
    assert T * C * strips >= args[1] and (strips == 1 or T == 32)


def test_dp_row_geometry_refuses_wide_rows():
    with pytest.raises(ValueError, match="exceeds"):
        roofline.dp_row_geometry(1024, roofline.MAX_DP_ROW_N + 1, 132)
    with pytest.raises(ValueError, match="positive"):
        roofline.dp_row_geometry(0, 512, 132)


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


@pytest.mark.parametrize("pairs", [1, 2, 4])
@pytest.mark.parametrize("case", [(8, 16, 7, 3), (40, 24, 13, -4), (6, 5, 32_760, 2)],
                         ids=["B8-M7", "B40-M13", "B6-M32760-wraps"])
def test_int32_plain_packed_matches_int16_elements(pairs, case):
    """K6's int16 form: every element of a pair runs the int32 update
    in int16, wrapping (the last case passes 32,767), the second starting
    one further on; rows take the maximum over both."""
    B, N, M, salt = case
    ref = np.full(B, np.iinfo(np.int32).min, np.int64)
    for p in range(pairs):
        for h in range(2):
            a = (np.arange(N)[None, :] + salt + p + h).repeat(B, 0).astype(np.int16)
            b = (np.arange(B)[:, None] - salt - p - h).repeat(N, 1).astype(np.int16)
            with np.errstate(over="ignore"):
                for _ in range(M):
                    a, b = np.maximum(a + np.int16(1), b), np.maximum(b - np.int16(1), a)
            ref = np.maximum(ref, np.maximum(a, b).max(axis=1))
    got = roofline.int32_probe_plain(M, salt, B=B, N=N, pairs=pairs, packed=True)
    assert got.dtype == torch.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(roofline.int32_probe(M, salt, B=B, N=N, pairs=pairs, packed=True,
                                            device="cpu"), got)


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


def _k5_sass(loops):
    """cuobjdump-like text of one K5 instantiation with a loop for each
    (max-family instructions, other instructions) in ``loops``."""
    lines, addr = ["\t\tFunction : _ZN6sift4g12_GLOBAL__N_119dp_row_probe_kernelILb0EEEviii"], 0
    for n_max, n_other in loops:
        top = addr
        for k in range(n_max + n_other):
            op = "VIADDMNMX R4, R2, 0x1, R3, !PT" if k < n_max else "SHFL.UP PT, R5, R6, 0x1, RZ"
            lines.append(f"        /*{addr:04x}*/                   {op} ;")
            addr += 16
        lines.append(f"        /*{addr:04x}*/               @P1 BRA 0x{top:x} ;")
        addr += 16
    lines.append(f"        /*{addr:04x}*/                   EXIT ;")
    return "\n".join(lines) + "\n"


def test_dp_row_probe_sass_orders_the_step_loops(monkeypatch):
    # a guarded loop (more instructions), the steady-state loop, and a
    # short loop that runs no whole step pair
    monkeypatch.setattr(roofline, "library_sass", lambda path=None: _k5_sass(
        [(32, 16), (32, 7), (4, 2)]))
    (fn, loops), = roofline.dp_row_probe_sass().items()
    assert "dp_row_probe_kernel" in fn
    assert [per for _, per in loops] == [40 / 32, 49 / 32]
    assert loops[0][0] == {"VIADDMNMX": 32, "SHFL": 7, "BRA": 1}
    monkeypatch.setattr(roofline, "library_sass", lambda path=None: None)
    assert roofline.dp_row_probe_sass() is None


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

"""K1's accumulators (``acc="int"|"i16"|"f32"``) in the port against the
JAX package's, on the CPU.

* The plain versions (``align/scan.py``) with ``acc="i16"`` and
  ``"f32"`` against ``sw_scores_pallas_grouped(acc=...)`` in interpret
  mode, in the four modes, on ragged and zero lengths and an odd batch.
* Both packages refuse an int16 request whose bound does not fit
  (``i16_admissible``, ``pallas_sw.py:698-701``), and
  ``make_grouped_sharded`` passes the accumulator on and refuses what the
  JAX factory refuses.
* The int16 pair kernel (``csrc/sw_pair16.cuh``) runs only on a card, so
  its packed arithmetic and schedule are transcribed here (two targets a
  register in 16-bit halves with int16 wraparound, the PRMT score
  selector, the wavefront's shuffles, passes, the scratch between them,
  the code-32 column past a half's length and each half's captures, at
  small thread and row counts) and held to serial Gotoh.

Tolerance: exact int32 equality (every value is an integer)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sift4g_tpu.align.pallas_sw import sw_scores_pallas_grouped  # noqa: E402
from sift4g_tpu.align.xla import _extend_matrix  # noqa: E402
from sift4g_tpu.core.scorers import create_scorer as jax_create_scorer  # noqa: E402
from sift4g_tpu.parallel import sharded as jsharded  # noqa: E402
from sift4g_tpu_torch.align import scan, sw_grouped  # noqa: E402
from sift4g_tpu_torch.parallel import sharded  # noqa: E402

torch.set_num_threads(1)

MODES = ["SW", "NW", "HW", "OV"]
SCORER = jax_create_scorer("BLOSUM_62", 10, 1)
M32 = _extend_matrix(SCORER.matrix)
MAX_SUB = int(SCORER.matrix.max())
CPU = torch.device("cpu")


def _grouped(seed, G=3, B=9, N=128, qlens=(51, 0, 64), m_pad=64):
    """Queries of ``qlens`` (one empty), B ragged targets a group with a
    zero-length and a full row, int8 garbage past every length."""
    rng = np.random.default_rng(seed)
    qlens = np.asarray(qlens, np.int32)
    q = np.full(G * m_pad, scan.PAD_CODE, np.int32)
    offs = (np.arange(G) * m_pad).astype(np.int32)
    for g in range(G):
        q[g * m_pad : g * m_pad + qlens[g]] = rng.integers(0, 26, qlens[g])
    t = rng.integers(-128, 128, (G, B, N)).astype(np.int8)
    lens = rng.integers(0, N + 1, (G, B)).astype(np.int32)
    lens[0, :2] = (0, N)
    lens[-1, -1] = 0
    for g in range(G):
        for b in range(B):
            t[g, b, : lens[g, b]] = rng.integers(0, 26, lens[g, b])
    return q, offs, qlens, t, lens


@pytest.mark.parametrize("mode", MODES)
def test_plain_accumulators_match_pallas_interpret(mode):
    """The plain ``"i16"`` and ``"f32"`` forms equal the Pallas kernel's
    same forms in interpret mode, and both equal ``"int"``."""
    q, offs, qlens, t, lens = _grouped(5)
    kw = dict(mode=mode, max_qlen=64, max_sub=MAX_SUB)
    targs = [torch.from_numpy(a) for a in (q, offs, qlens, t, lens)] + [torch.from_numpy(M32)]
    with pltpu.force_tpu_interpret_mode():
        want = {acc: np.asarray(sw_scores_pallas_grouped(q, offs, qlens, t, lens, M32,
                                                         acc=acc, **kw))
                for acc in ("i16", "f32")}
    got_int = scan.align_scores_grouped(*targs, **kw).numpy()
    for acc in ("i16", "f32"):
        got = scan.align_scores_grouped(*targs, acc=acc, **kw)
        assert got.dtype == torch.int32 and got.shape == lens.shape
        np.testing.assert_array_equal(got.numpy(), want[acc], err_msg=acc)
        np.testing.assert_array_equal(got.numpy(), got_int, err_msg=acc)
        # the wrapper on CPU tensors is the plain version, and counts no launch
        sw_grouped.reset_counters()
        wrapped = sw_grouped.sw_scores_grouped(*targs, acc=acc, **kw)
        assert torch.equal(wrapped, got)
        assert (sw_grouped.kernel_launches, sw_grouped.i16_launches,
                sw_grouped.f32_launches) == (0, 0, 0)


# (max_qlen, max_sub, gap_open, gap_extend, N): refused under "i16"
REFUSED = {
    "no-qlen-bound": (0, 11, 10, 1, 128),
    "no-sub-bound": (64, 0, 10, 1, 128),
    # 700 x 11 + 10 + (N + 1) x 1 reaches 8000 at N = 289
    "at-8000": (700, 11, 10, 1, 289),
    "wide-rung": (384, 11, 10, 1, 4096),
    "big-gaps": (64, 11, 100, 60, 128),
}


@pytest.mark.parametrize("case", REFUSED.values(), ids=REFUSED.keys())
def test_both_packages_refuse_an_inadmissible_int16_bound(case):
    max_qlen, max_sub, go, ge, N = case
    assert not scan.i16_admissible(max_qlen, max_sub, go, ge, N)
    q, offs, qlens, _, _ = _grouped(1)
    t = np.zeros((3, 2, N), np.int8)
    lens = np.full((3, 2), 1, np.int32)
    kw = dict(gap_open=go, gap_extend=ge, max_qlen=max_qlen, max_sub=max_sub, acc="i16")
    with pytest.raises(AssertionError, match="int16"):
        sw_scores_pallas_grouped(q, offs, qlens, t, lens, M32, **kw)
    targs = [torch.from_numpy(a) for a in (q, offs, qlens, t, lens, M32)]
    for fn in (scan.align_scores_grouped, sw_grouped.sw_scores_grouped):
        with pytest.raises(ValueError, match="int16"):
            fn(*targs, **kw)
    # one under the limit is admitted
    assert scan.i16_admissible(700, 11, 10, 1, 288)


def test_port_refuses_an_unknown_accumulator():
    """The JAX wrapper takes any other name as "int"; the port refuses it."""
    q, offs, qlens, t, lens = _grouped(1)
    targs = [torch.from_numpy(a) for a in (q, offs, qlens, t, lens, M32)]
    for fn in (scan.align_scores_grouped, sw_grouped.sw_scores_grouped):
        with pytest.raises(ValueError, match="unknown accumulator"):
            fn(*targs, acc="i8")
    with pytest.raises(ValueError, match="unknown accumulator"):
        sharded.make_grouped_sharded([CPU], acc="i8")


@pytest.fixture
def eight(monkeypatch):
    monkeypatch.setattr(sharded, "local_devices", lambda: [CPU] * 8)
    return [CPU] * 8


@pytest.mark.parametrize("acc", ["i16", "f32"])
def test_grouped_sharded_passes_the_accumulator_on(acc, eight, monkeypatch):
    """``make_grouped_sharded(acc=...)`` against the JAX factory's Pallas
    kernel in interpret mode, one group a device; every shard's scorer
    gets the accumulator and its bounds."""
    q, offs, qlens, t, lens = _grouped(3, G=8, B=5, qlens=(51, 0, 64, 17, 1, 33, 60, 9))
    kw = dict(mode="OV", max_qlen=64, max_sub=MAX_SUB, acc=acc)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jsharded.make_grouped_sharded(jsharded.make_mesh(8), **kw)(
            q, offs, qlens, t, lens, M32))
    seen = []
    real = scan.align_scores_grouped

    def spy(*args, **skw):
        seen.append((skw["acc"], skw["max_qlen"], skw["max_sub"]))
        return real(*args, **skw)

    monkeypatch.setattr(scan, "align_scores_grouped", spy)
    got = sharded.make_grouped_sharded(eight, **kw)(q, offs, qlens, t, lens, M32)
    np.testing.assert_array_equal(sharded.to_host(got).numpy(), want)
    assert seen == [(acc, 64, MAX_SUB)] * 8


def test_grouped_sharded_refuses_what_the_jax_factory_refuses(eight):
    """An int16 bound that the slab's width breaks: the JAX factory's call
    asserts; the port's call raises before any shard is placed.  A bound
    that can never hold is refused when the port's factory is built."""
    q, offs, qlens, t, lens = _grouped(3, G=8, B=4, N=128, qlens=(9,) * 8)
    # 720 x 11 + 10 + 129 x 1 = 8059: over the limit at N = 128
    kw = dict(max_qlen=720, max_sub=MAX_SUB, acc="i16")
    jfn = jsharded.make_grouped_sharded(jsharded.make_mesh(8), **kw)
    with pltpu.force_tpu_interpret_mode(), pytest.raises(AssertionError, match="int16"):
        jfn(q, offs, qlens, t, lens, M32)
    fn = sharded.make_grouped_sharded(eight, **kw)
    with pytest.raises(ValueError, match="int16"):
        fn(q, offs, qlens, t, lens, M32)
    for bad in (dict(), dict(max_qlen=64), dict(max_qlen=800, max_sub=MAX_SUB)):
        with pytest.raises(ValueError, match="int16"):
            sharded.make_grouped_sharded(eight, acc="i16", **bad)


# ------------------------------------------------ the s16x2 pair kernel, transcribed

NEG = scan.NEG
NEG16 = scan.NEG16
PAD = 32  # kPadCode: the profile row of -128s


def _half(x, k):
    v = (x >> (16 * k)) & 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _pack(lo, hi):
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def _vsub2(a, b):
    return _pack(_half(a, 0) - _half(b, 0), _half(a, 1) - _half(b, 1))


def _vmaxs2(a, b):
    return _pack(max(_half(a, 0), _half(b, 0)), max(_half(a, 1), _half(b, 1)))


def _viaddmax(a, b, c, relu=False):
    """__viaddmax_s16x2(_relu): max(a + b, c[, 0]) a half, the add wrapping
    (the CUDA header's own form is __vmaxs2(__vadd2(a, b), c))."""
    s = _pack(_half(a, 0) + _half(b, 0), _half(a, 1) + _half(b, 1))
    lo, hi = max(_half(s, 0), _half(c, 0)), max(_half(s, 1), _half(c, 1))
    return _pack(max(lo, 0), max(hi, 0)) if relu else _pack(lo, hi)


def _vimax3(a, b, c):
    return _vmaxs2(_vmaxs2(a, b), c)


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode): bytes 0-3 of a, 4-7 of b; a selector
    nibble with its top bit set replicates the sign of the byte it names."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for i in range(4):
        n = (sel >> (4 * i)) & 0xF
        byte = src[n & 7]
        if n & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << (8 * i)
    return out


def _sext_pair(a, b, k):
    """sext_pair<k> of csrc/sw_pair16.cuh, with its selector."""
    return _prmt(a, b, k | ((8 | k) << 4) | ((4 + k) << 8) | ((12 + k) << 12))


def _pair16_model(q, qlen, targets, lens, m32, mode, go, ge, T, R):
    """The scores of one thread group of sw_pair16_kernel: the pair
    (targets[0], targets[1]) (``lens[1]`` None: the pair's second target
    lies past B), with T threads of R rows each (the kernel's R is 16)."""
    free_top, free_left = mode != "NW", mode in ("SW", "OV")
    row_max = mode in ("HW", "OV")
    len0, len1 = lens[0], (lens[1] or 0)
    plen = max(len0, len1)
    TR = T * R
    npass = -(-qlen // TR)
    prof_rows = npass * TR
    # prof[c][row]: the int8 profile by query row (the kernel keeps a
    # window of it in shared memory), -128 past the query and for code 32
    prof = np.full((PAD + 1, max(prof_rows, 1)), -128, np.int64)
    for r in range(min(qlen, prof_rows)):
        prof[:32, r] = np.clip(m32[q[r] & 31, :32], -128, 127)
    go2, nge2, neg2 = _pack(go, go), _pack(-ge, -ge), _pack(NEG16, NEG16)
    scratch = {}
    best, cb, fin = 0, [NEG, NEG], [NEG, NEG]
    for p in range(npass):
        first, last = p == 0, p == npass - 1
        qi0 = [p * TR + t * R for t in range(T)]
        H, E, M = [], [], []
        hd, hl, fl, cl = [], [0] * T, [neg2] * T, [0] * T
        for t in range(T):
            hs = [0 if free_left else -(go + (qi0[t] + r) * ge) for r in range(R)]
            H.append([_pack(h, h) for h in hs])
            E.append([_pack(h - go, h - go) for h in hs])
            M.append([neg2] * R)
            h = 0 if (free_left or qi0[t] == 0) else -(go + (qi0[t] - 1) * ge)
            hd.append(_pack(h, h))
        for s in range(plen + T - 1 if plen else 0):
            prev = (list(hl), list(fl), list(cl))       # what __shfl_up_sync reads
            for t in range(T):
                j = s - t
                if t > 0:
                    hu, fu, c = prev[0][t - 1], prev[1][t - 1], prev[2][t - 1]
                else:
                    c0 = int(targets[0][j]) & 31 if j < len0 else PAD
                    c1 = int(targets[1][j]) & 31 if j < len1 else PAD
                    c = c0 | (c1 << 8)
                    if first:
                        h = 0 if free_top else -(go + j * ge)
                        hu, fu = _pack(h, h), neg2
                    else:
                        hu, fu = scratch.get(j, (0, neg2))
                if not (0 <= j < plen):
                    continue
                rows = slice(qi0[t], qi0[t] + R)
                col = [prof[c & 0xFF, rows], prof[c >> 8, rows]]
                words = [[sum((int(v[4 * w + i]) & 0xFF) << (8 * i) for i in range(4))
                          for w in range(R // 4)] for v in col]
                keep = (0xFFFF if j < len0 else 0) | (0xFFFF0000 if j < len1 else 0)
                up, f, dg, h_even = hu, fu, hd[t], 0
                for r in range(R):
                    sc = _sext_pair(words[0][r >> 2], words[1][r >> 2], r & 3)
                    f = _viaddmax(f, nge2, _vsub2(up, go2))
                    gg = _viaddmax(dg, sc, f, relu=mode == "SW")
                    h = _vmaxs2(gg, E[t][r])
                    E[t][r] = _viaddmax(E[t][r], nge2, _vsub2(gg, go2))
                    dg, H[t][r], up = H[t][r], h, h
                    if mode == "SW":
                        if r & 1:
                            best = _vimax3(best, h_even, h)
                        else:
                            h_even = h
                    if row_max:
                        M[t][r] = _vmaxs2(M[t][r], (h & keep) | (neg2 & ~keep & 0xFFFFFFFF))
                hd[t], hl[t], fl[t], cl[t] = hu, up, f, c
                if not last and t == T - 1:
                    scratch[j] = (up, f)
                for r in range(R):
                    for k, ln in enumerate((len0, len1)):
                        if j != ln - 1:
                            continue
                        if mode == "NW" and last and qi0[t] + r == qlen - 1:
                            fin[k] = _half(H[t][r], k)
                        if mode == "OV" and qi0[t] + r < qlen:
                            cb[k] = max(cb[k], _half(H[t][r], k))
        if row_max and last:
            for t in range(T):
                for r in range(R):
                    if qi0[t] + r == qlen - 1:
                        fin = [_half(M[t][r], 0), _half(M[t][r], 1)]
    if qlen == 0:
        fin = [-(go + (ln - 1) * ge) if mode == "NW" else 0 for ln in (len0, len1)]
    out = []
    for k, ln in enumerate((len0, len1)):
        if mode == "SW":
            out.append(_half(best, k))
        elif mode in ("NW", "HW"):
            out.append(fin[k] if ln > 0 else NEG)
        else:
            out.append(max(fin[k] if ln > 0 else NEG, cb[k], 0))
    return out[0], (out[1] if lens[1] is not None else None)


def _gotoh(q, t, m32, mode, go, ge):
    """Serial Gotoh, cell by cell, with the kernels' edge conventions (the
    matrix clamped to int8; an empty target scores NEG under NW/HW)."""
    m, n = len(q), len(t)
    if n == 0:
        return NEG if mode in ("NW", "HW") else 0
    free_top, free_left = mode != "NW", mode in ("SW", "OV")
    H = [[0] * (n + 1) for _ in range(m + 1)]
    for j in range(1, n + 1):
        H[0][j] = 0 if free_top else -(go + (j - 1) * ge)
    F = [NEG] * (n + 1)
    best = 0
    last_col = []
    for i in range(1, m + 1):
        H[i][0] = 0 if free_left else -(go + (i - 1) * ge)
        e = H[i][0] - go
        for j in range(1, n + 1):
            s = int(np.clip(m32[q[i - 1]][t[j - 1]], -128, 127))
            F[j] = max(H[i - 1][j] - go, F[j] - ge)
            g = max(H[i - 1][j - 1] + s, F[j])
            if mode == "SW":
                g = max(g, 0)
            H[i][j] = max(g, e)
            e = max(e - ge, g - go)
            best = max(best, H[i][j])
        last_col.append(H[i][n])
    if mode == "SW":
        return best
    if mode == "NW":
        return H[m][n]
    row = max(H[m][1:])
    return row if mode == "HW" else max(row, max(last_col, default=NEG), 0)


# (T, R, qlen, len0, len1 or None, N, gaps): one pass, several passes, a
# query of one row, an empty query, pairs of unequal lengths including 0
# and N, an empty partner, and gaps 11/2
PAIR_CASES = [
    (1, 4, 9, 7, 12, 16, (10, 1)),
    (2, 4, 19, 16, 3, 16, (10, 1)),
    (4, 4, 33, 0, 16, 16, (11, 2)),
    (2, 8, 16, 16, 0, 16, (10, 1)),
    (4, 4, 1, 5, 9, 16, (10, 1)),
    (2, 4, 0, 9, 4, 16, (10, 1)),
    (4, 4, 40, 13, None, 16, (11, 2)),
    (1, 4, 12, 16, 16, 16, (3, 3)),
    # the kernel's 16 rows a thread: two passes of 32 rows, lengths 17 and 48
    (2, 16, 40, 17, 48, 48, (10, 1)),
    (1, 16, 16, 48, 1, 48, (11, 2)),
    # a gap open above 128 and scores over the whole int8 range: a half
    # past its length could pass its own row maximum without the mask,
    # since H(i - 1, len - 1) - 128 may beat H(i, len - 1) >= H(i - 1,
    # len - 1) - go
    (2, 4, 12, 3, 16, 16, (300, 1)),
    (1, 4, 7, 16, 2, 16, (300, 1)),
    (4, 4, 20, 9, 12, 16, (200, 3)),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", PAIR_CASES, ids=[f"T{c[0]}R{c[1]}m{c[2]}-{c[3]}-{c[4]}"
                                                  for c in PAIR_CASES])
def test_pair16_transcription_matches_serial_gotoh(mode, case):
    T, R, qlen, len0, len1, N, (go, ge) = case
    rng = np.random.default_rng(PAIR_CASES.index(case))
    m = rng.integers(-128, 128, (26, 26)) if go > 128 else rng.integers(-4, 12, (26, 26))
    m32 = np.full((32, 32), NEG, np.int64)
    m32[:26, :26] = np.triu(m) + np.triu(m, 1).T
    q = rng.integers(0, 26, max(qlen, 1))
    # garbage past every length: codes whose low five bits score high
    targets = rng.integers(-128, 128, (2, N)).astype(np.int8)
    for k, ln in enumerate((len0, len1 or 0)):
        targets[k, :ln] = rng.integers(0, 26, ln)
    got = _pair16_model(q, qlen, targets, (len0, len1), m32, mode, go, ge, T, R)
    for k, ln in enumerate((len0, len1)):
        if ln is None:
            assert got[k] is None
            continue
        want = _gotoh(q[:qlen], targets[k, :ln].astype(np.int64), m32, mode, go, ge)
        assert got[k] == want, (k, got, want)
        # the plain int32 version agrees on the same target
        plain = scan.align_scores_grouped(
            torch.from_numpy(q.astype(np.int32)), torch.zeros(1, dtype=torch.int32),
            torch.tensor([qlen], dtype=torch.int32), torch.from_numpy(targets[k][None, None]),
            torch.tensor([[ln]], dtype=torch.int32), torch.from_numpy(m32.astype(np.int32)),
            mode=mode, gap_open=go, gap_extend=ge)
        assert int(plain) == want


@pytest.mark.parametrize("mode", ["HW", "OV"])
def test_pair16_transcription_masks_each_half_past_its_length(mode):
    """Short queries and targets, scores over the whole int8 range and a
    gap open of 300: a half's cells past its length often pass its own
    last row's maximum here (H(i - 1, len - 1) - 128 beats every real
    cell of row i), so the row maximum must take each half's own columns
    only."""
    for seed in range(60):
        rng = np.random.default_rng(seed)
        m = rng.integers(-128, 128, (26, 26))
        m32 = np.full((32, 32), NEG, np.int64)
        m32[:26, :26] = np.triu(m) + np.triu(m, 1).T
        qlen = int(rng.integers(1, 5))
        q = rng.integers(0, 26, qlen)
        lens = (int(rng.integers(1, 6)), int(rng.integers(1, 6)))
        targets = rng.integers(0, 26, (2, 8)).astype(np.int8)
        got = _pair16_model(q, qlen, targets, lens, m32, mode, 300, 1, 1, 4)
        for k in range(2):
            want = _gotoh(q, targets[k, : lens[k]].astype(np.int64), m32, mode, 300, 1)
            assert got[k] == want, (seed, k, got, want)


def test_pair16_selector_packs_two_sign_extended_bytes():
    """The PRMT selector of sext_pair: byte k of each word, sign-extended
    into its 16-bit half."""
    a, b = 0x807F01FF, 0x00FE7F80
    for k in range(4):
        lo = np.int8(np.uint8((a >> (8 * k)) & 0xFF))
        hi = np.int8(np.uint8((b >> (8 * k)) & 0xFF))
        got = _sext_pair(a, b, k)
        assert (_half(got, 0), _half(got, 1)) == (int(lo), int(hi))

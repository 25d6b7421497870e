// Striped SIMD Smith-Waterman (Farrar 2007), AVX2 int16 lanes.
//
// Score-only local alignment for the native CPU deployment path: the
// scalar rolling-row DP (aligner.cpp score_one) runs ~1 GCUPS on this
// host; the striped kernel processes 16 query cells per instruction.
// Exactness: integer max/add DP is order-independent, so the striped
// evaluation computes the SAME maximum-scoring local path cost as the
// scalar recurrence (gap of length L costs open + (L-1)*extend, match
// costs from the 26x26 matrix) — property-fuzzed against score_one /
// the NumPy oracle in tests/test_native_aligner.py.  The int16
// representation is exact while every H stays below the overflow guard:
// the score path gates on the bound min(m, n) * max|sub| before the
// fill, the traceback (aligner.cpp) on the fill's own best after it, and
// both fall back to the scalar path otherwise (and for NW/HW/OV modes).
//
// State lives in plain int16_t vectors accessed with unaligned
// loads/stores (std::vector<__m256i> silently drops the 32-byte
// alignment attribute in template instantiation).
//
// Mirrors the role of swsharp's vectorized CPU scoring kernels behind
// alignDatabase (reference database_alignment.cpp:83-86).

#include <algorithm>
#include <cstdint>
#include <vector>

#include "sw_simd.h"

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define SIFT4G_X86 1
#endif

namespace sift4g_simd {

#ifdef SIFT4G_X86

// shift a 256-bit register left by one int16 element (lane 0 <- 0)
__attribute__((target("avx2"))) static inline __m256i
shl1_epi16(__m256i a) {
  // [a_hi, a_lo] -> [a_lo, 0]; per-128 alignr stitches the carry lane
  __m256i lo_to_hi = _mm256_permute2x128_si256(a, a, 0x08);
  return _mm256_alignr_epi8(a, lo_to_hi, 14);
}

// striped query profile: vector element k of segment s = matrix score of
// query position k*seg_len + s against the profile's amino acid; pad
// positions get a large negative score (their lanes can never raise the
// local max: any positive value they carry is a real cell's value minus
// at least one gap penalty)
__attribute__((target("avx2"))) void build_profile16(
    const uint8_t* q, int m, const int32_t* mat, Profile16* p) {
  const int seg_len = (m + 15) / 16;
  p->m = m;
  p->seg_len = seg_len;
  p->data.assign(static_cast<size_t>(26) * seg_len * 16, 0);
  for (int c = 0; c < 26; ++c) {
    int16_t* pc = p->data.data() + static_cast<size_t>(c) * seg_len * 16;
    for (int s = 0; s < seg_len; ++s) {
      for (int k = 0; k < 16; ++k) {
        int pos = k * seg_len + s;
        pc[s * 16 + k] =
            pos < m ? static_cast<int16_t>(
                          mat[static_cast<size_t>(q[pos]) * 26 + c])
                    : static_cast<int16_t>(-30000);
      }
    }
  }
}

__attribute__((target("avx2"))) int32_t sw_striped16(
    const Profile16& prof, const uint8_t* t, int n, int go, int ge,
    Striped16Buffers* buf) {
  const int seg_len = prof.seg_len;
  const size_t row = static_cast<size_t>(seg_len) * 16;
  buf->h_a.assign(row, 0);
  buf->h_b.assign(row, 0);
  buf->e.assign(row, 0);
  int16_t* pvHLoad = buf->h_a.data();
  int16_t* pvHStore = buf->h_b.data();
  int16_t* pvE = buf->e.data();
  const __m256i vGapO = _mm256_set1_epi16(static_cast<int16_t>(go));
  const __m256i vGapE = _mm256_set1_epi16(static_cast<int16_t>(ge));
  const __m256i vZero = _mm256_setzero_si256();
  __m256i vMax = vZero;

#define LD(p, i) _mm256_loadu_si256(reinterpret_cast<const __m256i*>((p) + (i) * 16))
#define ST(p, i, v) _mm256_storeu_si256(reinterpret_cast<__m256i*>((p) + (i) * 16), (v))

  for (int j = 0; j < n; ++j) {
    const int16_t* vP = prof.data.data() + static_cast<size_t>(t[j]) * row;
    __m256i vF = vZero;
    // H(-1, previous column) enters lane 0 via the element shift
    __m256i vH = shl1_epi16(LD(pvHStore, seg_len - 1));
    std::swap(pvHLoad, pvHStore);
    for (int i = 0; i < seg_len; ++i) {
      vH = _mm256_adds_epi16(vH, LD(vP, i));   // diag + substitution
      __m256i vE = LD(pvE, i);
      vH = _mm256_max_epi16(vH, vE);
      vH = _mm256_max_epi16(vH, vF);
      vH = _mm256_max_epi16(vH, vZero);        // local clamp
      vMax = _mm256_max_epi16(vMax, vH);
      ST(pvHStore, i, vH);
      const __m256i vHg = _mm256_subs_epi16(vH, vGapO);
      ST(pvE, i, _mm256_max_epi16(_mm256_subs_epi16(vE, vGapE), vHg));
      vF = _mm256_max_epi16(_mm256_subs_epi16(vF, vGapE), vHg);
      vH = LD(pvHLoad, i);                     // next diagonal
    }
    // lazy-F: propagate vertical gaps across segment boundaries until F
    // can no longer improve any H (Farrar 2007, fig. 3).  The canonical
    // formulation is unsigned (the wrap-inserted 0 lane acts as -inf);
    // in this signed variant a 0 lane is value-harmless (H >= 0) but
    // would spin forever against a negative H - go, so the continuation
    // additionally requires vF > 0 — lanes at or below zero can never
    // improve any clamped H, now or after further decay
    vF = shl1_epi16(vF);
    int i = 0;
    __m256i vTemp = _mm256_subs_epi16(LD(pvHStore, 0), vGapO);
    while (_mm256_movemask_epi8(_mm256_and_si256(
        _mm256_cmpgt_epi16(vF, vTemp), _mm256_cmpgt_epi16(vF, vZero)))) {
      __m256i vH2 = _mm256_max_epi16(LD(pvHStore, i), vF);
      ST(pvHStore, i, vH2);
      vMax = _mm256_max_epi16(vMax, vH2);
      vF = _mm256_subs_epi16(vF, vGapE);
      if (++i >= seg_len) {
        i = 0;
        vF = shl1_epi16(vF);
      }
      vTemp = _mm256_subs_epi16(LD(pvHStore, i), vGapO);
    }
  }
#undef LD
#undef ST
  int16_t out[16];
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(out), vMax);
  int32_t best = 0;
  for (int k = 0; k < 16; ++k) best = std::max<int32_t>(best, out[k]);
  return best;
}

// shift a 256-bit register left by 2^k int16 elements (k = 1, 2, 3;
// vacated lanes <- 0)
template <int k>
__attribute__((target("avx2"))) static inline __m256i shl_lanes_epi16(__m256i a) {
  __m256i lo_to_hi = _mm256_permute2x128_si256(a, a, 0x08);
  if constexpr (k == 3) return lo_to_hi;
  else return _mm256_alignr_epi8(a, lo_to_hi, 16 - (2 << k));
}

// Pass 3 of sw_striped16_trace on segment i: the final F+ and H (H stored)
// and the five tests of the cell's trace byte as int16 masks.
struct TraceTests {
  __m256i zero, diag, e, e_ext, f_ext;
};

__attribute__((target("avx2"), always_inline)) static inline TraceTests
trace_segment(int i, const int16_t* pvF, int16_t* pvHStore, const int16_t* pvHLoad,
              const int16_t* vP, const int16_t* pvEStore, const int16_t* pvELoad,
              __m256i vGapE, __m256i* vC, __m256i* vHd, __m256i* vFExt, __m256i* vCol) {
#define LD(p, i) _mm256_loadu_si256(reinterpret_cast<const __m256i*>((p) + (i) * 16))
  const __m256i vF = _mm256_max_epi16(LD(pvF, i), *vC);
  *vC = _mm256_subs_epi16(*vC, vGapE);
  const __m256i vH = _mm256_max_epi16(LD(pvHStore, i), vF);
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(pvHStore + i * 16), vH);
  *vCol = _mm256_max_epi16(*vCol, vH);
  const __m256i vD = _mm256_adds_epi16(*vHd, LD(vP, i));
  *vHd = LD(pvHLoad, i);
  const __m256i vE = LD(pvEStore, i);
  TraceTests t;
  t.zero = _mm256_cmpeq_epi16(vH, _mm256_setzero_si256());
  t.diag = _mm256_cmpeq_epi16(vH, vD);
  t.e = _mm256_cmpeq_epi16(vH, vE);
  t.e_ext = _mm256_cmpeq_epi16(vE, _mm256_subs_epi16(LD(pvELoad, i), vGapE));
  t.f_ext = _mm256_cmpeq_epi16(vF, *vFExt);
  *vFExt = _mm256_subs_epi16(vF, vGapE);
  return t;
#undef LD
}

// One bit of two segments' trace bytes, from their int16 masks.
__attribute__((target("avx2"), always_inline)) static inline __m256i
trace_bit(__m256i x, __m256i y, uint8_t v) {
  return _mm256_and_si256(_mm256_packs_epi16(x, y), _mm256_set1_epi8(static_cast<char>(v)));
}

// The trace bytes of two segments' tests (the same segment twice for one),
// as 32 bytes: a's 16 lanes, then b's.
__attribute__((target("avx2"), always_inline)) static inline __m256i
trace_bytes(const TraceTests& a, const TraceTests& b) {
  const __m256i bytes = _mm256_or_si256(
      _mm256_or_si256(trace_bit(a.zero, b.zero, kTraceZero),
                      trace_bit(a.diag, b.diag, kTraceDiag)),
      _mm256_or_si256(trace_bit(a.e, b.e, kTraceE),
                      _mm256_or_si256(trace_bit(a.e_ext, b.e_ext, kTraceEExt),
                                      trace_bit(a.f_ext, b.f_ext, kTraceFExt))));
  // packs interleaves the 128-bit halves: a0-7 b0-7 a8-15 b8-15
  return _mm256_permute4x64_epi64(bytes, 0xD8);
}

// The traceback engine's fill (aligner.cpp): the SW DP of sw_striped16,
// with each column in three passes that write its cells' trace bytes
// (sw_simd.h).  The bits test values of the int32 recurrence on the final
// H.  Since H = max(H0, F) with H0 = max(diag + s, E, 0), and H(i-1,j) - go
// is at most F(i-1,j) - ge where F gives H, F(i,j) = max(H0(i-1,j) - go,
// F(i-1,j) - ge): F is a scan of H0 down the column, which replaces lazy-F.
//
// 1. Down the segments: the exact E(i,j) = max(H(i,j-1) - go, E(i,j-1) -
//    ge), E(i,0) = -inf, from the previous column's final H; H0; and F+
//    within each lane's segments, F+ = max(F, 0) being the scan's clamped
//    form F+(i,j) = max(H0(i-1,j) - go, F+(i-1,j) - ge, 0), F+(0,j) = 0.
// 2. Across the lanes: what each lane's F+ carries into the next lane's
//    first row, decayed by seg_len * ge a lane, max-scanned over the 16
//    lanes in four shifts.
// 3. Down the segments again: the final F+ and H = max(H0, F+), the bytes,
//    and the column's max.
//
// The F-extension bit, F+(i,j) == F+(i-1,j) - ge, is the int32 test F(i,j)
// == F(i-1,j) - ge wherever F(i,j) > 0, and the walk asks it only there:
// an F run starts at a cell whose H = F is positive and climbs while F
// grows by ge.  Every other bit is the int32 test itself.  A boundary H
// (row or column 0) is 0.  The column's max is kept as it finishes; where
// it reaches the running best, the column's first row holding it decides
// the endpoint: the first max cell in row-major order, the smallest i and
// then the smallest j.
__attribute__((target("avx2"))) int32_t sw_striped16_trace(
    const Profile16& prof, const uint8_t* t, int n, int go, int ge,
    Striped16Buffers* buf, uint8_t* trace, int* end_i, int* end_j) {
  const int seg_len = prof.seg_len;
  const size_t row = static_cast<size_t>(seg_len) * 16;
  buf->h_a.assign(row, 0);
  buf->h_b.assign(row, 0);
  buf->e.assign(row, 0);
  buf->e_b.assign(row, INT16_MIN);
  buf->f.resize(row);
  int16_t* pvHLoad = buf->h_a.data();
  int16_t* pvHStore = buf->h_b.data();
  int16_t* pvELoad = buf->e.data();
  int16_t* pvEStore = buf->e_b.data();
  int16_t* pvF = buf->f.data();
  const __m256i vGapO = _mm256_set1_epi16(static_cast<int16_t>(go));
  const __m256i vGapE = _mm256_set1_epi16(static_cast<int16_t>(ge));
  const __m256i vZero = _mm256_setzero_si256();
  // a decay of d * ge; past int16 it takes any F+ to 0 or below, as 32767 does
  auto decay = [ge](int64_t d) {
    return static_cast<int16_t>(std::min<int64_t>(d * ge, INT16_MAX));
  };
  const __m256i vLane1 = _mm256_set1_epi16(decay(seg_len));
  const __m256i vLane2 = _mm256_set1_epi16(decay(2 * seg_len));
  const __m256i vLane4 = _mm256_set1_epi16(decay(4 * seg_len));
  const __m256i vLane8 = _mm256_set1_epi16(decay(8 * seg_len));
  const __m256i vLastRow = _mm256_set1_epi16(decay(seg_len - 1));
  // -inf into lane 0 after a shl1_epi16, which inserts 0 there
  const __m256i vLane0Neg = _mm256_setr_epi16(INT16_MIN, 0, 0, 0, 0, 0, 0, 0,
                                              0, 0, 0, 0, 0, 0, 0, 0);
  int32_t best = 0;
  int bi = 0, bj = 0;

#define LD(p, i) _mm256_loadu_si256(reinterpret_cast<const __m256i*>((p) + (i) * 16))
#define ST(p, i, v) _mm256_storeu_si256(reinterpret_cast<__m256i*>((p) + (i) * 16), (v))

  for (int j = 0; j < n; ++j) {
    const int16_t* vP = prof.data.data() + static_cast<size_t>(t[j]) * row;
    std::swap(pvHLoad, pvHStore);  // the previous column's final H
    std::swap(pvELoad, pvEStore);  // and its E

    // 1. E, H0 and F+ within the lanes (pvHStore holds H0 until pass 3)
    // H(-1, previous column) enters lane 0 via the element shift
    __m256i vHd = shl1_epi16(LD(pvHLoad, seg_len - 1));
    __m256i vF = vZero;
    for (int i = 0; i < seg_len; ++i) {
      const __m256i vHp = LD(pvHLoad, i);
      const __m256i vE = _mm256_max_epi16(_mm256_subs_epi16(LD(pvELoad, i), vGapE),
                                          _mm256_subs_epi16(vHp, vGapO));
      ST(pvEStore, i, vE);
      __m256i vH = _mm256_adds_epi16(vHd, LD(vP, i));  // diag + substitution
      vHd = vHp;                                        // next diagonal
      vH = _mm256_max_epi16(_mm256_max_epi16(vH, vE), vZero);  // local clamp
      ST(pvHStore, i, vH);
      ST(pvF, i, vF);
      vF = _mm256_max_epi16(_mm256_subs_epi16(vF, vGapE),
                            _mm256_subs_epu16(vH, vGapO));  // H0 - go, or 0
    }

    // 2. the F+ carried into each lane's first row: lane k - 1's, or what
    // lanes further up carried through it; lane 0's row 1 takes F+(0,j) = 0
    __m256i vC = shl1_epi16(vF);
    vC = _mm256_max_epi16(vC, _mm256_subs_epi16(shl1_epi16(vC), vLane1));
    vC = _mm256_max_epi16(vC, _mm256_subs_epi16(shl_lanes_epi16<1>(vC), vLane2));
    vC = _mm256_max_epi16(vC, _mm256_subs_epi16(shl_lanes_epi16<2>(vC), vLane4));
    vC = _mm256_max_epi16(vC, _mm256_subs_epi16(shl_lanes_epi16<3>(vC), vLane8));

    // 3. final F+ and H, the bytes and the column's max
    uint8_t* tr = trace + static_cast<size_t>(j) * row;
    // F+(i-1,j) - ge for segment 0: each lane's last row, one lane up; row
    // 1 tests against -inf
    const __m256i vFLast = _mm256_max_epi16(LD(pvF, seg_len - 1),
                                            _mm256_subs_epi16(vC, vLastRow));
    __m256i vFExt = _mm256_or_si256(shl1_epi16(_mm256_subs_epi16(vFLast, vGapE)), vLane0Neg);
    vHd = shl1_epi16(LD(pvHLoad, seg_len - 1));
    __m256i vCol = vZero;
    int i = 0;
    for (; i + 1 < seg_len; i += 2) {
      const TraceTests a = trace_segment(i, pvF, pvHStore, pvHLoad, vP, pvEStore, pvELoad,
                                         vGapE, &vC, &vHd, &vFExt, &vCol);
      const TraceTests b = trace_segment(i + 1, pvF, pvHStore, pvHLoad, vP, pvEStore, pvELoad,
                                         vGapE, &vC, &vHd, &vFExt, &vCol);
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(tr + static_cast<size_t>(i) * 16),
                          trace_bytes(a, b));
    }
    if (i < seg_len) {
      const TraceTests a = trace_segment(i, pvF, pvHStore, pvHLoad, vP, pvEStore, pvELoad,
                                         vGapE, &vC, &vHd, &vFExt, &vCol);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(tr + static_cast<size_t>(i) * 16),
                       _mm256_castsi256_si128(trace_bytes(a, a)));
    }

    // the endpoint: only a column whose max reaches the running best (and
    // is positive) is looked at again
    const __m256i vReach = _mm256_set1_epi16(static_cast<int16_t>(std::max(best, 1) - 1));
    if (_mm256_movemask_epi8(_mm256_cmpgt_epi16(vCol, vReach))) {
      __m128i c = _mm_max_epi16(_mm256_castsi256_si128(vCol),
                                _mm256_extracti128_si256(vCol, 1));
      c = _mm_max_epi16(c, _mm_srli_si128(c, 8));
      c = _mm_max_epi16(c, _mm_srli_si128(c, 4));
      c = _mm_max_epi16(c, _mm_srli_si128(c, 2));
      const int32_t cm = static_cast<int16_t>(_mm_extract_epi16(c, 0));
      // the first row holding it: the lowest lane that holds it anywhere,
      // then that lane's first segment
      const __m256i vCm = _mm256_set1_epi16(static_cast<int16_t>(cm));
      uint32_t lanes = 0;
      for (int s = 0; s < seg_len; ++s)
        lanes |= static_cast<uint32_t>(_mm256_movemask_epi8(_mm256_cmpeq_epi16(LD(pvHStore, s), vCm)));
      const int lane = __builtin_ctz(lanes) / 2;
      int s = 0;
      while (pvHStore[s * 16 + lane] != cm) ++s;
      const int p = lane * seg_len + s;
      if (cm > best) {
        best = cm;
        bi = 0;
      }
      if (p < prof.m && (bi == 0 || p + 1 < bi)) {
        bi = p + 1;
        bj = j + 1;
      }
    }
  }
#undef LD
#undef ST
  *end_i = bi;
  *end_j = bj;
  return best;
}

bool have_avx2() { return __builtin_cpu_supports("avx2"); }

#else  // !SIFT4G_X86

void build_profile16(const uint8_t*, int, const int32_t*, Profile16*) {}
int32_t sw_striped16(const Profile16&, const uint8_t*, int, int, int,
                     Striped16Buffers*) { return -1; }
int32_t sw_striped16_trace(const Profile16&, const uint8_t*, int, int, int,
                           Striped16Buffers*, uint8_t*, int*, int*) { return -1; }
bool have_avx2() { return false; }

#endif

}  // namespace sift4g_simd

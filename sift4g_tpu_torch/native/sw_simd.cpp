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
#include <cstring>
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

// Column-storing variant for the traceback engine (aligner.cpp): identical
// DP to sw_striped16, plus a memcpy of the finished (post-lazy-F, exact)
// striped H column into hcols.  Kept as a separate function so the
// score-only hot path pays no store.
__attribute__((target("avx2"))) int32_t sw_striped16_cols(
    const Profile16& prof, const uint8_t* t, int n, int go, int ge,
    Striped16Buffers* buf, int16_t* hcols) {
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
    __m256i vH = shl1_epi16(LD(pvHStore, seg_len - 1));
    std::swap(pvHLoad, pvHStore);
    for (int i = 0; i < seg_len; ++i) {
      vH = _mm256_adds_epi16(vH, LD(vP, i));
      __m256i vE = LD(pvE, i);
      vH = _mm256_max_epi16(vH, vE);
      vH = _mm256_max_epi16(vH, vF);
      vH = _mm256_max_epi16(vH, vZero);
      vMax = _mm256_max_epi16(vMax, vH);
      ST(pvHStore, i, vH);
      const __m256i vHg = _mm256_subs_epi16(vH, vGapO);
      ST(pvE, i, _mm256_max_epi16(_mm256_subs_epi16(vE, vGapE), vHg));
      vF = _mm256_max_epi16(_mm256_subs_epi16(vF, vGapE), vHg);
      vH = LD(pvHLoad, i);
    }
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
    memcpy(hcols + static_cast<size_t>(j) * row, pvHStore,
           row * sizeof(int16_t));
  }
#undef LD
#undef ST
  int16_t out[16];
  _mm256_storeu_si256(reinterpret_cast<__m256i*>(out), vMax);
  int32_t best = 0;
  for (int k = 0; k < 16; ++k) best = std::max<int32_t>(best, out[k]);
  return best;
}

bool have_avx2() { return __builtin_cpu_supports("avx2"); }

#else  // !SIFT4G_X86

void build_profile16(const uint8_t*, int, const int32_t*, Profile16*) {}
int32_t sw_striped16(const Profile16&, const uint8_t*, int, int, int,
                     Striped16Buffers*) { return -1; }
int32_t sw_striped16_cols(const Profile16&, const uint8_t*, int, int, int,
                          Striped16Buffers*, int16_t*) { return -1; }
bool have_avx2() { return false; }

#endif

}  // namespace sift4g_simd

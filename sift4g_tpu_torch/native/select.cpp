// Median-entropy alignment selection (reference select_alignments.cpp:183-242).
//
// Bit-exact float32 twin of sift/select.py alignments_select: entropy
// terms come from the PYTHON-BUILT xlogx table (f32(num/den * log2(num/den)))
// so no libm call can differ in the last ulp; the per-position sum adds the
// nonzero terms in amino-acid order with float (f32) rounding at every step
// (quirk Q9); the double constant kLog_2_20 is added in double then truncated
// to float; the median reproduces get_median's len-1 sort quirk (Q1) via
// nth_element over the first L-1 elements (selection is value-exact vs a
// full sort).  The scalar Python loop cost ~120 ms/query at missense scale
// (400 near-identical rows: the median never drops, every prefix is
// evaluated); this loop is ~1 ms.
//
// IMPORTANT: must NOT be compiled with -ffast-math (the Makefile does not).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// get_median (constants.hpp:77-86): sorts only a[0..len-2], then takes the
// middle by position.  nth_element over [0, len-1) yields the same values
// at the selected positions as the full sort.
float median_q1(float* a, int64_t len) {
    if (len <= 0) return 0.0f;
    if (len == 1) return a[0];
    if (len == 2) {
        // sort of a[:1] is a no-op; (f32 + f32) in f32, then /2.0 in
        // double, truncated to f32 (mirrors constants.get_median)
        return (float)(((double)(a[0] + a[1])) / 2.0);
    }
    int64_t k2 = len / 2;                 // < len-1 for len >= 3
    if ((len & 1) == 1) {
        std::nth_element(a, a + k2, a + len - 1);
        return a[k2];
    }
    int64_t k1 = k2 - 1;
    std::nth_element(a, a + k1, a + len - 1);
    float v1 = a[k1];
    std::nth_element(a + k1 + 1, a + k2, a + len - 1);
    float v2 = a[k2];
    return (float)(((double)(v1 + v2)) / 2.0);
}

}  // namespace

extern "C" {

// rows: (n, L) uint8 letter codes ('X' == 23 is the gap/flank marker).
// xlogx_t: (tab_size, tab_size) float32 DENOMINATOR-MAJOR transpose,
//        xlogx_t[den*tab_size + num] = f32(num/den * log2(num/den)),
//        rows/cols 0 zeroed; tab_size > n.  Denominator-major puts a
//        position's whole entropy sum (den = valid[j] fixed, num = the
//        small per-aa counts) inside one table row — the numerator-major
//        layout cost a tab_size-strided gather per nonzero aa.
// Returns the selected prefix length (quirk Q8 semantics: the first prefix
// whose median <= threshold, else n).  The caller handles the
// threshold >= kLog_2_20 early-out (returns 0 before calling).
//
// Per-position occupancy bitmasks make the inner loop iterate only the
// amino acids actually observed (homolog-heavy missense columns hold 1-4
// distinct letters, not 26); ascending-bit iteration preserves the
// reference's ascending-aa f32 accumulation order (quirk Q9), and
// skipping zero counts is exactly the reference's count>0 test.
int64_t sift4g_select(const uint8_t* rows, int64_t n, int64_t L,
                      const float* xlogx_t, int64_t tab_size,
                      float threshold, double log_2_20) {
    if (n <= 0 || L <= 0) return 0;
    std::vector<int16_t> counts((size_t)L * 26, 0);
    std::vector<int32_t> valid((size_t)L, 0);
    std::vector<uint32_t> occ((size_t)L, 0);
    std::vector<float> pf((size_t)L);
    for (int64_t p = 0; p < n; ++p) {
        const uint8_t* row = rows + p * L;
        for (int64_t j = 0; j < L; ++j) {
            uint8_t c = row[j];
            if (c != 23) {
                ++counts[(size_t)j * 26 + c];
                ++valid[j];
                occ[j] |= 1u << c;
            }
        }
        for (int64_t j = 0; j < L; ++j) {
            const int16_t* cj = &counts[(size_t)j * 26];
            const float* tv = xlogx_t + (size_t)valid[j] * tab_size;
            float s = 0.0f;
            uint32_t m = occ[j];
            while (m) {                          // ascending aa order (Q9)
                const int aa = __builtin_ctz(m);
                m &= m - 1;
                s = s + tv[cj[aa]];
            }
            pf[j] = (float)((double)s + log_2_20);
        }
        if (median_q1(pf.data(), L) <= threshold) return p + 1;
    }
    return n;
}

// Alignment-string extraction (reference aligmentStr replay,
// select_alignments.cpp:244-300, quirk Q6): one scalar pass over the
// concatenated move streams.  rows (n, L) arrives pre-filled with 'X'
// (23); MOVE_DIAG (0) copies the target letter, MOVE_LEFT (1) advances
// only the target cursor (target insertions emit nothing), MOVE_UP (2)
// advances only the query cursor (stays 'X').  The numpy twin in
// sift/select.py is memory-traffic-bound at missense scale (~10 ms per
// 400-record query on this host); this loop is ~0.3 ms.
// Returns -1 on success, else the index of the FIRST record whose move
// stream ran a MOVE_DIAG off the query/target bounds.  The numpy twin
// raises IndexError on such streams; the earlier native variant silently
// truncated the row instead — divergent failure behavior that masked
// upstream bugs (advisor r4).  Python raises on a non-negative return.
int64_t sift4g_extract_checked(const uint8_t* moves, const int64_t* moff,
                               const int64_t* qstart, const int64_t* tstart,
                               const uint8_t* tcodes, const int64_t* toff,
                               int64_t n, int64_t L, uint8_t* rows) {
    int64_t bad = -1;
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* mv = moves + moff[r];
        const int64_t mlen = moff[r + 1] - moff[r];
        const uint8_t* tc = tcodes + toff[r];
        const int64_t tn = toff[r + 1] - toff[r];
        uint8_t* row = rows + r * L;
        int64_t qi = qstart[r], ti = tstart[r];
        for (int64_t k = 0; k < mlen; ++k) {
            const uint8_t m = mv[k];
            if (m == 1) {           // MOVE_LEFT
                ++ti;
            } else if (m == 2) {    // MOVE_UP
                ++qi;
            } else {                // MOVE_DIAG
                if (qi >= L || ti < 0 || ti >= tn) {  // corrupt path
                    if (bad < 0) bad = r;
                    break;
                }
                row[qi] = tc[ti];
                ++qi;
                ++ti;
            }
        }
    }
    return bad;
}

// Legacy entry point (pre-checked ABI); kept so a stale caller binding
// still resolves.  New bindings use sift4g_extract_checked.
void sift4g_extract(const uint8_t* moves, const int64_t* moff,
                    const int64_t* qstart, const int64_t* tstart,
                    const uint8_t* tcodes, const int64_t* toff,
                    int64_t n, int64_t L, uint8_t* rows) {
    (void)sift4g_extract_checked(moves, moff, qstart, tstart, tcodes, toff,
                                 n, L, rows);
}

}  // extern "C"

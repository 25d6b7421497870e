// Median-seq-info matrix tree (reference addMedianSeqInfo,
// sift_scores.cpp:101-149: per flagged position, recompute counts ->
// Henikoff weights -> frequency-normalized percentage matrix over the
// position's X-free row subset).
//
// Bit-exact float64 twin of the numpy pipeline in sift/scores.py
// (create_matrix -> calc_seq_weights -> basic_matrix_construction): the
// subst-mode hybrid's host cost center runs one full O(26*n*L) pass per
// distinct keep mask (~10 ms in numpy at missense shape; ~0.6 ms here).
// The log/median tail (calculate_median_seq_info) stays in numpy — its
// np.log is a vectorized implementation that differs from libm in the
// last ulp (measured ~0.1% of inputs), so C++ must stop at the last
// pure-arithmetic value, the percentage matrix.
//
// Exactness ground rules (all verified empirically against numpy 2.x):
// * contiguous-axis reductions (sum over axis=1 / 1-D) use numpy's
//   PAIRWISE algorithm: <8 sequential; <=128 eight-way unrolled partials
//   combined ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)) then a sequential
//   remainder; else recursive halving with the split rounded down to a
//   multiple of 8;
// * outer-axis (axis=0) reductions accumulate SEQUENTIALLY row by row;
// * elementwise expression trees replicate numpy's operator order
//   (e.g. part_D * contrib / freq = (part_D*contrib)/freq);
// * adding a +0.0 term is skipped only where the accumulator cannot be
//   -0.0 (non-negative sums) — bitwise neutral.
//
// IMPORTANT: must NOT be compiled with -ffast-math (Makefile does not).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// numpy pairwise_sum over a contiguous double array (loops.c.src).
double pairwise_sum(const double* a, int64_t n) {
    if (n < 8) {
        double res = 0.0;
        for (int64_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r0 = a[0], r1 = a[1], r2 = a[2], r3 = a[3];
        double r4 = a[4], r5 = a[5], r6 = a[6], r7 = a[7];
        int64_t i = 8;
        for (; i + 8 <= n; i += 8) {
            r0 += a[i + 0]; r1 += a[i + 1]; r2 += a[i + 2]; r3 += a[i + 3];
            r4 += a[i + 4]; r5 += a[i + 5]; r6 += a[i + 6]; r7 += a[i + 7];
        }
        double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// counts -> ndiff -> Henikoff position-based weights for the given row
// subset (keep == nullptr means all rows).  Mirrors numpy
// create_matrix(sub, ones) + calc_seq_weights(sub, raw) exactly (see
// file header for the reduction-order rules).
void henikoff_weights(const uint8_t* rows, const int64_t* keep,
                      int64_t m, int64_t L, const uint8_t* valid,
                      int64_t* counts, double* ndiff, double* w,
                      uint32_t* present_out) {
    std::memset(counts, 0, sizeof(int64_t) * (size_t)L * 26);
    uint32_t present = 0;
    for (int64_t s = 0; s < m; ++s) {
        const uint8_t* row = rows + (keep ? keep[s] : s) * L;
        for (int64_t l = 0; l < L; ++l) {
            const uint8_t c = row[l];
            present |= 1u << c;
            if (valid[c]) ++counts[(size_t)l * 26 + c];
        }
    }
    for (int64_t l = 0; l < L; ++l) {
        int64_t k = 0;
        const int64_t* cl = &counts[(size_t)l * 26];
        for (int aa = 0; aa < 26; ++aa)
            if (cl[aa] > 0 && valid[aa]) ++k;
        ndiff[l] = (double)k;
    }
    std::vector<double> contrib((size_t)L);
    for (int64_t s = 0; s < m; ++s) {
        const uint8_t* row = rows + (keep ? keep[s] : s) * L;
        for (int64_t l = 0; l < L; ++l) {
            const uint8_t c = row[l];
            const int64_t cnt = counts[(size_t)l * 26 + c];
            contrib[l] = (valid[c] && cnt > 0)
                ? 1.0 / (ndiff[l] * (double)cnt)
                : 0.0;
        }
        w[s] = pairwise_sum(contrib.data(), L);
    }
    const double tot = pairwise_sum(w, m);
    if (tot != 0.0) {
        const double dm = (double)m;
        for (int64_t s = 0; s < m; ++s) w[s] = w[s] / tot * dm;
    }
    if (present_out) *present_out = present;
}

}  // namespace

extern "C" {

// Henikoff weights + ndiff for the FULL row set (sparse_exact_scores'
// prelude; bitwise-equal to numpy calc_seq_weights on the weight-1 raw
// count matrix).  Returns 0.
int64_t sift4g_seq_weights(const uint8_t* rows, int64_t n, int64_t L,
                           const uint8_t* valid,
                           double* out_w, double* out_ndiff) {
    std::vector<int64_t> counts((size_t)L * 26);
    henikoff_weights(rows, nullptr, n, L, valid, counts.data(), out_ndiff,
                     out_w, nullptr);
    return 0;
}

// rows: (n, L) uint8 letter codes (0..25); keep: (m,) ascending row
// indices of the X-free subset; aa_freq: (26,) background frequencies;
// valid: (26,) 0/1 valid-amino-acid mask; out: (L, 26) float64
// percentage matrix (may carry inf/nan exactly like the numpy result).
// Returns 0.
int64_t sift4g_basic_matrix(const uint8_t* rows, const int64_t* keep,
                            int64_t m, int64_t L,
                            const double* aa_freq, const uint8_t* valid,
                            double* out) {
    const int iD = 'D' - 'A', iN = 'N' - 'A', iE = 'E' - 'A';
    const int iQ = 'Q' - 'A', iB = 'B' - 'A', iZ = 'Z' - 'A';
    const int iX = 'X' - 'A';

    // counts -> ndiff -> Henikoff weights over the subset
    std::vector<int64_t> counts((size_t)L * 26);
    std::vector<double> ndiff((size_t)L);
    std::vector<double> w((size_t)m);
    uint32_t present = 0;
    henikoff_weights(rows, keep, m, L, valid, counts.data(), ndiff.data(),
                     w.data(), &present);

    // ---- basic_matrix_construction(sub, w)
    const double part_D = aa_freq[iD] / (aa_freq[iD] + aa_freq[iN]);
    const double part_N = aa_freq[iN] / (aa_freq[iD] + aa_freq[iN]);
    const double part_E = aa_freq[iE] / (aa_freq[iE] + aa_freq[iQ]);
    const double part_Q = aa_freq[iQ] / (aa_freq[iE] + aa_freq[iQ]);

    std::memset(out, 0, sizeof(double) * (size_t)L * 26);
    // Per-(column, letter) weighted counts in ONE pass.  numpy's
    // per-letter axis-0 reduction adds, for a fixed (l, aa), exactly the
    // w[s] of matching rows in ascending row order (non-matches
    // contribute +0.0 — bitwise neutral on a non-negative accumulator);
    // scattering row-by-row performs the identical add sequence per
    // (l, aa) bin, so acc26 is bit-identical at 1/26th the work.
    std::vector<double> acc26((size_t)L * 32, 0.0);
    for (int64_t s = 0; s < m; ++s) {
        const uint8_t* row = rows + keep[s] * L;
        const double ws = w[s];
        for (int64_t l = 0; l < L; ++l)
            acc26[(size_t)l * 32 + row[l]] += ws;
    }
    // Apply letters in ascending-aa order (numpy's loop order — the +=
    // sequence into shared D/N/E/Q columns is order-sensitive).
    for (int aa = 0; aa < 26; ++aa) {
        if (!(present & (1u << aa))) continue;
        const double* acc = acc26.data() + aa;
        if (aa == iB) {
            for (int64_t l = 0; l < L; ++l) {
                const double a = acc[l * 32];
                out[l * 26 + iD] += part_D * a / aa_freq[iD];
                out[l * 26 + iN] += part_N * a / aa_freq[iN];
            }
        } else if (aa == iZ) {
            for (int64_t l = 0; l < L; ++l) {
                const double a = acc[l * 32];
                out[l * 26 + iE] += part_E * a / aa_freq[iE];
                out[l * 26 + iQ] += part_Q * a / aa_freq[iQ];
            }
        } else if (aa != iX && aa_freq[aa] != 0.0) {
            for (int64_t l = 0; l < L; ++l)
                out[l * 26 + aa] += acc[l * 32] / aa_freq[aa];
        }
    }
    for (int64_t l = 0; l < L; ++l) {
        double* rowp = out + l * 26;
        const double total = pairwise_sum(rowp, 26);
        for (int aa = 0; aa < 26; ++aa)
            rowp[aa] = rowp[aa] * 100.0 / total;
        rowp[iB] = rowp[iD] * part_D + rowp[iN] * part_N;
        rowp[iZ] = rowp[iE] * part_E + rowp[iQ] * part_Q;
    }
    return 0;
}

}  // extern "C"

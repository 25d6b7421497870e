// Striped SIMD Smith-Waterman (see sw_simd.cpp).
#pragma once

#include <cstdint>
#include <vector>

namespace sift4g_simd {

struct Profile16 {
  int m = 0;        // query length
  int seg_len = 0;
  std::vector<int16_t> data;  // 26 * seg_len * 16, unaligned loads
};

struct Striped16Buffers {
  std::vector<int16_t> h_a, h_b, e;
  std::vector<int16_t> e_b, f;  // sw_striped16_trace: E of two columns, F of one
};

// The bits of a cell's trace byte (sw_striped16_trace), each a test of
// the int32 recurrence on the final H, E and F of cell (i, j):
constexpr uint8_t kTraceZero = 1;   // H(i,j) == 0
constexpr uint8_t kTraceDiag = 2;   // H(i,j) == H(i-1,j-1) + s(q_i, t_j)
constexpr uint8_t kTraceE = 4;      // H(i,j) == E(i,j)
constexpr uint8_t kTraceEExt = 8;   // E(i,j) == E(i,j-1) - ge
constexpr uint8_t kTraceFExt = 16;  // F(i,j) == F(i-1,j) - ge, where F(i,j) > 0

void build_profile16(const uint8_t* q, int m, const int32_t* mat, Profile16* p);
int32_t sw_striped16(const Profile16& prof, const uint8_t* t, int n, int go,
                     int ge, Striped16Buffers* buf);
// Like sw_striped16, and writes each cell's trace byte into trace[j *
// seg_len * 16 + (p % seg_len) * 16 + p / seg_len] (query position p,
// target column j, both from 0).  *end_i, *end_j receive the first cell
// (1-based, row-major) holding the best score, or 0, 0 where no cell is
// positive.
int32_t sw_striped16_trace(const Profile16& prof, const uint8_t* t, int n,
                           int go, int ge, Striped16Buffers* buf,
                           uint8_t* trace, int* end_i, int* end_j);
bool have_avx2();

}  // namespace sift4g_simd

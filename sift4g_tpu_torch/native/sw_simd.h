// Striped SIMD Smith-Waterman (see sw_simd.cpp).
#pragma once

#include <cstdint>
#include <vector>

namespace sift4g_simd {

struct Profile16 {
  int seg_len = 0;
  std::vector<int16_t> data;  // 26 * seg_len * 16, unaligned loads
};

struct Striped16Buffers {
  std::vector<int16_t> h_a, h_b, e;
};

void build_profile16(const uint8_t* q, int m, const int32_t* mat, Profile16* p);
int32_t sw_striped16(const Profile16& prof, const uint8_t* t, int n, int go,
                     int ge, Striped16Buffers* buf);
// Like sw_striped16 but also stores each target column's final striped H
// vector (exact after lazy-F) into hcols[j * seg_len * 16 ...] — the
// traceback engine de-stripes on access: H(query pos p, col j) =
// hcols[j * row + (p % seg_len) * 16 + p / seg_len].
int32_t sw_striped16_cols(const Profile16& prof, const uint8_t* t, int n,
                          int go, int ge, Striped16Buffers* buf,
                          int16_t* hcols);
bool have_avx2();

}  // namespace sift4g_simd

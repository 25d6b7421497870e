// Grouped affine-gap alignment scores (SW / NW / HW / OV) for Hopper: the
// alignment modes and the row policies of the tiled kernel body
// (sw_tiled.cuh), which K1 (sw_grouped.cu, target slabs), K3
// (sw_grouped_resident.cu, the device-resident database) and K4
// (sw_single.cu, one query against int32 target rows) share.
//
// A row policy says where the codes of target row (g, b) live: row()
// gives the row (and may shorten its length to 0 when the row cannot be
// read safely), and load4(row, jc, len) gives the codes of columns jc ..
// jc + 3 (jc a multiple of 4, jc < len) as the 4 bytes of one word, column
// jc in the low byte.  The body takes the low five bits of each byte, as
// the Pallas kernels' 5-bit select trees do, so a code's value past them
// never matters.  `grouped` says whether the policy serves several
// queries (q_off read on the device) or one query at offset 0 (K4, whose
// caller passes no q_off); it is a compile-time property, because a null
// test of q_off cost K1 2.3 % of its rate on an H100.
//
// Contract (checked by the Python wrappers): a row's codes at j >= len may
// hold anything.  Lengths are clamped to [0, N] and query spans to the
// query buffer, for memory safety only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sift4g {

constexpr int kNeg = -(1 << 28);

enum Mode { SW = 0, NW = 1, HW = 2, OV = 3 };

// Rows of a (G, B, N) int8 slab: row (g, b) starts at (g * B + b) * N.
// A row starts 16-byte aligned (N % 16 == 0 on an aligned base) and is
// read as uint32 words up to its length rounded up to 16.
struct SlabRows {
  using Row = const uint4*;
  static constexpr bool grouped = true;
  const int8_t* targets;
  __device__ __forceinline__ Row row(size_t gb, int n, int& len) const {
    return reinterpret_cast<Row>(targets + gb * n);
  }
  __device__ __forceinline__ uint32_t load4(Row r, int jc, int len) const {
    return reinterpret_cast<const uint32_t*>(r)[jc >> 2];
  }
};

// Rows of the resident database: row (g, b) starts at the int64 byte
// offset starts[g * B + b] of db and is read as SlabRows reads a row.  A
// start that is misaligned, negative or whose 16-byte words would run past
// the tensor scores as an empty row (memory safety only; the wrapper
// refuses such starts).
struct ResidentRows {
  using Row = const uint4*;
  static constexpr bool grouped = true;
  const uint8_t* db;
  const int64_t* starts;
  int64_t db_len;
  __device__ __forceinline__ Row row(size_t gb, int n, int& len) const {
    const int64_t s = starts[gb];
    if (s < 0 || (s & 15) || s > db_len - (((int64_t)len + 15) & ~int64_t(15))) {
      len = 0;
      return reinterpret_cast<Row>(db);
    }
    return reinterpret_cast<Row>(db + s);
  }
  __device__ __forceinline__ uint32_t load4(Row r, int jc, int len) const {
    return reinterpret_cast<const uint32_t*>(r)[jc >> 2];
  }
};

// Rows of a (G, B, N) int32 tensor (K4, with G = 1): row (g, b) starts at
// (g * B + b) * N codes, with N any width, so a row may end anywhere and
// the tensor has nothing after its last row.  load4 never reads at or past
// the row's length: one 16-byte int4 load where the rows are 16-byte
// aligned (vec4: N % 4 == 0 on an aligned base) and all four codes lie
// inside the row, single int32 loads at a row's tail and everywhere else.
// Each code's low byte is packed into the word K1 would read.
struct Int32Rows {
  using Row = const int32_t*;
  static constexpr bool grouped = false;
  const int32_t* targets;
  bool vec4;
  __device__ __forceinline__ Row row(size_t gb, int n, int& len) const {
    return targets + gb * n;
  }
  __device__ __forceinline__ uint32_t load4(Row r, int jc, int len) const {
    int4 v = make_int4(0, 0, 0, 0);
    if (vec4 && jc + 4 <= len) {
      v = *reinterpret_cast<const int4*>(r + jc);
    } else {
      if (jc < len) v.x = r[jc];
      if (jc + 1 < len) v.y = r[jc + 1];
      if (jc + 2 < len) v.z = r[jc + 2];
      if (jc + 3 < len) v.w = r[jc + 3];
    }
    return uint32_t(v.x & 255) | (uint32_t(v.y & 255) << 8) |
           (uint32_t(v.z & 255) << 16) | (uint32_t(v.w & 255) << 24);
  }
};

}  // namespace sift4g

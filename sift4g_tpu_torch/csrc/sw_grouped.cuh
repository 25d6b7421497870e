// Grouped affine-gap alignment scores (SW / NW / HW / OV) for Hopper: the
// kernel body shared by K1 (sw_grouped.cu, target slabs) and K3
// (sw_grouped_resident.cu, the device-resident database).  The two differ
// only in where a row's bytes come from (the Rows policy below), so their
// arithmetic cannot drift apart.
//
// Group g scores the query q_all[q_off[g] : q_off[g] + q_len[g]] against
// its B targets; the result is (G, B) int32, bit-identical to the Pallas
// kernel sift4g_tpu/align/pallas_sw.py:_sw_grouped_kernel (and to the plain
// PyTorch version in sift4g_tpu_torch/align/scan.py).
//
// Design: one thread per (group, target row).  The query row is the outer
// loop and the target column the inner one; the horizontal gap E runs
// along the row in registers as plain serial Gotoh (E_j = max(E_{j-1} - ge,
// G_{j-1} - go), the exact serial form of the Pallas kernel's
// decayed-prefix max), and the diagonal is carried in a register.  H and F
// of the previous row live in a device-memory scratch of int2 laid out
// [g][j][b], so a warp's 32 threads touch 256 consecutive bytes.  The
// substitution matrix, clamped to int8 as the Pallas planes were, sits in
// shared memory.  Scratch grows with the target rung, never with the
// query length, so any query length fits.
//
// What bounds it on the card: each cell loads and stores its H/F pair,
// about 16 bytes of scratch traffic per cell unless L2 holds the scratch
// (it does not at production launch sizes), plus 1 byte of target code,
// so this design is bound by device-memory bandwidth: 17 B/cell at
// 3.35 TB/s is about 197 G cells/s.  Later work: register-tiled columns
// (several query rows per pass, so the scratch is touched once per tile),
// a query profile in shared memory, and the DPX intrinsics __viaddmax_s32
// and __vimax3_s32 for the max-plus updates.
//
// Contract (checked by the Python wrappers): a row's bytes start 16-byte
// aligned and are read in 16-byte words up to its length rounded up to 16;
// bytes at j >= len may hold anything and are never read as matrix
// indices.  Lengths are clamped to [0, N] and query spans to the query
// buffer, for memory safety only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sift4g {

constexpr int kNeg = -(1 << 28);
constexpr int kThreads = 128;

enum Mode { SW = 0, NW = 1, HW = 2, OV = 3 };

// Rows of a (G, B, N) int8 slab: row (g, b) starts at (g * B + b) * N.
struct SlabRows {
  const int8_t* targets;
  __device__ __forceinline__ const uint4* row(size_t gb, int n, int& len) const {
    return reinterpret_cast<const uint4*>(targets + gb * n);
  }
};

// Rows of the resident database: row (g, b) starts at the int64 byte
// offset starts[g * B + b] of db.  A start that is misaligned, negative or
// whose 16-byte words would run past the tensor scores as an empty row
// (memory safety only; the wrapper refuses such starts).
struct ResidentRows {
  const uint8_t* db;
  const int64_t* starts;
  int64_t db_len;
  __device__ __forceinline__ const uint4* row(size_t gb, int n, int& len) const {
    const int64_t s = starts[gb];
    if (s < 0 || (s & 15) || s > db_len - (((int64_t)len + 15) & ~int64_t(15))) {
      len = 0;
      return reinterpret_cast<const uint4*>(db);
    }
    return reinterpret_cast<const uint4*>(db + s);
  }
};

template <int MODE, class Rows>
__global__ void __launch_bounds__(kThreads) sw_grouped_kernel(
    const int32_t* __restrict__ q_all, int qm,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ q_len,
    Rows rows, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ matrix32, int B, int N, int go, int ge,
    int2* __restrict__ scratch, int32_t* __restrict__ out) {
  constexpr bool free_top = MODE != NW;
  constexpr bool free_left = MODE == SW || MODE == OV;

  __shared__ int32_t sm[32 * 32];
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x) {
    sm[k] = min(127, max(-128, matrix32[k]));
  }
  __syncthreads();

  const int g = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const size_t gb = (size_t)g * B + b;
  int len = min(max(lens[gb], 0), N);
  const uint4* t16 = rows.row(gb, N, len);
  const int off = min(max(q_off[g], 0), qm);
  const int qlen = min(max(q_len[g], 0), qm - off);
  const int32_t* q = q_all + off;
  int2* hf = scratch + (size_t)g * N * B + b;  // hf[j * B] = (H, F)

  // boundary row i = 0
  for (int j = 0; j < len; ++j) {
    hf[(size_t)j * B] = make_int2(free_top ? 0 : -(go + j * ge), kNeg);
  }

  int best = 0;        // SW: best cell, zero floor
  int col_best = kNeg; // OV: best of the last column over rows 1..qlen
  for (int i = 0; i < qlen; ++i) {
    const int32_t* srow = sm + 32 * (q[i] & 31);
    const int left0 = free_left ? 0 : -(go + i * ge);  // H[i+1, 0]
    int diag = (free_left || i == 0) ? 0 : -(go + (i - 1) * ge);  // H[i, 0]
    // E at column 1 is left0 - go; seed the recurrence so that
    // max(e - ge, g - go) yields exactly that
    int e = left0 - go + ge;
    int gprev = kNeg;
    int h = 0;
    for (int jc = 0; jc < len; jc += 16) {
      const uint4 w = t16[jc >> 4];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = jc + k;
        if (j < len) {
          const int tc = (words[k >> 2] >> (8 * (k & 3))) & 31;
          int2* cell = hf + (size_t)j * B;
          const int2 up = *cell;
          const int f = max(up.x - go, up.y - ge);
          int gg = max(diag + srow[tc], f);
          if (MODE == SW) gg = max(gg, 0);
          e = max(e - ge, gprev - go);
          h = max(gg, e);
          *cell = make_int2(h, f);
          diag = up.x;
          gprev = gg;
          if (MODE == SW) best = max(best, h);
        }
      }
    }
    if (MODE == OV && len > 0) col_best = max(col_best, h);
  }

  int result;
  if (MODE == SW) {
    result = best;
  } else if (MODE == NW) {
    result = len > 0 ? hf[(size_t)(len - 1) * B].x : kNeg;
  } else {
    int row_best = kNeg;
    for (int j = 0; j < len; ++j) row_best = max(row_best, hf[(size_t)j * B].x);
    result = MODE == HW ? row_best : max(max(row_best, col_best), 0);
  }
  out[gb] = result;
}

// Launches the kernel for `mode` on `stream`; neither synchronises nor
// allocates; returns cudaGetLastError() (0 on success).  scratch holds
// G * N * B int2.
template <class Rows>
int launch_sw_grouped(const int32_t* q_all, int qm, const int32_t* q_off,
                      const int32_t* q_len, Rows rows, const int32_t* lens,
                      const int32_t* matrix32, int G, int B, int N, int mode,
                      int go, int ge, void* scratch, int32_t* out,
                      void* stream) {
  if (G == 0 || B == 0) return 0;
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* scr = static_cast<int2*>(scratch);
#define SIFT4G_LAUNCH(M)                                                     \
  sw_grouped_kernel<M, Rows><<<grid, block, 0, s>>>(                         \
      q_all, qm, q_off, q_len, rows, lens, matrix32, B, N, go, ge, scr, out)
  switch (mode) {
    case SW: SIFT4G_LAUNCH(SW); break;
    case NW: SIFT4G_LAUNCH(NW); break;
    case HW: SIFT4G_LAUNCH(HW); break;
    case OV: SIFT4G_LAUNCH(OV); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIFT4G_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sift4g

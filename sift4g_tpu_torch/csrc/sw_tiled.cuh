// Grouped affine-gap alignment scores (SW / NW / HW / OV) for Hopper, tiled:
// the kernel body of K1 (sw_grouped.cu, target slabs), K3
// (sw_grouped_resident.cu, the device-resident database) and K4
// (sw_single.cu, one query against int32 target rows).  It takes its row
// policies (SlabRows, ResidentRows, Int32Rows) and Mode from sw_grouped.cuh.
//
// Group g scores the query q_all[q_off[g] : q_off[g] + q_len[g]] against
// its B targets (a policy that is not `grouped` has one query, at offset
// 0, and q_off is not read); the result is (G, B) int32, bit-identical to
// the Pallas kernels sift4g_tpu/align/pallas_sw.py:_sw_grouped_kernel and
// _sw_kernel (and to the plain PyTorch version in
// sift4g_tpu_torch/align/scan.py): the serial Gotoh recurrence, cell for
// cell,
//   F = max(H_up - go, F_up - ge)
//   G = max(diag + s, F)            (and 0 under SW)
//   E = max(E_left - ge, G_left - go)
//   H = max(G, E)
// with the matrix clamped to int8.
//
// Design.  A group of T threads of one warp (T = 1, 2, ..., 32, chosen by
// the host from the launch's shape) scores one (group, target) pair.  Each
// thread holds kRows consecutive query rows, their H and E in registers.
// The group sweeps the target's columns as a wavefront: at step s thread t
// works on column s - t, and receives from thread t - 1 (__shfl_up_sync
// of width T) the (H, F) of the row above its first row at that column and
// the column's target code; the diagonal of its first row is what it
// received the step before.  F runs down the thread's rows in registers.
// A query longer than T * kRows rows takes several passes: the group's
// last thread writes the (H, F) of its last row per column to the scratch
// ([g][j][b]: a warp's targets side by side), and the next pass's first thread
// reads it back.  The top boundary row and the left boundary column are
// computed, never stored.
//
// Scores come from a query profile in shared memory: prof[code][row], int8,
// built for kProfRows query rows at a time by the block (one block serves
// one group, so one query), so a thread fetches its kRows scores for one
// target code in one 16-byte load (kRows = 16).  Rows past the query score
// -128 there: under SW such a row can never pass the best real cell (its
// cells come from cells above and to the left less a gap or 128), so the
// running best needs no row mask.  NW/HW/OV read their last row from the
// thread that holds it, by predicates, once the sweep is done.
//
// What bounds it on the card.  Device memory: one pass reads 1 byte of
// target per column (4 for K4's int32 codes) and, between passes, writes
// and reads 16 bytes of (H, F) per column: (16 + 1) / (T * kRows) bytes per
// cell ((16 + 4) / (T * kRows) for K4), and only the target's bytes over
// T * kRows when one pass covers the query.  At 3.35 TB/s
// (1.06 B/cell at T = 1: 3.2 T cells/s; 17x less at T = 16) that is above the
// int32 issue rate, so the design is bound by operations: about eight
// int32 instructions per cell (four max-type, and the byte unpack), against
// 64 int32 lanes per clock per SM.  nvcc fuses the plain max(a + b, c) and
// max(a + b, c, 0) to VIADDMNMX(.RELU), so the DPX intrinsics add
// nothing.  The wavefront costs T - 1 idle steps per pass and the last
// pass computes up to T * kRows - 1 padding rows.
//
// The body is a template on its accumulator: int32 for K1, K3 and K4, and
// float for K1 acc="f32" (sw_tiled_f32_kernel: the same sequence in FADD
// and FMNMX, an I2F after each score's sign extend).  K1 acc="i16" runs
// the body on int16 pairs, two targets a thread (sw_pair16.cuh).
//
// Contract (checked by the Python wrappers): T is a power of two <= 32
// that divides blockDim.x, a multiple of 32 no larger than kTileBlock; a
// row's codes at j >= len may hold anything and are never read as matrix
// indices (only their low five bits are used; each policy's load4 says
// how far it reads).  Lengths are clamped to [0, N] and query spans to the
// query buffer, for memory safety only.

#pragma once

#include <type_traits>

#include "sw_grouped.cuh"

namespace sift4g {

constexpr int kRows = 16;                        // rows a thread: one 16-byte profile load
constexpr int kTileBlock = 128;                  // the largest block
constexpr int kProfRows = 32 * kRows;            // one profile: a pass at T = 32
constexpr int kProfStride = kProfRows + 16;      // bytes a code; staggers the banks

// Byte k of w, sign-extended (prmt: a selector nibble with its top bit set
// replicates the sign of the byte it names).
template <int k>
__device__ __forceinline__ int sext_byte(uint32_t w) {
  constexpr uint32_t n = 8u | k;
  int r;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(w), "r"(0u), "r"(k | (n << 4) | (n << 8) | (n << 12)));
  return r;
}

// The body's accumulator: int32 (K1, K3, K4) or float (K1 acc="f32",
// sift4g_tpu/align/pallas_sw.py:714-717: exact, since every value is an
// integer far inside 2^24).  The int32 instantiation is the body as it
// was before the float one existed, instruction for instruction.
template <class V>
struct Acc;

template <>
struct Acc<int> {
  using Pair = int2;
  static constexpr int kNegV = kNeg;
  static __device__ __forceinline__ int of(int x) { return x; }
  static __device__ __forceinline__ int to_int(int x) { return x; }
  static __device__ __forceinline__ int2 pair(int h, int f) { return make_int2(h, f); }
};

template <>
struct Acc<float> {
  using Pair = float2;
  static constexpr float kNegV = -(1 << 22);  // the JAX package's f32 sentinel
  static __device__ __forceinline__ float of(int x) { return __int2float_rn(x); }
  static __device__ __forceinline__ int to_int(float x) { return __float2int_rn(x); }
  static __device__ __forceinline__ float2 pair(float h, float f) { return make_float2(h, f); }
};

template <int MODE, class Rows, class V>
__device__ __forceinline__ void sw_tiled_body(
    const int32_t* __restrict__ q_all, int qm,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ q_len,
    Rows rows, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ matrix32, int B, int N, int go, int ge, int T,
    typename Acc<V>::Pair* __restrict__ scratch, int32_t* __restrict__ out) {
  using A = Acc<V>;
  using Pair = typename A::Pair;
  constexpr bool free_top = MODE != NW;
  constexpr bool free_left = MODE == SW || MODE == OV;
  constexpr bool row_max = MODE == HW || MODE == OV;
  constexpr unsigned kAll = 0xffffffffu;

  __shared__ __align__(16) int8_t prof[32 * kProfStride];

  const int g = blockIdx.y;
  const int t = threadIdx.x & (T - 1);
  const int b = blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  const bool live = b < B;
  const size_t gb = (size_t)g * B + b;
  int len = 0;
  typename Rows::Row row{};
  if (live) {
    len = min(max(lens[gb], 0), N);
    row = rows.row(gb, N, len);
  }
  const int off = Rows::grouped ? min(max(q_off[g], 0), qm) : 0;
  const int qlen = min(max(q_len[g], 0), qm - off);
  const int32_t* q = q_all + off;
  Pair* hf = scratch + (size_t)g * N * B + b;  // hf[j * B] = (H, F)
  const V vgo = A::of(go), vge = A::of(ge), neg = A::kNegV;

  // every lane of the warp runs to its longest row and stays in the shuffles
  const int wlen = __reduce_max_sync(kAll, len);
  const int nsteps = wlen > 0 ? wlen + T - 1 : 0;
  const int TR = T * kRows;
  const int npass = (qlen + TR - 1) / TR;

  V best = 0;          // SW: best cell, zero floor
  V col_best = neg;    // OV: best of the last column over the query's rows
  V fin = neg;         // NW: H of the last row at the last column; HW/OV: its row max
  for (int p = 0; p < npass; ++p) {
    const int p0 = p * TR;
    const int prow = p0 % kProfRows;
    if (prow == 0) {
      // the profile of the next kProfRows rows (or as many as the remaining
      // passes read); uniform over the block, whose threads share the query
      __syncthreads();
      const int nb = min(kProfRows, npass * TR - p0);
      for (int r = threadIdx.x; r < nb; r += blockDim.x) {
        const int qi = p0 + r;
        const int32_t* m = matrix32 + 32 * (qi < qlen ? (q[qi] & 31) : 0);
#pragma unroll 8
        for (int c = 0; c < 32; ++c) {
          prof[c * kProfStride + r] =
              static_cast<int8_t>(qi < qlen ? min(127, max(-128, m[c])) : -128);
        }
      }
      __syncthreads();
    }
    const int8_t* my_prof = prof + prow + t * kRows;
    const bool first = p == 0;
    const bool last = p == npass - 1;
    const int qi0 = p0 + t * kRows;  // this thread's first query row

    V H[kRows], E[kRows], M[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      H[r] = A::of(free_left ? 0 : -(go + (qi0 + r) * ge));  // left boundary H[i+1, 0]
      E[r] = H[r] - vgo;                                     // E at the first column
      M[r] = neg;
    }
    // the row above at the column before: the boundary H[qi0, 0]
    V hd = A::of((free_left || qi0 == 0) ? 0 : -(go + (qi0 - 1) * ge));
    // this thread's last row at its last column, and that column's code
    V hl = 0, fl = neg;
    int cl = 0;

    // thread 0 reads ahead: the codes of the next 4 columns, and the
    // previous pass's (H, F) four columns ahead
    uint32_t wn = 0;
    Pair pf[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) pf[k] = A::pair(0, neg);
    if (t == 0 && len > 0) {
      wn = rows.load4(row, 0, len);
      if (!first) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < len) pf[k] = hf[(size_t)k * B];
        }
      }
    }

    for (int s0 = 0; s0 < nsteps; s0 += 4) {
      const uint32_t w = wn;
      if (t == 0 && s0 + 4 < len) wn = rows.load4(row, s0 + 4, len);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + k;
        const int j = s - t;
        V hu = hl, fu = fl;
        int c = cl;
        if (T > 1) {
          hu = __shfl_up_sync(kAll, hl, 1, T);
          fu = __shfl_up_sync(kAll, fl, 1, T);
          c = __shfl_up_sync(kAll, cl, 1, T);
        }
        if (t == 0) {
          c = (w >> (8 * k)) & 31;
          if (first) {
            hu = A::of(free_top ? 0 : -(go + j * ge));  // boundary row H[0, j+1]
            fu = neg;
          } else {
            hu = pf[k].x;
            fu = pf[k].y;
            if (s + 4 < len) pf[k] = hf[(size_t)(s + 4) * B];
          }
        }
        if (j >= 0 && j < len) {
          const uint4 v = *reinterpret_cast<const uint4*>(my_prof + c * kProfStride);
          const uint32_t pw[4] = {v.x, v.y, v.z, v.w};
          V up = hu, f = fu, dg = hd, h_even = 0;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            int si;
            switch (r & 3) {
              case 0: si = sext_byte<0>(pw[r >> 2]); break;
              case 1: si = sext_byte<1>(pw[r >> 2]); break;
              case 2: si = sext_byte<2>(pw[r >> 2]); break;
              default: si = sext_byte<3>(pw[r >> 2]); break;
            }
            const V sc = A::of(si);
            f = max(up - vgo, f - vge);
            const V gg = MODE == SW ? max(max(dg + sc, f), V(0)) : max(dg + sc, f);
            const V h = max(gg, E[r]);
            E[r] = max(E[r] - vge, gg - vgo);
            dg = H[r];
            H[r] = h;
            up = h;
            if (MODE == SW) {
              if (r & 1) best = max(best, max(h_even, h));
              else h_even = h;
            }
            if (row_max) M[r] = max(M[r], h);
          }
          hd = hu;
          hl = up;
          fl = f;
          cl = c;
          if (!last && t == T - 1) hf[(size_t)j * B] = A::pair(up, f);
        }
      }
    }

    if (MODE == OV && len > 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (qi0 + r < qlen) col_best = max(col_best, H[r]);  // H at column len - 1
      }
    }
    if (MODE != SW && last) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (qi0 + r == qlen - 1) fin = MODE == NW ? H[r] : M[r];
      }
    }
    __syncwarp();  // this pass's scratch writes before the next pass's reads
  }

  if (qlen == 0) {
    // the boundary row is the last row
    fin = A::of(MODE == NW ? -(go + (len - 1) * ge) : 0);
  }
  if (T > 1) {
    if (MODE == SW) {
      for (int o = T >> 1; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kAll, best, o, T));
    } else {
      // the last row lives in one thread of the group
      const int owner = qlen > 0 ? ((qlen - 1) % TR) / kRows : 0;
      fin = __shfl_sync(kAll, fin, owner, T);
      if (MODE == OV) {
        for (int o = T >> 1; o > 0; o >>= 1) {
          col_best = max(col_best, __shfl_xor_sync(kAll, col_best, o, T));
        }
      }
    }
  }
  if (live && t == 0) {
    int result;
    if (MODE == SW) {
      result = A::to_int(best);
    } else if (MODE == NW) {
      result = len > 0 ? A::to_int(fin) : kNeg;
    } else if (MODE == HW) {
      result = len > 0 ? A::to_int(fin) : kNeg;
    } else {
      result = max(max(len > 0 ? A::to_int(fin) : kNeg, A::to_int(col_best)), 0);
    }
    out[gb] = result;
  }
}

// K1, K3 and K4: the body on int32.
template <int MODE, class Rows>
__global__ void __launch_bounds__(kTileBlock) sw_tiled_kernel(
    const int32_t* __restrict__ q_all, int qm,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ q_len,
    Rows rows, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ matrix32, int B, int N, int go, int ge, int T,
    int2* __restrict__ scratch, int32_t* __restrict__ out) {
  sw_tiled_body<MODE, Rows, int>(q_all, qm, q_off, q_len, rows, lens, matrix32, B, N, go,
                                 ge, T, scratch, out);
}

// K1 acc="f32": the body on float.
template <int MODE, class Rows>
__global__ void __launch_bounds__(kTileBlock) sw_tiled_f32_kernel(
    const int32_t* __restrict__ q_all, int qm,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ q_len,
    Rows rows, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ matrix32, int B, int N, int go, int ge, int T,
    float2* __restrict__ scratch, int32_t* __restrict__ out) {
  sw_tiled_body<MODE, Rows, float>(q_all, qm, q_off, q_len, rows, lens, matrix32, B, N,
                                   go, ge, T, scratch, out);
}

// Launches the kernel for `mode` on `stream` with T threads per target and
// `block` threads per block, on the accumulator V (int: sw_tiled_kernel;
// float: sw_tiled_f32_kernel); neither synchronises nor allocates; returns
// cudaGetLastError() (0 on success).  scratch holds G * N * B int2.
template <class Rows, class V = int>
int launch_sw_tiled(const int32_t* q_all, int qm, const int32_t* q_off,
                    const int32_t* q_len, Rows rows, const int32_t* lens,
                    const int32_t* matrix32, int G, int B, int N, int mode,
                    int go, int ge, int T, int block, void* scratch,
                    int32_t* out, void* stream) {
  if (G == 0 || B == 0) return 0;
  if (T < 1 || T > 32 || (T & (T - 1)) || block < 32 || block > kTileBlock ||
      block % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_block = block / T;
  const dim3 grid((B + per_block - 1) / per_block, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* scr = static_cast<typename Acc<V>::Pair*>(scratch);
#define SIFT4G_LAUNCH(M)                                                          \
  if constexpr (std::is_same<V, float>::value) {                                  \
    sw_tiled_f32_kernel<M, Rows><<<grid, block, 0, s>>>(                          \
        q_all, qm, q_off, q_len, rows, lens, matrix32, B, N, go, ge, T, scr, out); \
  } else {                                                                        \
    sw_tiled_kernel<M, Rows><<<grid, block, 0, s>>>(                              \
        q_all, qm, q_off, q_len, rows, lens, matrix32, B, N, go, ge, T, scr, out); \
  }
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

// K1 acc="i16": the tiled body (sw_tiled.cuh) on int16 pairs, two targets
// a thread, through Hopper's packed DPX instructions.
//
// Replaces the int16 accumulator of sift4g_tpu/align/pallas_sw.py
// (sw_scores_pallas_grouped(acc="i16"), :655-711): the same Gotoh
// recurrence as the int32 body, in int16 with NEG16 = -16000 as its
// sentinel, exact wherever the wrapper's admissibility rule (pallas_sw.py
// :698-701) holds, with the final reductions in int32.  On the TPU the
// int16 form never ran (Mosaic could not lower 16-bit vector max); on
// sm_90 every packed form the recurrence needs is one instruction that
// issues at the int32 rate: __viaddmax_s16x2(_relu) is VIADDMNMX.S16x2,
// __vmaxs2 VIMNMX.S16x2, __vimax3_s16x2 VIMNMX3.S16x2, __vsub2 VIADD.16x2.
//
// Design.  The T threads of a group score a PAIR of adjacent targets (2p,
// 2p + 1) of group g: each 32-bit register holds one query row's state
// for both targets, the first in its low 16 bits, the second in its high
// 16 bits, at the same column j.  Everything else is the int32 body's
// wavefront: kRows rows a thread, the (H, F) of the row above and the
// column's code (here the pair of codes, one byte each) shuffled from
// thread t - 1, passes of T * kRows rows with the (H, F) pairs of a
// pass's last row in the scratch ([g][j][p], uint2: half the int32 form's
// bytes a target).  Per row and column, on packed pairs:
//   F = __viaddmax_s16x2(F, -ge, __vsub2(H_up, go))
//   G = __viaddmax_s16x2_relu(H_diag, s, F)    (SW; __viaddmax_s16x2 else)
//   H = __vmaxs2(G, E)
//   E = __viaddmax_s16x2(E, -ge, __vsub2(G, go))
//   best = __vimax3_s16x2(best, H_even, H)     (SW, every second row)
// the int32 body's sequence with one cell pair in place of one cell.  The
// packed score comes from one PRMT a row: byte k of the first target's
// 16-byte profile load and byte k of the second's, each with its sign
// replicated into the byte above it.  The cost over the int32 body is a
// second LDS.128 a column and the pair's codes in one shuffled word.
//
// Per-half lengths.  A pair runs to the longer of its two targets (the
// warp runs to its longest anyway).  A half past its own length reads the
// profile's code 32, -128 in every row: under SW such a cell can never
// pass the best real cell (the argument the int32 body makes for rows past
// the query), and the cells of real columns never read it (columns flow
// left to right).  NW takes each half's last row at its own last column,
// OV each half's column there, and HW/OV take the last row's maximum over
// each half's own columns only (a LOP3 puts NEG16 in a half past its
// length before the max).
//
// What bounds it on the card: as the int32 body, operations, with half
// the instructions a cell (about 7.5 a cell pair: 4.5 max-family, two
// packed subtracts and a PRMT); device memory carries (16 + 2) /
// (T * kRows) bytes a cell pair (the (H, F) pair written and read back
// between passes, the two codes), half the int32 form's a cell.
//
// Contract (checked by the Python wrapper): the int32 body's, and the
// launch's queries, matrix and gaps inside the admissibility rule; a value
// outside int16 wraps.

#pragma once

#include "sw_tiled.cuh"

namespace sift4g {

constexpr int kNeg16 = -16000;                  // pallas_sw.py:655
constexpr int kPadCode = 32;                    // the profile row of -128s

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) | (static_cast<uint32_t>(hi) << 16);
}
__device__ __forceinline__ int lo16(uint32_t x) { return static_cast<int16_t>(x & 0xffffu); }
__device__ __forceinline__ int hi16(uint32_t x) { return static_cast<int>(x) >> 16; }

// Byte k of a and byte k of b, each sign-extended to 16 bits: the packed
// (a_k, b_k).  prmt's byte selectors 0-3 name a, 4-7 b; a selector with
// its top bit set replicates the sign of the byte it names.
template <int k>
__device__ __forceinline__ uint32_t sext_pair(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = k | ((8u | k) << 4) | ((4u + k) << 8) | ((12u + k) << 12);
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

template <int MODE, class Rows>
__global__ void __launch_bounds__(kTileBlock) sw_pair16_kernel(
    const int32_t* __restrict__ q_all, int qm,
    const int32_t* __restrict__ q_off, const int32_t* __restrict__ q_len,
    Rows rows, const int32_t* __restrict__ lens,
    const int32_t* __restrict__ matrix32, int B, int N, int go, int ge, int T,
    uint2* __restrict__ scratch, int32_t* __restrict__ out) {
  constexpr bool free_top = MODE != NW;
  constexpr bool free_left = MODE == SW || MODE == OV;
  constexpr bool row_max = MODE == HW || MODE == OV;
  constexpr unsigned kAll = 0xffffffffu;

  __shared__ __align__(16) int8_t prof[(kPadCode + 1) * kProfStride];

  const int g = blockIdx.y;
  const int t = threadIdx.x & (T - 1);
  const int P = (B + 1) / 2;
  const int p = blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  const size_t gb0 = (size_t)g * B + 2 * p;
  int len0 = 0, len1 = 0;
  typename Rows::Row row0{}, row1{};
  if (2 * p < B) {
    len0 = min(max(lens[gb0], 0), N);
    row0 = rows.row(gb0, N, len0);
  }
  if (2 * p + 1 < B) {
    len1 = min(max(lens[gb0 + 1], 0), N);
    row1 = rows.row(gb0 + 1, N, len1);
  }
  const int plen = max(len0, len1);
  const int off = Rows::grouped ? min(max(q_off[g], 0), qm) : 0;
  const int qlen = min(max(q_len[g], 0), qm - off);
  const int32_t* q = q_all + off;
  uint2* hf = scratch + (size_t)g * N * P + p;  // hf[j * P] = (H, F) pairs
  const uint32_t go2 = pack2(go, go), nge2 = pack2(-ge, -ge);
  const uint32_t neg2 = pack2(kNeg16, kNeg16);

  for (int r = threadIdx.x; r < kProfRows; r += blockDim.x) {
    prof[kPadCode * kProfStride + r] = -128;  // ordered by the first pass's barrier
  }

  // every lane of the warp runs to its longest pair and stays in the shuffles
  const int wlen = __reduce_max_sync(kAll, plen);
  const int nsteps = wlen > 0 ? wlen + T - 1 : 0;
  const int TR = T * kRows;
  const int npass = (qlen + TR - 1) / TR;

  uint32_t best = 0;             // SW: best cell pair, zero floor
  int cb0 = kNeg, cb1 = kNeg;    // OV: best of each half's last column
  int fin0 = kNeg, fin1 = kNeg;  // NW: H at each half's last cell; HW/OV: its row max
  for (int pass = 0; pass < npass; ++pass) {
    const int p0 = pass * TR;
    const int prow = p0 % kProfRows;
    if (prow == 0) {
      // the int32 body's profile of the next kProfRows rows
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
    const bool first = pass == 0;
    const bool last = pass == npass - 1;
    const int qi0 = p0 + t * kRows;

    uint32_t H[kRows], E[kRows], M[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int h = free_left ? 0 : -(go + (qi0 + r) * ge);
      H[r] = pack2(h, h);
      E[r] = pack2(h - go, h - go);
      M[r] = neg2;
    }
    const int hd0 = (free_left || qi0 == 0) ? 0 : -(go + (qi0 - 1) * ge);
    uint32_t hd = pack2(hd0, hd0);
    uint32_t hl = 0, fl = neg2, cl = 0;

    uint32_t wn0 = 0, wn1 = 0;
    uint2 pf[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) pf[k] = make_uint2(0, neg2);
    if (t == 0) {
      if (len0 > 0) wn0 = rows.load4(row0, 0, len0);
      if (len1 > 0) wn1 = rows.load4(row1, 0, len1);
      if (!first) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k < plen) pf[k] = hf[(size_t)k * P];
        }
      }
    }

    for (int s0 = 0; s0 < nsteps; s0 += 4) {
      const uint32_t w0 = wn0, w1 = wn1;
      if (t == 0) {
        if (s0 + 4 < len0) wn0 = rows.load4(row0, s0 + 4, len0);
        if (s0 + 4 < len1) wn1 = rows.load4(row1, s0 + 4, len1);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + k;
        const int j = s - t;
        uint32_t hu = hl, fu = fl, c = cl;
        if (T > 1) {
          hu = __shfl_up_sync(kAll, hl, 1, T);
          fu = __shfl_up_sync(kAll, fl, 1, T);
          c = __shfl_up_sync(kAll, cl, 1, T);
        }
        if (t == 0) {
          const uint32_t c0 = j < len0 ? (w0 >> (8 * k)) & 31 : kPadCode;
          const uint32_t c1 = j < len1 ? (w1 >> (8 * k)) & 31 : kPadCode;
          c = c0 | (c1 << 8);
          if (first) {
            const int h = free_top ? 0 : -(go + j * ge);  // boundary row H[0, j+1]
            hu = pack2(h, h);
            fu = neg2;
          } else {
            hu = pf[k].x;
            fu = pf[k].y;
            if (s + 4 < plen) pf[k] = hf[(size_t)(s + 4) * P];
          }
        }
        if (j >= 0 && j < plen) {
          const uint4 va = *reinterpret_cast<const uint4*>(my_prof + (c & 0xff) * kProfStride);
          const uint4 vb = *reinterpret_cast<const uint4*>(my_prof + (c >> 8) * kProfStride);
          const uint32_t pa[4] = {va.x, va.y, va.z, va.w};
          const uint32_t pb[4] = {vb.x, vb.y, vb.z, vb.w};
          // HW/OV: a half past its own length takes NEG16 into the row max
          const uint32_t keep = (j < len0 ? 0xffffu : 0u) | (j < len1 ? 0xffff0000u : 0u);
          uint32_t up = hu, f = fu, dg = hd, h_even = 0;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            uint32_t sc;
            switch (r & 3) {
              case 0: sc = sext_pair<0>(pa[r >> 2], pb[r >> 2]); break;
              case 1: sc = sext_pair<1>(pa[r >> 2], pb[r >> 2]); break;
              case 2: sc = sext_pair<2>(pa[r >> 2], pb[r >> 2]); break;
              default: sc = sext_pair<3>(pa[r >> 2], pb[r >> 2]); break;
            }
            f = __viaddmax_s16x2(f, nge2, __vsub2(up, go2));
            const uint32_t gg =
                MODE == SW ? __viaddmax_s16x2_relu(dg, sc, f) : __viaddmax_s16x2(dg, sc, f);
            const uint32_t h = __vmaxs2(gg, E[r]);
            E[r] = __viaddmax_s16x2(E[r], nge2, __vsub2(gg, go2));
            dg = H[r];
            H[r] = h;
            up = h;
            if (MODE == SW) {
              if (r & 1) best = __vimax3_s16x2(best, h_even, h);
              else h_even = h;
            }
            if (row_max) M[r] = __vmaxs2(M[r], (h & keep) | (neg2 & ~keep));
          }
          hd = hu;
          hl = up;
          fl = f;
          cl = c;
          if (!last && t == T - 1) hf[(size_t)j * P] = make_uint2(up, f);
          if (MODE == NW && last) {
            // each half's last cell, at its own last column
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (qi0 + r == qlen - 1) {
                if (j == len0 - 1) fin0 = lo16(H[r]);
                if (j == len1 - 1) fin1 = hi16(H[r]);
              }
            }
          }
          if (MODE == OV) {
            // each half's last column over the query's rows
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (qi0 + r < qlen) {
                if (j == len0 - 1) cb0 = max(cb0, lo16(H[r]));
                if (j == len1 - 1) cb1 = max(cb1, hi16(H[r]));
              }
            }
          }
        }
      }
    }

    if (row_max && last) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (qi0 + r == qlen - 1) {
          fin0 = lo16(M[r]);
          fin1 = hi16(M[r]);
        }
      }
    }
    __syncwarp();  // this pass's scratch writes before the next pass's reads
  }

  if (qlen == 0) {
    // the boundary row is the last row
    fin0 = MODE == NW ? -(go + (len0 - 1) * ge) : 0;
    fin1 = MODE == NW ? -(go + (len1 - 1) * ge) : 0;
  }
  if (T > 1) {
    if (MODE == SW) {
      for (int o = T >> 1; o > 0; o >>= 1) best = __vmaxs2(best, __shfl_xor_sync(kAll, best, o, T));
    } else {
      // the last row lives in one thread of the group
      const int owner = qlen > 0 ? ((qlen - 1) % TR) / kRows : 0;
      fin0 = __shfl_sync(kAll, fin0, owner, T);
      fin1 = __shfl_sync(kAll, fin1, owner, T);
      if (MODE == OV) {
        for (int o = T >> 1; o > 0; o >>= 1) {
          cb0 = max(cb0, __shfl_xor_sync(kAll, cb0, o, T));
          cb1 = max(cb1, __shfl_xor_sync(kAll, cb1, o, T));
        }
      }
    }
  }
  if (t == 0) {
    for (int h = 0; h < 2; ++h) {
      if (2 * p + h >= B) break;
      const int len = h ? len1 : len0;
      const int fin = h ? fin1 : fin0;
      int result;
      if (MODE == SW) {
        result = h ? hi16(best) : lo16(best);
      } else if (MODE == NW || MODE == HW) {
        result = len > 0 ? fin : kNeg;
      } else {
        result = max(max(len > 0 ? fin : kNeg, h ? cb1 : cb0), 0);
      }
      out[gb0 + h] = result;
    }
  }
}

// Launches the int16 pair kernel for `mode` on `stream` with T threads per
// target pair and `block` threads per block; neither synchronises nor
// allocates; returns cudaGetLastError() (0 on success).  scratch holds
// G * N * ceil(B / 2) uint2.
template <class Rows>
int launch_sw_pair16(const int32_t* q_all, int qm, const int32_t* q_off,
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
  const int P = (B + 1) / 2;
  const dim3 grid((P + per_block - 1) / per_block, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint2* scr = static_cast<uint2*>(scratch);
#define SIFT4G_LAUNCH(M)                                                      \
  sw_pair16_kernel<M, Rows><<<grid, block, 0, s>>>(                           \
      q_all, qm, q_off, q_len, rows, lens, matrix32, B, N, go, ge, T, scr, out)
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

// K6: the int32 add/max throughput probes.
//
// Replaces tools/bench_ab.py:95 (run_roofline: kern at :112, pallas_call
// at :125) and tools/bench_ab.py:154 (run_roofline_ilp: kern at :163,
// pallas_call at :183).  For each pair p < PAIRS, element (b, n) starts
// at a = n + salt + p, b = b - salt - p and runs M rounds of
// (a, b) = (max(a + 1, b), max(b - 1, a)); the result is
// out[b] = max over n and p of max(a, b), (B,) int32.  PAIRS = 1 is
// run_roofline exactly; the plain PyTorch version is in
// sift4g_tpu_torch/align/roofline.py.
//
// The update is written plainly, max(x + c, y): nvcc 12.8 fuses it into
// the DPX instruction VIADDMNMX by itself on sm_90a (cuobjdump -sass), so
// the intrinsic __viaddmax_s32 would compile to the same loop.  One
// kernel, templated on PAIRS (1, 2 or 4).
//
// What bounds it on the card: the integer pipes alone.  The state lives
// in registers (no memory traffic in the loop), so the rate is the rate
// at which the SMs dispatch the update instructions: 64 int32 add/min/max
// instructions per clock per SM as documented for compute capability 9.0,
// each VIADDMNMX an add and a max, so at most 2 x 64 counted operations
// per clock per SM.  Design: one
// block per row b, one thread per column (strided when N exceeds the
// block), PAIRS independent chains per thread, the round loop unrolled 4
// times so the loop counter costs little, and at 512 threads per block 4
// blocks resident per SM, enough warps to hide the two-instruction
// dependency of each chain.  The block's maximum is reduced with
// __reduce_max_sync and shared memory.
//
// s16x2_probe_kernel: the same update on int16 pairs, two elements a
// register (element h of a pair starts h further on: a = n + salt + p + h,
// b = b - salt - p - h), through __viaddmax_s16x2 (VIADDMNMX.S16x2), the
// values wrapping in int16: whether the packed DPX forms, which K1's int16
// accumulator runs on (sw_pair16.cuh), issue at the int32 forms' rate.
// It has no TPU counterpart (Mosaic could not lower 16-bit vector max).

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace sift4g {
namespace {

constexpr int kMaxThreads = 512;

template <int PAIRS>
__global__ void __launch_bounds__(kMaxThreads) int32_probe_kernel(
    int N, int M, int salt, int32_t* __restrict__ out) {
  const int row = blockIdx.x;
  int acc = INT_MIN;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int a[PAIRS], b[PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      a[p] = n + salt + p;
      b[p] = row - salt - p;
    }
#pragma unroll 4
    for (int r = 0; r < M; ++r) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const int na = max(a[p] + 1, b[p]);
        b[p] = max(b[p] - 1, a[p]);
        a[p] = na;
      }
    }
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) acc = max(acc, max(a[p], b[p]));
  }

  __shared__ int warp_max[kMaxThreads / 32];
  acc = __reduce_max_sync(0xffffffffu, acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    int v = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : INT_MIN;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) out[row] = v;
  }
}

template <int PAIRS>
__global__ void __launch_bounds__(kMaxThreads) s16x2_probe_kernel(
    int N, int M, int salt, int32_t* __restrict__ out) {
  const int row = blockIdx.x;
  int acc = INT_MIN;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    uint32_t a[PAIRS], b[PAIRS];
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int a0 = n + salt + p, b0 = row - salt - p;
      a[p] = (a0 & 0xffff) | (static_cast<uint32_t>(a0 + 1) << 16);
      b[p] = (b0 & 0xffff) | (static_cast<uint32_t>(b0 - 1) << 16);
    }
#pragma unroll 4
    for (int r = 0; r < M; ++r) {
#pragma unroll
      for (int p = 0; p < PAIRS; ++p) {
        const uint32_t na = __viaddmax_s16x2(a[p], 0x00010001u, b[p]);
        b[p] = __viaddmax_s16x2(b[p], 0xffffffffu, a[p]);
        a[p] = na;
      }
    }
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const uint32_t m = __vmaxs2(a[p], b[p]);
      acc = max(acc, max(static_cast<int>(static_cast<int16_t>(m & 0xffff)),
                         static_cast<int>(m) >> 16));
    }
  }

  __shared__ int warp_max[kMaxThreads / 32];
  acc = __reduce_max_sync(0xffffffffu, acc);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    int v = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : INT_MIN;
    v = __reduce_max_sync(0xffffffffu, v);
    if (lane == 0) out[row] = v;
  }
}

}  // namespace
}  // namespace sift4g

// C entry for ctypes.  Launches on `stream`; neither synchronises nor
// allocates; returns cudaGetLastError().
extern "C" int sift4g_int32_probe(int B, int N, int M, int salt, int pairs,
                                  int32_t* out, void* stream) {
  if (B <= 0 || N <= 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  // a multiple of the warp, so that every lane joins the reductions
  const int threads = N >= sift4g::kMaxThreads ? sift4g::kMaxThreads : (N + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFT4G_LAUNCH(P) \
  sift4g::int32_probe_kernel<P><<<B, threads, 0, s>>>(N, M, salt, out)
  switch (pairs) {
    case 1: SIFT4G_LAUNCH(1); break;
    case 2: SIFT4G_LAUNCH(2); break;
    case 4: SIFT4G_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIFT4G_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The packed probe's C entry, as sift4g_int32_probe's.
extern "C" int sift4g_s16x2_probe(int B, int N, int M, int salt, int pairs,
                                  int32_t* out, void* stream) {
  if (B <= 0 || N <= 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = N >= sift4g::kMaxThreads ? sift4g::kMaxThreads : (N + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SIFT4G_LAUNCH(P) \
  sift4g::s16x2_probe_kernel<P><<<B, threads, 0, s>>>(N, M, salt, out)
  switch (pairs) {
    case 1: SIFT4G_LAUNCH(1); break;
    case 2: SIFT4G_LAUNCH(2); break;
    case 4: SIFT4G_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SIFT4G_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

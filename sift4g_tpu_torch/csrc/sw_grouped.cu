// K1: grouped affine-gap alignment scores on target slabs.
//
// Replaces sift4g_tpu/align/pallas_sw.py:_sw_grouped_kernel (the slab
// form) and, through the port's aligner, _sw_grouped_long_kernel: this
// kernel has no width ceiling, so every length rung goes through it.
// Group g's B targets are targets[g, b, :lens[g, b]] of a (G, B, N) int8
// slab (N a multiple of 16, 16-byte aligned base).
//
// The kernel body is the tiled one of sw_tiled.cuh: T threads per target
// (chosen by the host from the launch's shape), 16 query rows a thread in
// registers, a query profile in shared memory.  Bound: the int32 issue
// rate (about eight instructions per cell); device memory carries (16 +
// 1) / (16 T) bytes per cell, see sw_tiled.cuh.
//
// (before: one thread per target, the H/F scratch read and written at
// every cell, 17 B/cell, bound by device memory.)
//
// The accumulator (acc=, the JAX wrapper's): "int" runs the body above on
// int32, "f32" the same body on float (sw_tiled.cuh), "i16" the body on
// int16 pairs, two targets a thread through the packed DPX instructions
// (sw_pair16.cuh).  All three give the same scores.

#include "sw_pair16.cuh"

// The accumulators of sw_scores_pallas_grouped(acc=...), pallas_sw.py:665.
enum Accumulator { kAccInt = 0, kAccI16 = 1, kAccF32 = 2 };

// C entry for ctypes.  acc picks the body: int32 (sw_tiled_kernel), int16
// pairs (sw_pair16_kernel; scratch holds G * N * ceil(B / 2) uint2) or
// float (sw_tiled_f32_kernel); another value gives cudaErrorInvalidValue.
extern "C" int sift4g_sw_grouped(
    const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
    const int8_t* targets, const int32_t* lens, const int32_t* matrix32,
    int G, int B, int N, int mode, int go, int ge, int acc,
    int threads_per_target, int block, void* scratch, int32_t* out,
    void* stream) {
  const sift4g::SlabRows rows{targets};
  switch (acc) {
    case kAccInt:
      return sift4g::launch_sw_tiled(q_all, qm, q_off, q_len, rows, lens, matrix32, G, B,
                                     N, mode, go, ge, threads_per_target, block, scratch,
                                     out, stream);
    case kAccI16:
      return sift4g::launch_sw_pair16(q_all, qm, q_off, q_len, rows, lens, matrix32, G, B,
                                      N, mode, go, ge, threads_per_target, block, scratch,
                                      out, stream);
    case kAccF32:
      return sift4g::launch_sw_tiled<sift4g::SlabRows, float>(
          q_all, qm, q_off, q_len, rows, lens, matrix32, G, B, N, mode, go, ge,
          threads_per_target, block, scratch, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

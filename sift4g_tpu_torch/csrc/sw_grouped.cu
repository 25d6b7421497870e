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

#include "sw_tiled.cuh"

// C entry for ctypes.
extern "C" int sift4g_sw_grouped(
    const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
    const int8_t* targets, const int32_t* lens, const int32_t* matrix32,
    int G, int B, int N, int mode, int go, int ge, int threads_per_target,
    int block, void* scratch, int32_t* out, void* stream) {
  return sift4g::launch_sw_tiled(q_all, qm, q_off, q_len,
                                 sift4g::SlabRows{targets}, lens, matrix32, G,
                                 B, N, mode, go, ge, threads_per_target, block,
                                 scratch, out, stream);
}

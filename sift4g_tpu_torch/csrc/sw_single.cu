// K4: affine-gap alignment scores of one query against B int32 target rows.
//
// Replaces sift4g_tpu/align/pallas_sw.py:_sw_kernel (wrapper
// sw_scores_pallas), the local scorer of the database-sharded factories of
// sift4g_tpu/parallel/sharded.py.  The query is q[0 : *qlen] of an (m_pad,)
// int32 buffer (qlen is read on the device, so a caller passes a query
// length without a host sync); the targets are a (B, N) int32 tensor of
// codes with any width N, whose values past each row's length may be
// anything (only their low five bits are read, as the Pallas kernel's
// 5-bit select tree reads them).  The result is (B,) int32, bit-identical
// to _sw_kernel in all four modes: the matrix clamped to int8 as its quad
// planes are, and a zero-length row scoring 0 under SW/OV and NEG under
// NW/HW.
//
// The kernel body is K1's tiled one (sw_tiled.cuh) at G = 1: T threads per
// target (chosen by the host from the launch's shape), 16 query rows a
// thread in registers, the query profile in shared memory, and the H/F
// scratch touched only between passes of 16 T rows.  The Int32Rows loader
// (sw_grouped.cuh) gives the body 4 codes at a time, packed into the bytes
// K1 reads: one int4 load where the row is aligned and the 4 codes lie
// inside it, single loads at its tail, never a read at or past its length.
// Bound: the int32 issue rate, as K1 (about eight instructions per cell);
// device memory carries (16 + 4) / (16 T) bytes per cell, the 4 bytes of an
// int32 code read once per pass (0.157 B/cell at T = 8).  Not carried over
// from the TPU kernel: the (26, B, N) int8 substitution planes and the
// log2(N) roll prefix max along the row, which fit Mosaic's vector unit.

#include "sw_tiled.cuh"

// C entry for ctypes.  scratch holds N * B int2.
extern "C" int sift4g_sw_single(
    const int32_t* q, int qm, const int32_t* qlen, const int32_t* targets,
    const int32_t* lens, const int32_t* matrix32, int B, int N, int mode,
    int go, int ge, int threads_per_target, int block, void* scratch,
    int32_t* out, void* stream) {
  const bool vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(targets) % 16 == 0;
  return sift4g::launch_sw_tiled(q, qm, nullptr, qlen,
                                 sift4g::Int32Rows{targets, vec4}, lens,
                                 matrix32, 1, B, N, mode, go, ge,
                                 threads_per_target, block, scratch, out,
                                 stream);
}

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
// The kernel body is K1's (sw_grouped.cuh) at G = 1, with the Int32Rows
// loader: up to four int4 loads for the next 16 codes of a row, single
// loads at its tail.  Bound: K1's 16 B/cell of H/F scratch traffic plus 4
// B/cell of int32 codes (re-read once per query row), about 20 B/cell at
// 3.35 TB/s.  Not carried over from the TPU kernel: the (26, B, N) int8
// substitution planes and the log2(N) roll prefix max along the row, which
// fit Mosaic's vector unit; a CUDA thread runs the row serially instead.

#include "sw_grouped.cuh"

// C entry for ctypes.  scratch holds N * B int2.
extern "C" int sift4g_sw_single(
    const int32_t* q, int qm, const int32_t* qlen, const int32_t* targets,
    const int32_t* lens, const int32_t* matrix32, int B, int N, int mode,
    int go, int ge, void* scratch, int32_t* out, void* stream) {
  const bool vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(targets) % 16 == 0;
  return sift4g::launch_sw_grouped(q, qm, nullptr, qlen,
                                   sift4g::Int32Rows{targets, vec4}, lens,
                                   matrix32, 1, B, N, mode, go, ge, scratch,
                                   out, stream);
}

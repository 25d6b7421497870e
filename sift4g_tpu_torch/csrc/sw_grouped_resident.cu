// K3: grouped affine-gap alignment scores on the device-resident database.
//
// Replaces sift4g_tpu/align/pallas_sw.py:_sw_grouped_kernel(resident=True)
// (wrapper sw_scores_pallas_grouped_resident).  Row (g, b) is read straight
// from the resident uint8 tensor at the int64 byte start starts[g, b]
// (16-byte aligned: the ResidentDB slot of align/resident.py), so a launch
// ships (G, B) starts and lengths instead of a (G, B, N) slab.  N is the
// launch's rung; it sizes the H/F scratch and bounds the lengths.  The
// kernel body is K1's (sw_grouped.cuh), templated on where a row's bytes
// come from; a row reads only its own slot (its length rounded up to 16).
//
// Bound: as K1, about 16 B/cell of H/F scratch traffic plus 1 B/cell of
// target bytes at 3.35 TB/s (about 197 G cells/s).
//
// Not carried over from the TPU kernel: the (n_slots, 8, 128) reshape of
// the database, the lag-16 row DMA window into VMEM and the dma_pipeline
// double buffer.  They assembled a slab in VMEM for Mosaic; a CUDA thread
// reads its row from device memory directly.

#include "sw_grouped.cuh"

// C entry for ctypes.
extern "C" int sift4g_sw_grouped_resident(
    const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
    const uint8_t* db, int64_t db_len, const int64_t* starts,
    const int32_t* lens, const int32_t* matrix32, int G, int B, int N,
    int mode, int go, int ge, void* scratch, int32_t* out, void* stream) {
  return sift4g::launch_sw_grouped(
      q_all, qm, q_off, q_len, sift4g::ResidentRows{db, starts, db_len}, lens,
      matrix32, G, B, N, mode, go, ge, scratch, out, stream);
}

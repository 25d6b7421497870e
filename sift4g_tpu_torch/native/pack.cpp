// Group-slab packing for the grouped Pallas launches.
//
// The Python per-target slice-assignment loop dominates the align phase's
// dispatch time at high query counts (measured: 15.3 s of a 31.8 s warm
// 500-query run).  This fills one (b, n_pad) int8 slab row per target with
// a memcpy from per-target (pointer, length) arrays.
//
// Row tails and unused rows are left untouched: the DP flows left to
// right, so columns past a target's length can never influence valid
// columns, and every consumer masks by the true lengths.

#include <cstdint>
#include <cstring>

extern "C" {

void sift4g_pack_group(const uint64_t* ptrs, const int32_t* lens, int32_t n,
                       int64_t n_pad, int8_t* out /* (>=n, n_pad) */,
                       int32_t* out_lens /* (>=n,) */) {
  for (int32_t r = 0; r < n; ++r) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(ptrs[r]);
    int32_t len = lens[r];
    if (len > n_pad) len = static_cast<int32_t>(n_pad);
    memcpy(out + static_cast<int64_t>(r) * n_pad, src, len);
    out_lens[r] = len;
  }
}

// Slot packing for the device-resident database (align/resident.py
// ResidentDB): every sequence is copied to a ``slot``-byte-aligned start
// (16 bytes on the GPU: the grouped kernel's uint4 loads).  ``slot_off``
// receives each sequence's int64 byte offset in the slotted buffer; the
// caller sizes ``out`` as total_slots * slot (+ tail pad) and zero-fills it
// beforehand (inter-slot gaps are masked garbage anyway).
void sift4g_slot_pack(const uint8_t* codes, const int64_t* offsets,
                      int64_t n_seq, uint8_t* out,
                      int64_t* slot_off /* (n_seq,) */, int64_t slot) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n_seq; ++i) {
    const int64_t len = offsets[i + 1] - offsets[i];
    slot_off[i] = pos;
    memcpy(out + pos, codes + offsets[i], len);
    pos += ((len + slot - 1) / slot) * slot;
    if (len == 0) pos += slot;  // zero-length records still own a slot
  }
}

}  // extern "C"

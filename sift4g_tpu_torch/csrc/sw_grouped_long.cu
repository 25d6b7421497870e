// K2: grouped affine-gap alignment scores (SW / NW / HW / OV) for long
// targets, for Hopper.
//
// Replaces sift4g_tpu/align/pallas_sw.py:_sw_grouped_long_kernel (:457,
// wrapper sw_scores_pallas_grouped_long :594).  Group g scores the query
// q_all[q_off[g] : q_off[g] + q_len[g]] against its B targets
// targets[g, b, :lens[g, b]] of a (G, B, N) int8 slab (N a multiple of 16,
// 16-byte aligned base); the result is (G, B) int32, bit-identical to the
// Pallas kernel and to the plain PyTorch version
// (sift4g_tpu_torch/align/scan.py:align_scores_grouped): the serial Gotoh
// recurrence of sw_tiled.cuh, cell for cell,
//   F = max(H_up - go, F_up - ge)
//   G = max(diag + s, F)            (and 0 under SW)
//   E = max(E_left - ge, G_left - go)
//   H = max(G, E)
// with the matrix clamped to int8, so the scores are exact for any
// go, ge >= 0 (go < ge included).  NW's top row is H[-1, j] = -(go + j ge)
// in absolute columns; NW and OV read each target at its own last column,
// HW and OV take the last row's maximum over the target's columns only.
//
// Design: a target's columns live in registers, spread over many warps,
// and the query rows stream through them.  A block scores one target with
// `warps` warps (at most kMaxWarps).  The target's columns are cut into
// strips of kStrip = 512 columns, 16 a lane; warp w runs strips w,
// w + warps, w + 2 warps, ... in turn.  Inside a strip the 32 lanes run
// K5's wavefront (dp_row_roofline.cu): at step st lane t computes query
// row st - t over its 16 columns and passes the E entering the next
// lane's first column and its last column's H (the next lane's diagonal
// one row later) by two __shfl_up_sync.  Between strips the same two
// values pass through a ring in shared memory: the last lane of strip
// s - 1 writes row i's (E, H) and publishes a row count every kPublish
// rows; strip s waits for it (and gives rows back every kRelease), so
// strip s runs about 32 steps behind strip s - 1 and every strip of the
// block is busy at once.  The diagonal of strip s's first column on row
// i is the H its left neighbour sent for row i - 1.  Every lane of a
// warp takes the ring's branches (the counts and slots are read as
// broadcasts, the last lane's stores are predicated), and a strip reads
// its next row's edge before the row's cells: a single lane's branch per
// step, its loads' latency exposed to the warp, had cost a quarter of K2's
// time on an H100 (1.0 against 0.76 ms at B = 256, N = 8,192).
//
// Scores come from a target profile in shared memory, prof[code][column]
// int8 for the 26 query codes, built per strip by the lanes that read it,
// so a lane takes its 16 scores for one row in one 16-byte load.  Columns
// at or past the target's length score -128 there: under SW such a cell
// never passes the best real cell (its value comes from a real cell less
// a gap or 128), so the running best needs no column mask.  A query code
// of 26-31 (none of the 26 letters) takes its scores from the clamped
// matrix instead.
//
// Strips in turn: a target of more strips than warps runs its query rows
// in tiles of kRowTile rows.  Per tile every warp runs its strips in turn;
// between tiles a strip's bottom (H, F) row waits in a device scratch
// (8 bytes a column, [gb][strip][k][lane], written and read back by the
// same lane) with the H above-left of its first column (the left
// neighbour's last H of the tile).  The last warp's strips feed warp 0's
// next strips through a ring of two tiles, so that ring never fills: its
// producer is at most one strip ahead of its consumer.  Every other ring
// holds kRing rows; its producer waits for free rows, its consumer for
// filled ones, all inside one block, and the wrap ring never blocks, so
// no wait can close a cycle (a ring of kRing rows needs kRing >= kPublish
// + kRelease - 1).  Each wait is bounded: past kSpinLimit polls (seconds)
// the kernel traps, a launch error rather than a hang.
//
// What bounds it on the card: operations, as K1.  Per 16 cells a lane
// issues one 16-byte profile load, two shuffles and the recurrence (four
// max-family instructions a cell, four and a half under SW); device
// memory carries the target's bytes once, the query codes (4 bytes a row
// a lane, from L1) and, with strips in turn, 16 bytes a column a tile.
// The wavefront adds 31 idle steps a strip and tile, and a strip starts
// about 32 steps after its left neighbour: a target of S strips spends
// about 32 (S - 1) steps filling its pipeline, so at a 360-row query a
// warp's step latency, not the issue rate, bounds K2 (Titin-class, 69
// strips: 7 % of the operations bound).  Idle: warps without a strip
// (targets shorter than warps x 512 columns).
//
// Not carried over from the TPU kernel: its 512-column VMEM chunks run in
// grid order, one after another, with per-row carries (edge_h_scr,
// edge_p_scr) and a decayed-prefix maximum for E; here the chunks (strips)
// run at once and E passes serially, lane to lane and strip to strip.
// m_cap (the rows of those carries) sizes nothing here: no buffer grows
// with the query.

#include "sw_tiled.cuh"  // Mode, kNeg (sw_grouped.cuh) and sext_byte

namespace sift4g {
namespace {

constexpr int kCols = 16;                    // columns a lane
constexpr int kLanes = 32;
constexpr int kStrip = kCols * kLanes;       // columns a warp
constexpr int kProfCodes = 26;               // query codes with a profile row
constexpr int kProfBytes = kProfCodes * kStrip;
constexpr int kMaxWarps = 16;                // 16 profiles: 208 KB of shared memory
constexpr int kRing = 64;                    // rows of a ring between two warps (a power of 2)
constexpr int kRowTile = 512;                // rows a tile when strips take turns (a power of 2)
constexpr int kWrap = 2 * kRowTile;          // rows of the ring into warp 0
constexpr int kPublish = 4;                  // rows a producer writes between counts
constexpr int kRelease = 8;                  // rows a consumer reads between counts
constexpr long long kSpinLimit = 1ll << 30;  // polls before a wait traps
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int strips_of(int n) { return (n + kStrip - 1) / kStrip; }

// Shared memory of a block of `warps` warps: the profiles, the clamped
// matrix, the rings (the wrap ring only when strips take turns), the rings'
// row counts and the reduction slots.
__host__ __device__ inline size_t ring_rows(int warps, bool wide) {
  return (wide ? kWrap : 0) + static_cast<size_t>(warps - 1) * kRing;
}
__host__ __device__ inline size_t smem_bytes(int warps, bool wide) {
  return static_cast<size_t>(warps) * kProfBytes + 32 * 32 + ring_rows(warps, wide) * 8 +
         3 * kMaxWarps * 4;
}

// The 16 scores of query code c against the lane's columns: codes
// tw (16 bytes, column c0 + k in byte k), of which the first kv lie inside
// the target; -128 past them.
__device__ __forceinline__ uint4 score_word(const int8_t* mat8, int c, uint4 tw, int kv) {
  const uint32_t in[4] = {tw.x, tw.y, tw.z, tw.w};
  uint32_t o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = 4 * w + k;
      const int v = col < kv ? mat8[c * 32 + ((in[w] >> (8 * k)) & 31)] : -128;
      x |= (static_cast<uint32_t>(v) & 255u) << (8 * k);
    }
    o[w] = x;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ int pick(const int (&h)[kCols], int k) {
  int v = h[0];
#pragma unroll
  for (int j = 1; j < kCols; ++j) v = j == k ? h[j] : v;
  return v;
}

// Spin until *p >= v; returns the value read.  The fence orders every
// later load after the read.
__device__ __forceinline__ int wait_for(const volatile int* p, int v) {
  int x = *p;
  long long n = 0;
  while (x < v) {
    if (++n > kSpinLimit) __trap();
    x = *p;
  }
  __threadfence_block();
  return x;
}

// One query row over the lane's columns: updates h, f (and the SW best),
// returns the E entering the next lane's first column.  G does not depend
// on E, so all 16 G come first and the E chain (one fused max a column)
// runs after them.
template <int MODE>
__device__ __forceinline__ int cells(int (&h)[kCols], int (&f)[kCols], int diag, int e,
                                     uint4 sw, int go, int ge, int& best) {
  const uint32_t pw[4] = {sw.x, sw.y, sw.z, sw.w};
  int g[kCols];
  int d = diag;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    int sc;
    switch (k & 3) {
      case 0: sc = sext_byte<0>(pw[k >> 2]); break;
      case 1: sc = sext_byte<1>(pw[k >> 2]); break;
      case 2: sc = sext_byte<2>(pw[k >> 2]); break;
      default: sc = sext_byte<3>(pw[k >> 2]); break;
    }
    const int fk = max(h[k] - go, f[k] - ge);
    g[k] = MODE == SW ? max(max(d + sc, fk), 0) : max(d + sc, fk);
    d = h[k];
    f[k] = fk;
  }
  int hp = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (k > 0) e = max(e - ge, g[k - 1] - go);
    const int hk = max(g[k], e);
    h[k] = hk;
    if (MODE == SW) {
      if (k & 1) best = max(best, max(hp, hk));
      hp = hk;
    }
  }
  return max(e - ge, g[kCols - 1] - go);
}

template <int MODE>
__global__ void __launch_bounds__(kMaxWarps * kLanes) sw_long_kernel(
    const int32_t* __restrict__ q_all, int qm, const int32_t* __restrict__ q_off,
    const int32_t* __restrict__ q_len, const int8_t* __restrict__ targets,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ matrix32, int B, int N,
    int go, int ge, int2* __restrict__ scratch, int32_t* __restrict__ out) {
  constexpr bool free_top = MODE != NW;
  constexpr bool free_left = MODE == SW || MODE == OV;
  constexpr bool row_max = MODE == HW || MODE == OV;

  const int g = blockIdx.y;
  const size_t gb = static_cast<size_t>(g) * B + blockIdx.x;
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int strips_max = strips_of(N);
  const bool wide = strips_max > warps;

  const int len = min(max(lens[gb], 0), N);
  const int off = min(max(q_off[g], 0), qm);
  const int M = min(max(q_len[g], 0), qm - off);
  const int32_t* q = q_all + off;
  if (len == 0 || M == 0) {
    // no cell to compute: the boundary row (M == 0) or no column (len == 0)
    if (threadIdx.x == 0) {
      int r = 0;
      if (MODE == NW) r = len > 0 ? -(go + (len - 1) * ge) : kNeg;
      if (MODE == HW) r = len > 0 ? 0 : kNeg;
      out[gb] = r;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const prof = reinterpret_cast<int8_t*>(smem) + static_cast<size_t>(warp) * kProfBytes;
  int8_t* const mat8 = reinterpret_cast<int8_t*>(smem) + static_cast<size_t>(warps) * kProfBytes;
  int2* const rings = reinterpret_cast<int2*>(mat8 + 32 * 32);
  int* const prod = reinterpret_cast<int*>(rings + ring_rows(warps, wide));
  int* const cons = prod + kMaxWarps;
  int* const red = cons + kMaxWarps;
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
    mat8[i] = static_cast<int8_t>(min(127, max(-128, matrix32[i])));
  }
  if (threadIdx.x < kMaxWarps) {
    prod[threadIdx.x] = 0;
    cons[threadIdx.x] = 0;
  }
  __syncthreads();

  // ring w carries the edge from warp w - 1 (warp 0: from the last warp)
  const int wrap_rows = wide ? kWrap : 0;
  const int nxt = warp + 1 == warps ? 0 : warp + 1;
  int2* const in_ring = rings + (warp == 0 ? 0 : wrap_rows + (warp - 1) * kRing);
  const int in_cap = warp == 0 ? wrap_rows : kRing;
  int2* const out_ring = rings + (nxt == 0 ? 0 : wrap_rows + (nxt - 1) * kRing);
  const int out_cap = nxt == 0 ? wrap_rows : kRing;
  volatile int* const in_prod = prod + warp;
  volatile int* const in_cons = cons + warp;
  volatile int* const out_prod = prod + nxt;
  volatile int* const out_cons = cons + nxt;

  const int S = strips_of(len);
  const int tile = S > warps ? kRowTile : M;
  const int R = (M + tile - 1) / tile;
  const size_t strip_base = gb * strips_max;
  // after the (H, F) rows: one corner H per (target, strip)
  int* const corners = reinterpret_cast<int*>(
      scratch + static_cast<size_t>(gridDim.x) * gridDim.y * strips_max * kStrip);

  int best = 0;       // SW: the best cell, zero floor
  int acc = kNeg;     // HW/OV: the last row's maximum; OV also each row's H at len - 1
  int cseq = 0, pseq = 0;     // rows taken from the input ring / put in the output ring
  int avail = 0, room = 0;    // the last counts read: rows filled, rows freed
  int h[kCols], f[kCols];

  for (int r = 0; r < R; ++r) {
    const int r0 = r * tile;
    const int rows = min(tile, M - r0);
    const bool last_tile = r == R - 1;
    for (int s = warp; s < S; s += warps) {
      const int c0 = s * kStrip + t * kCols;  // the lane's first column
      const bool left = s > 0, right = s + 1 < S;
      uint4 tw = make_uint4(0, 0, 0, 0);
      if (c0 < N) tw = *reinterpret_cast<const uint4*>(targets + gb * N + c0);
      const int kv = min(max(len - c0, 0), kCols);
      // OV: the lane holding column len - 1 keeps that column's best
      const int kl = (len - 1 - c0) >= 0 && (len - 1 - c0) < kCols ? len - 1 - c0 : -1;
      // this lane's part of the strip's profile (only this lane reads it)
#pragma unroll 2
      for (int c = 0; c < kProfCodes; ++c) {
        *reinterpret_cast<uint4*>(prof + c * kStrip + t * kCols) = score_word(mat8, c, tw, kv);
      }
      int2* const hf = scratch + (strip_base + s) * kStrip + t;  // hf[k * 32]
      if (r == 0) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          h[k] = free_top ? 0 : -(go + (c0 + k) * ge);  // the top row H[-1, j]
          f[k] = kNeg;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int2 v = hf[k * kLanes];
          h[k] = v.x;
          f[k] = v.y;
        }
      }

      // the left boundary, or the left strip's edge, of row i: read by every
      // lane (one broadcast load, no divergent branch), used by lane 0
      int corner = 0;
      auto left_edge = [&](int i, int& e_in, int& h_in) {
        if (!left) {
          const int b0 = free_left ? 0 : -(go + (r0 + i) * ge);  // H[r0 + i, -1]
          e_in = b0 - go;
          h_in = b0;
          return;
        }
        const int n = cseq + i;
        if (n >= avail) avail = wait_for(in_prod, n + 1);
        const int2 v = in_ring[n & (in_cap - 1)];
        if ((i + 1) % kRelease == 0 || i == rows - 1) {
          // the rows read so far are free again
          __threadfence_block();
          if (t == 0) *in_cons = n + 1;
        }
        e_in = v.x;
        h_in = v.y;
        if (i == rows - 1) corner = v.y;
      };

      // the lane's state before its first row: diag = H[r0 - 1, c0 - 1]
      int diag = 0, e = 0, hl;
      if (t == 0) {
        if (!left) {
          diag = (r0 == 0 || free_left) ? 0 : -(go + (r0 - 1) * ge);
        } else if (r0 == 0) {
          diag = free_top ? 0 : -(go + (c0 - 1) * ge);
        } else {
          diag = corners[strip_base + s];
        }
      }
      hl = __shfl_up_sync(kAll, h[kCols - 1], 1);
      {
        int e0, h0;
        left_edge(0, e0, h0);
        if (t == 0) {
          e = e0;
          hl = h0;
        }
      }

      // a row's query code is loaded a step ahead, its scores at the step
      auto code = [&](int i) { return __ldg(q + r0 + min(max(i, 0), rows - 1)) & 31; };
      auto scores = [&](int c) {
        return c < kProfCodes ? *reinterpret_cast<const uint4*>(prof + c * kStrip + t * kCols)
                              : score_word(mat8, c, tw, kv);
      };
      int qn = code(-t);

      auto step = [&](int st, bool guard) {
        const int i = st - t;
        // lane 0's next left edge (row st + 1), fetched before the cells
        int e0 = 0, h0 = 0;
        if (st + 1 < rows) left_edge(st + 1, e0, h0);
        const int qc = qn;
        qn = code(i + 1);
        int eo = 0;
        if (!guard || static_cast<unsigned>(i) < static_cast<unsigned>(rows)) {
          eo = cells<MODE>(h, f, diag, e, scores(qc), go, ge, best);
          if (MODE == OV && kl >= 0) acc = max(acc, pick(h, kl));
        }
        // the last lane's edge of row st - 31 to the next strip: every lane
        // takes the branch (uniform), lane 31 stores
        const int io = st - (kLanes - 1);
        if (right && static_cast<unsigned>(io) < static_cast<unsigned>(rows)) {
          const int n = pseq + io;
          if (n - room >= out_cap) room = wait_for(out_cons, n - out_cap + 1);
          if (t == kLanes - 1) out_ring[n & (out_cap - 1)] = make_int2(eo, h[kCols - 1]);
          if ((io + 1) % kPublish == 0 || io == rows - 1) {
            __threadfence_block();
            if (t == kLanes - 1) *out_prod = n + 1;
          }
        }
        diag = hl;
        e = __shfl_up_sync(kAll, eo, 1);
        hl = __shfl_up_sync(kAll, h[kCols - 1], 1);
        if (t == 0 && st + 1 < rows) {
          e = e0;
          hl = h0;
        }
      };

      // rows + 31 steps; the first and last 31 guarded
      const int steps = rows + kLanes - 1;
      const int lead = min(kLanes - 1, rows);
      int st = 0;
      for (; st < lead; ++st) step(st, true);
      for (; st < rows; ++st) step(st, false);
      for (; st < steps; ++st) step(st, true);

      if (left) cseq += rows;
      if (right) pseq += rows;
      if (!last_tile) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) hf[k * kLanes] = make_int2(h[k], f[k]);
        if (t == 0 && left) corners[strip_base + s] = corner;
      } else if (MODE == NW) {
        if (kl >= 0) out[gb] = pick(h, kl);
      } else if (row_max) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (k < kv) acc = max(acc, h[k]);
        }
      }
    }
  }

  if (MODE != NW) {
    int v = MODE == SW ? best : acc;
    v = __reduce_max_sync(kAll, v);
    if (t == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < warps; ++w) v = max(v, red[w]);
      out[gb] = MODE == OV ? max(v, 0) : v;
    }
  }
}

template <int MODE>
int launch_long(const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
                const int8_t* targets, const int32_t* lens, const int32_t* matrix32, int G,
                int B, int N, int go, int ge, int warps, int2* scratch, int32_t* out,
                cudaStream_t st) {
  const size_t smem = smem_bytes(warps, strips_of(N) > warps);
  cudaError_t err = cudaFuncSetAttribute(sw_long_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_long_kernel<MODE><<<dim3(B, G), warps * kLanes, smem, st>>>(
      q_all, qm, q_off, q_len, targets, lens, matrix32, B, N, go, ge, scratch, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sift4g

// Bytes of device scratch a launch needs: with strips in turn (more strips
// of 512 columns than warps), the (H, F) row of every strip column and one
// corner H per strip; 0 otherwise.
extern "C" long long sift4g_sw_long_scratch_bytes(int G, int B, int N, int warps) {
  using namespace sift4g;
  const long long strips = strips_of(N);
  if (strips <= warps) return 0;
  return static_cast<long long>(G) * B * strips * (kStrip * 8 + 4);
}

// C entry for ctypes.  One block a target, `warps` warps a block (1 to
// 16).  Launches on `stream`; neither synchronises nor allocates; returns
// cudaGetLastError() (cudaErrorInvalidValue for a request the kernel does
// not take).
extern "C" int sift4g_sw_grouped_long(
    const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
    const int8_t* targets, const int32_t* lens, const int32_t* matrix32, int G, int B, int N,
    int mode, int go, int ge, int warps, void* scratch, int32_t* out, void* stream) {
  using namespace sift4g;
  if (G == 0 || B == 0) return 0;
  if (G > 65535 || N <= 0 || N % 16 || warps < 1 || warps > kMaxWarps || go < 0 || ge < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (strips_of(N) > warps && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* scr = static_cast<int2*>(scratch);
  switch (mode) {
    case SW: return launch_long<SW>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, scr, out, st);
    case NW: return launch_long<NW>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, scr, out, st);
    case HW: return launch_long<HW>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, scr, out, st);
    case OV: return launch_long<OV>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, scr, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

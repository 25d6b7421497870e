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
// Design: a target's columns live in registers, spread over the warps of
// a thread-block cluster, and the query rows stream through them.  A
// cluster of `cl` blocks (at most kMaxCluster; launched with
// cudaLaunchKernelEx and a cluster dimension) scores one target with
// `warps` warps a block (at most kMaxWarps): P = cl x warps positions,
// position rank x warps + warp.  The target's columns are cut into strips
// of kStrip = 512 columns, 16 a lane; position p runs strips p, p + P,
// p + 2P, ... in turn.  Inside a strip the 32 lanes run K5's wavefront
// (dp_row_roofline.cu): at step st lane t computes query row st - t over
// its 16 columns and passes the E entering the next lane's first column
// and its last column's H (the next lane's diagonal one row later) by two
// __shfl_up_sync.  Between strips the same two values pass through a ring
// in the shared memory of the consumer's block: the last lane of strip
// s - 1 writes row i's (E, H) and publishes a row count every kPublish
// rows (a release store by that lane); strip s waits for it (an acquire
// load) and gives rows back every kRelease (lane 0's release store).  A
// ring between two blocks of the cluster is written through distributed
// shared memory (mapa + st.shared::cluster) and its counts are released
// and acquired at cluster scope, every kPublishRemote and kReleaseRemote
// rows (a release at cluster scope waits for the remote stores before
// it); a ring inside a block at block scope.
// Strip s runs about 32 steps behind strip s - 1 and every strip of the
// cluster is busy at once.  Every lane of a warp takes the ring's
// branches (the counts and slots are read as broadcasts, the lane-0 and
// lane-31 stores are predicated).  A strip reads its next row's edge, the
// next row's profile word and the query code of the row after it a step
// ahead of the cells, and gives its consumed rows back before it issues
// those loads, so no release waits for a load in flight.  Steps run in
// pairs, the profile words of even and odd steps in two register sets.
// The costs this schedule hides, measured on an H100 by rebuilding the
// kernel with one cost taken out at a time (a lone warp's one-row step,
// one block a target; PERF.md section 6): sequentially consistent fences
// by every lane took 244 of 691 cycles, the edge 173, the code load 130,
// the profile load 94.  One row a step, not two: a
// lone warp's step is bound by its instructions (two rows took 1,190
// cycles), and the wavefront's lag is 32 steps a strip however many rows
// a step holds.
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
// The cluster: its blocks are co-scheduled, so a wait on another block
// cannot deadlock; no block touches another's shared memory before the
// cluster barrier that follows the counts' initialisation, and none exits
// before the barrier that ends the kernel (by then every ring is drained
// and the per-block maxima are in rank 0's shared memory, which takes the
// cluster's maximum).
//
// Strips in turn: a target of more strips than positions runs its query
// rows in tiles of kRowTile rows.  Per tile every position runs its strips
// in turn; between tiles a strip's bottom (H, F) row waits in a device
// scratch (8 bytes a column, [gb][strip][k][lane], written and read back
// by the same lane) with the H above-left of its first column (the left
// neighbour's last H of the tile).  The last position's strips feed
// position 0's next strips through a ring of two tiles, so that ring never
// fills: its producer is at most one strip ahead of its consumer.  Every
// other ring holds kRing rows; its producer waits for free rows, its
// consumer for filled ones, and the wrap ring never blocks, so no wait can
// close a cycle (a ring of kRing rows needs kRing >= kPublishRemote +
// kReleaseRemote - 1).  Each wait is bounded: past kSpinLimit polls (seconds) the kernel
// traps, a launch error rather than a hang.
//
// What bounds it on the card: operations, as K1.  Per 16 cells a lane
// issues one 16-byte profile load, two shuffles and the recurrence (four
// max-family instructions a cell, four and a half under SW); device
// memory carries the target's bytes once, the query codes (4 bytes a row
// a lane, from L1) and, with strips in turn, 16 bytes a column a tile.
// The wavefront adds 31 idle steps a strip and tile, and a strip starts
// about 32 steps after its left neighbour: a target of S strips spends
// about 32 (S - 1) steps filling its pipeline, so at a 360-row query a
// warp's step latency, not the issue rate, bounds K2 on Titin-class
// targets; the warps that share an SM's issue slots set that latency, and
// a cluster spreads a target's live strips over several SMs.  Idle:
// positions without a strip (targets shorter than P x 512 columns).
//
// Not carried over from the TPU kernel: its 512-column VMEM chunks run in
// grid order, one after another, with per-row carries (edge_h_scr,
// edge_p_scr) and a decayed-prefix maximum for E; here the chunks (strips)
// run at once and E passes serially, lane to lane and strip to strip.
// m_cap (the rows of those carries) sizes nothing here: no buffer grows
// with the query.

#include <type_traits>

#include "sw_tiled.cuh"  // Mode, kNeg (sw_grouped.cuh) and sext_byte

namespace sift4g {
namespace {

constexpr int kCols = 16;                    // columns a lane
constexpr int kLanes = 32;
constexpr int kStrip = kCols * kLanes;       // columns a warp
constexpr int kProfCodes = 26;               // query codes with a profile row
constexpr int kProfBytes = kProfCodes * kStrip;
constexpr int kMaxWarps = 16;                // 16 profiles: 208 KB of shared memory
constexpr int kMaxCluster = 8;               // blocks a cluster (the portable most)
constexpr int kRing = 64;                    // rows of a ring between two warps (a power of 2)
constexpr int kRowTile = 512;                // rows a tile when strips take turns (a power of 2)
constexpr int kWrap = 2 * kRowTile;          // rows of the ring into position 0: two tiles
// rows a producer writes between counts and a consumer reads between
// counts (powers of 2), inside a block and between two blocks, where each
// count is a release at cluster scope
constexpr int kPublish = 2, kRelease = 4;
constexpr int kPublishRemote = 16, kReleaseRemote = 16;
static_assert(kRing >= kPublishRemote + kReleaseRemote - 1 && kRing >= kPublish + kRelease - 1,
              "a ring too small for its counts' batches can deadlock");
constexpr long long kSpinLimit = 1ll << 30;  // polls before a wait traps
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int strips_of(int n) { return (n + kStrip - 1) / kStrip; }

// Shared memory of a block of `warps` warps: the profiles, the clamped
// matrix, the rings (int2 rows; warp 0's holds two tiles when strips take
// turns), the rings' counts and the reduction slots.
__host__ __device__ inline int ring0_rows(bool wide) { return wide ? kWrap : kRing; }
__host__ __device__ inline size_t ring_rows(int warps, bool wide) {
  return ring0_rows(wide) + static_cast<size_t>(warps - 1) * kRing;
}
__host__ __device__ inline size_t smem_bytes(int warps, bool wide) {
  return static_cast<size_t>(warps) * kProfBytes + 32 * 32 + ring_rows(warps, wide) * 8 +
         (3 * kMaxWarps + kMaxCluster) * 4;
}

// Shared memory of the cluster: 32-bit addresses of the shared::cta and
// shared::cluster windows, and the ring's loads and stores on them.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// a count in this block's shared memory, written by a warp of this block
// (block scope) or of another block of the cluster (cluster scope)
__device__ __forceinline__ int load_acquire(uint32_t a, bool cluster) {
  int v;
  if (cluster) {
    asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  } else {
    asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  }
  return v;
}
// One lane's stores, predicated rather than branched around: into this
// block's shared memory (an address of the shared::cta window; a count
// released at block scope) or another block's (of the shared::cluster
// window; released at cluster scope, which waits for every earlier store
// of the thread, the remote ones included).
__device__ __forceinline__ void store2_if(bool p, uint32_t a, int2 v, bool remote) {
  if (remote) {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
                 "@q st.shared::cluster.v2.b32 [%1], {%2, %3};\n\t}"
                 ::"r"(static_cast<int>(p)), "r"(a), "r"(v.x), "r"(v.y) : "memory");
  } else {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
                 "@q st.shared::cta.v2.b32 [%1], {%2, %3};\n\t}"
                 ::"r"(static_cast<int>(p)), "r"(a), "r"(v.x), "r"(v.y) : "memory");
  }
}
__device__ __forceinline__ void release_if(bool p, uint32_t a, int v, bool remote) {
  if (remote) {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
                 "@q st.release.cluster.shared::cluster.b32 [%1], %2;\n\t}"
                 ::"r"(static_cast<int>(p)), "r"(a), "r"(v) : "memory");
  } else {
    asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
                 "@q st.release.cta.shared::cta.b32 [%1], %2;\n\t}"
                 ::"r"(static_cast<int>(p)), "r"(a), "r"(v) : "memory");
  }
}
__device__ __forceinline__ void store1(uint32_t a, int v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ int2 load2(uint32_t a) {
  int2 v;
  asm volatile("ld.shared::cta.v2.b32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(a)
               : "memory");
  return v;
}

// Spin until the count at `a` reaches v; returns the value read.  The
// acquire orders every later load and store after the read.
__device__ __forceinline__ int wait_for(uint32_t a, int v, bool cluster) {
  int x = load_acquire(a, cluster);
  long long n = 0;
  while (x < v) {
    if (++n > kSpinLimit) __trap();
    x = load_acquire(a, cluster);
  }
  return x;
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

__device__ __forceinline__ int score_of(const uint32_t (&pw)[4], int k) {
  switch (k & 3) {
    case 0: return sext_byte<0>(pw[k >> 2]);
    case 1: return sext_byte<1>(pw[k >> 2]);
    case 2: return sext_byte<2>(pw[k >> 2]);
    default: return sext_byte<3>(pw[k >> 2]);
  }
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
    const int fk = max(h[k] - go, f[k] - ge);
    g[k] = MODE == SW ? max(max(d + score_of(pw, k), fk), 0) : max(d + score_of(pw, k), fk);
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

// kCluster: a launch of clusters of more than one block (a ring may join
// two blocks); without it every ring is inside a block.
template <int MODE, bool kCluster>
__global__ void __launch_bounds__(kMaxWarps * kLanes) sw_long_kernel(
    const int32_t* __restrict__ q_all, int qm, const int32_t* __restrict__ q_off,
    const int32_t* __restrict__ q_len, const int8_t* __restrict__ targets,
    const int32_t* __restrict__ lens, const int32_t* __restrict__ matrix32, int B, int N,
    int go, int ge, int cl, int2* __restrict__ scratch, int32_t* __restrict__ out) {
  constexpr bool free_top = MODE != NW;
  constexpr bool free_left = MODE == SW || MODE == OV;
  constexpr bool row_max = MODE == HW || MODE == OV;

  const int g = blockIdx.y;
  const int rank = kCluster ? cluster_rank() : 0;
  const size_t gb = static_cast<size_t>(g) * B + blockIdx.x / cl;
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int P = cl * warps;              // positions: the cluster's warps
  const int pos = rank * warps + warp;
  const int strips_max = strips_of(N);
  const bool wide = strips_max > P;

  const int len = min(max(lens[gb], 0), N);
  const int off = min(max(q_off[g], 0), qm);
  const int M = min(max(q_len[g], 0), qm - off);
  const int32_t* q = q_all + off;
  if (len == 0 || M == 0) {
    // no cell to compute: the boundary row (M == 0) or no column (len == 0);
    // every block of the cluster returns here, before touching another's
    if (rank == 0 && threadIdx.x == 0) {
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
  int* const filled = reinterpret_cast<int*>(rings + ring_rows(warps, wide));
  int* const freed = filled + kMaxWarps;
  int* const red = freed + kMaxWarps;
  int* const cred = red + kMaxWarps;
  for (int i = threadIdx.x; i < 32 * 32; i += blockDim.x) {
    mat8[i] = static_cast<int8_t>(min(127, max(-128, matrix32[i])));
  }
  if (threadIdx.x < kMaxWarps) {
    filled[threadIdx.x] = 0;
    freed[threadIdx.x] = 0;
  }
  // every block of the cluster runs and has zeroed its counts
  cluster_sync();

  // ring w of a block carries the edge into its warp w: from warp w - 1, or
  // for warp 0 from the last warp of the previous block (of the last block
  // for rank 0: the wrap ring, used only when strips take turns).  Its
  // rows and its filled count live in the consumer's block, its freed
  // count in the producer's.
  const int ring0 = ring0_rows(wide);
  auto ring_of = [&](int w) { return rings + (w == 0 ? 0 : ring0 + (w - 1) * kRing); };
  const int p_rank = warp > 0 ? rank : (rank + cl - 1) % cl;
  const int p_warp = warp > 0 ? warp - 1 : warps - 1;
  const int c_rank = warp + 1 < warps ? rank : (rank + 1) % cl;
  const int c_warp = warp + 1 < warps ? warp + 1 : 0;
  const bool remote_in = kCluster && p_rank != rank, remote_out = kCluster && c_rank != rank;
  const int in_cap = warp == 0 ? ring0 : kRing;
  const int out_cap = c_warp == 0 ? ring0 : kRing;
  const uint32_t in_ring = smem_u32(ring_of(warp));
  const uint32_t in_filled = smem_u32(filled + warp);
  // a ring inside the block keeps its shared::cta addresses
  auto at = [&](const void* ptr, int r) {
    return r == rank ? smem_u32(ptr) : map_rank(smem_u32(ptr), r);
  };
  const uint32_t in_freed = at(freed + p_warp, p_rank);
  const uint32_t out_ring = at(ring_of(c_warp), c_rank);
  const uint32_t out_filled = at(filled + c_warp, c_rank);
  const uint32_t out_freed = smem_u32(freed + warp);
  const int pub = remote_out ? kPublishRemote : kPublish;
  const int rel = remote_in ? kReleaseRemote : kRelease;

  const int S = strips_of(len);
  const int tile = S > P ? kRowTile : M;
  const int R = (M + tile - 1) / tile;
  const size_t strip_base = gb * strips_max;
  // after the (H, F) rows: one corner H per (target, strip)
  int* const corners = reinterpret_cast<int*>(
      scratch + static_cast<size_t>(gridDim.y) * B * strips_max * kStrip);

  int best = 0;       // SW: the best cell, zero floor
  int acc = kNeg;     // HW/OV: the last row's maximum; OV also each row's H at len - 1
  int cseq = 0, pseq = 0;     // rows taken from the input ring / put in the output ring
  int avail = 0, room = 0;    // the last counts read: rows filled, rows freed
  int h[kCols], f[kCols];

  for (int r = 0; r < R; ++r) {
    const int r0 = r * tile;
    const int rows = min(tile, M - r0);
    const bool last_tile = r == R - 1;
    for (int s = pos; s < S; s += P) {
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

      // the left boundary, or the left strip's edge, of row i: (E, H), read
      // by every lane (one broadcast load, no divergent branch), used by
      // lane 0.  Its count goes back before the step issues any load, so
      // the release waits for none.
      int corner = 0;
      auto left_edge = [&](int i) {
        if (!left) {
          const int b0 = free_left ? 0 : -(go + (r0 + i) * ge);  // H[r0 + i, -1]
          return make_int2(b0 - go, b0);
        }
        const int n = cseq + i;
        if (n >= avail) avail = wait_for(in_filled, n + 1, remote_in);
        const int2 v = load2(in_ring + (n & (in_cap - 1)) * 8);
        // the rows read so far are free again
        if (((i + 1) & (rel - 1)) == 0 || i == rows - 1) {
          release_if(t == 0, in_freed, n + 1, remote_in);
        }
        if (i == rows - 1) corner = v.y;
        return v;
      };

      // a row's query code is loaded two steps ahead and its profile word
      // one step ahead, so the cells wait for neither
      auto code = [&](int i) { return __ldg(q + r0 + min(max(i, 0), rows - 1)) & 31; };
      auto prof_word = [&](int c) {
        return *reinterpret_cast<const uint4*>(prof + c * kStrip + t * kCols);
      };
      auto scores = [&](int c) {
        return c < kProfCodes ? prof_word(c) : score_word(mat8, c, tw, kv);
      };

      // the lane's state before its first row: diag = H[r0 - 1, c0 - 1]
      int diag = __shfl_up_sync(kAll, h[kCols - 1], 1);
      int hl = diag, e = 0;
      const int2 le0 = left_edge(0);
      if (t == 0) {
        if (!left) {
          diag = (r0 == 0 || free_left) ? 0 : -(go + (r0 - 1) * ge);
        } else if (r0 == 0) {
          diag = free_top ? 0 : -(go + (c0 - 1) * ge);
        } else {
          diag = corners[strip_base + s];
        }
        e = le0.x;
        hl = le0.y;
      }
      // the profile words of even and odd steps: a step reads one and loads
      // the other, so no word moves between registers
      uint4 swa = scores(code(-t)), swb = swa;
      int qn = code(1 - t);

      auto step = [&](int st, bool guard, auto odd) {
        uint4& sw = decltype(odd)::value ? swb : swa;
        uint4& sw_next = decltype(odd)::value ? swa : swb;
        const int i = st - t;
        // lane 0's next left edge (row st + 1)
        int2 le = make_int2(0, 0);
        if (st + 1 < rows) le = left_edge(st + 1);
        // the next row's profile word (a warp whose codes are all letters,
        // the rule, loads it without a branch), and the code of the row after
        sw_next = __any_sync(kAll, qn >= kProfCodes) ? scores(qn) : prof_word(qn);
        qn = code(i + 2);
        int eo = 0;
        if (!guard || static_cast<unsigned>(i) < static_cast<unsigned>(rows)) {
          eo = cells<MODE>(h, f, diag, e, sw, go, ge, best);
          if (MODE == OV && kl >= 0) acc = max(acc, pick(h, kl));
        }
        // the last lane's edge of row st - 31 to the next strip: every lane
        // takes the branch (uniform), lane 31 stores and publishes
        const int io = st - (kLanes - 1);
        if (right && static_cast<unsigned>(io) < static_cast<unsigned>(rows)) {
          const int n = pseq + io;
          if (n - room >= out_cap) room = wait_for(out_freed, n - out_cap + 1, remote_out);
          const bool last = t == kLanes - 1;
          store2_if(last, out_ring + (n & (out_cap - 1)) * 8, make_int2(eo, h[kCols - 1]),
                    remote_out);
          if (((io + 1) & (pub - 1)) == 0 || io == rows - 1) {
            release_if(last, out_filled, n + 1, remote_out);
          }
        }
        diag = hl;
        e = __shfl_up_sync(kAll, eo, 1);
        hl = __shfl_up_sync(kAll, h[kCols - 1], 1);
        if (t == 0 && st + 1 < rows) {
          e = le.x;
          hl = le.y;
        }
      };
      const std::false_type even{};
      const std::true_type odd{};

      // rows + 31 steps in pairs, the first 32 and those past the last
      // whole pair of rows guarded (a guarded step past the end changes
      // nothing)
      const int steps = rows + kLanes - 1;
      int st = 0;
      for (; st < kLanes; st += 2) {
        step(st, true, even);
        step(st + 1, true, odd);
      }
      for (; st + 1 < rows; st += 2) {
        step(st, false, even);
        step(st + 1, false, odd);
      }
      for (; st < steps; st += 2) {
        step(st, true, even);
        step(st + 1, true, odd);
      }

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

  // the cluster's maximum: each block's in rank 0's slot cred[rank]
  if (MODE != NW) {
    int v = MODE == SW ? best : acc;
    v = __reduce_max_sync(kAll, v);
    if (t == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < warps; ++w) v = max(v, red[w]);
      store1(map_rank(smem_u32(cred + rank), 0), v);
    }
  }
  __syncwarp();
  // no block leaves while another may still write its shared memory
  cluster_sync();
  if (MODE != NW && rank == 0 && threadIdx.x == 0) {
    const volatile int* c = cred;
    int v = c[0];
    for (int b = 1; b < cl; ++b) v = max(v, c[b]);
    out[gb] = MODE == OV ? max(v, 0) : v;
  }
}

template <int MODE>
int launch_long(const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
                const int8_t* targets, const int32_t* lens, const int32_t* matrix32, int G,
                int B, int N, int go, int ge, int warps, int cl, int2* scratch, int32_t* out,
                cudaStream_t st) {
  const size_t smem = smem_bytes(warps, strips_of(N) > warps * cl);
  auto kernel = cl > 1 ? sw_long_kernel<MODE, true> : sw_long_kernel<MODE, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cl, G);
  cfg.blockDim = dim3(warps * kLanes);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q_all, qm, q_off, q_len, targets, lens, matrix32, B, N,
                           go, ge, cl, scratch, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace sift4g

// Bytes of device scratch a launch needs: with strips in turn (more strips
// of 512 columns than the cluster's warps), the (H, F) row of every strip
// column and one corner H per strip; 0 otherwise.
extern "C" long long sift4g_sw_long_scratch_bytes(int G, int B, int N, int warps, int cluster) {
  using namespace sift4g;
  const long long strips = strips_of(N);
  if (strips <= static_cast<long long>(warps) * cluster) return 0;
  return static_cast<long long>(G) * B * strips * (kStrip * 8 + 4);
}

// C entry for ctypes.  One cluster of `cluster` blocks (1 to 8) a target,
// `warps` warps a block (1 to 16).  Launches on `stream`; neither
// synchronises nor allocates; returns the launch's error or
// cudaGetLastError() (cudaErrorInvalidValue for a request the kernel does
// not take; a cluster the card cannot place is refused, never shrunk).
extern "C" int sift4g_sw_grouped_long(
    const int32_t* q_all, int qm, const int32_t* q_off, const int32_t* q_len,
    const int8_t* targets, const int32_t* lens, const int32_t* matrix32, int G, int B, int N,
    int mode, int go, int ge, int warps, int cluster, void* scratch, int32_t* out,
    void* stream) {
  using namespace sift4g;
  if (G == 0 || B == 0) return 0;
  if (G > 65535 || N <= 0 || N % 16 || warps < 1 || warps > kMaxWarps || cluster < 1 ||
      cluster > kMaxCluster || go < 0 || ge < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (strips_of(N) > warps * cluster && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* scr = static_cast<int2*>(scratch);
  switch (mode) {
    case SW: return launch_long<SW>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, cluster, scr, out, st);
    case NW: return launch_long<NW>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, cluster, scr, out, st);
    case HW: return launch_long<HW>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, cluster, scr, out, st);
    case OV: return launch_long<OV>(q_all, qm, q_off, q_len, targets, lens, matrix32, G, B, N,
                                    go, ge, warps, cluster, scr, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

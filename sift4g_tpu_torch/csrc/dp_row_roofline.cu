// K5: the Smith-Waterman row-engine probe, the recurrence K1 runs without
// K1's loads.
//
// Replaces sift4g_tpu/align/roofline.py:44 (kern of dp_row_roofline,
// pallas_call at :88).  Each of B rows runs the same M-row local
// alignment recurrence over N columns.  Column j of query row i scores
// s0[j] = j % 11 - 4 + salt when j + i is even, else
// s1[j] = (j + 5) % 13 - 6 - salt; the top row has H = 0 and F = -10^7,
// the left column H = 0.  The result is each row's best cell, (B,) int32,
// bit-identical to the Pallas kernel (and to the plain PyTorch version
// in sift4g_tpu_torch/align/roofline.py).  Cell for cell, in the serial
// form K1 runs (csrc/sw_tiled.cuh):
//   F = max(H_up - go, F_up - ge)
//   G = max(diag + s, F, 0)
//   E = max(E_left - ge, G_left - go)     (E of column 0: -go)
//   H = max(G, E)
//   best = max(best, H)                   (two cells at a time, as K1)
// E comes from G, not H, so the result is exact for any go, ge >= 0,
// go < ge included.
//
// Design: the columns live in registers and the query rows stream
// through them.  A group of T lanes of one warp (T = 1, 2, ..., 32, from
// roofline.dp_row_geometry) scores one row b; lane t holds the kCols = 16
// columns [16 t, 16 t + 16) of a strip of W = 16 T columns: their H and
// F, and their two column scores, one per parity of the step, computed
// once (no % and no shared-memory load in the loop).  The group runs a
// wavefront: at step s lane t computes query row s - t over its columns,
// and receives from lane t - 1 (__shfl_up_sync of width T) the E entering
// its first column and lane t - 1's last-column H of that row, which is
// its diagonal one row later: two shuffles per 16 cells.  Lane 0 takes the
// left boundary.  A lane whose row lies outside [0, M) changes no state
// (the first and last T - 1 steps, rounded to whole pairs, are guarded;
// the steps between run unguarded; every loop is unrolled by 2 so the
// parity picks a score register at compile time).  Columns past N score 0: their H never passes the best
// real cell of the rows so far (F <= H_up, E <= H_left, and a diagonal
// plus 0 is an earlier cell), so `best` takes them unmasked.  Every row b
// is computed by its own lanes; the lanes' bests meet in one
// __reduce_max_sync (a shuffle tree when T < 32) and one store.
//
// N > W (T = 32, up to MAX_DP_ROW_N): the strips of one row run in turn
// on the same warp, over row tiles of kRowTile rows, so no buffer grows
// with M.  Per tile and strip, the last lane writes each row's (E
// entering the next strip, last-column H) into shared memory (two
// kRowTile buffers per warp, alternating by strip), where the next
// strip's lane 0 reads it; the strip's bottom (H, F) row goes to a device
// scratch of B x strips x W int2 between tiles ([b][strip][k][lane], a
// warp's lanes side by side), and the corner H above-left of a strip on
// a tile's first row is taken from that bottom row by a shuffle.
//
// What bounds it on the card: operations.  At N <= W the kernel touches
// no device memory but its (B,) output: 0 bytes per cell.  At N > W the
// scratch costs 16 bytes per column per tile, 16 / kRowTile = 0.03 bytes
// per cell.  The steady loop issues 7.5 int32 instructions a cell on
// sm_90a (3 fused VIADDMNMX, 2 VIMNMX, 2 VIADD, and a share of the two
// shuffles, the selects and the loop per 16 cells; chip_smoke.py prints
// them).  The max-family ones bound it, at 64 a clock per SM (the VIADDs
// issue beside them): it issues 5 a cell where 4.5 would do (a VIMNMX3
// taking the best of two cells), and the wavefront adds T - 1 idle steps
// per strip and tile.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace sift4g {
namespace {

constexpr int kCols = 16;        // columns a lane
constexpr int kRowTile = 512;    // rows a tile when a row takes several strips
constexpr int kMaxBlock = 128;
constexpr int kNegL = -10000000; // roofline.py NEGL: F on the top row
constexpr unsigned kAll = 0xffffffffu;

struct Lane {
  int h[kCols], f[kCols];  // H and F of the last row the lane computed
  int sa[kCols], sb[kCols];  // the column scores at even and at odd steps
  int diag;  // H above-left of column 0 on the lane's next row
  int e;     // E entering column 0 on the lane's next row
  int hl;    // H left of column 0 on the lane's next row
  int best;
};

// One query row over the lane's columns; returns the E entering the
// next lane's first column.
__device__ __forceinline__ int cells(Lane& L, const int (&sc)[kCols], int go, int ge) {
  int d = L.diag, e = L.e, gl = 0, hp = 0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (k > 0) e = max(e - ge, gl - go);
    const int f = max(L.h[k] - go, L.f[k] - ge);
    const int g = max(max(d + sc[k], f), 0);
    const int h = max(g, e);
    d = L.h[k];
    L.h[k] = h;
    L.f[k] = f;
    gl = g;
    if (k & 1) L.best = max(L.best, max(hp, h));
    hp = h;
  }
  return max(e - ge, gl - go);
}

// Step s of the wavefront: lane t computes row s - t (kGuard: only when
// it lies in [0, rows)), then the lanes pass their edges one lane right.
// kWide: lane 0 reads its left edge from `ein` (strip > 0) and the last
// lane writes its right edge to `eout` (when `right`).
template <bool kGuard, bool kOdd, bool kWide>
__device__ __forceinline__ void step(Lane& L, int s, int t, int T, int rows, int go, int ge,
                                     const int2* ein, int2* eout, bool left, bool right) {
  const int i = s - t;
  int eo = 0;
  if (!kGuard || static_cast<unsigned>(i) < static_cast<unsigned>(rows)) {
    eo = cells(L, kOdd ? L.sb : L.sa, go, ge);
    if (kWide && right && t == T - 1) eout[i] = make_int2(eo, L.h[kCols - 1]);
  }
  L.diag = L.hl;
  L.e = __shfl_up_sync(kAll, eo, 1, T);
  L.hl = __shfl_up_sync(kAll, L.h[kCols - 1], 1, T);
  if (t == 0) {
    if (kWide && left) {
      const int2 v = ein[min(s + 1, kRowTile - 1)];
      L.e = v.x;
      L.hl = v.y;
    } else {
      L.e = -go;
      L.hl = 0;
    }
  }
}

// The wavefront over `rows` rows of one strip: M + T - 1 steps, the first
// and last T - 1 guarded.  Extra guarded steps past the end change
// nothing, so the loops run whole pairs.
template <bool kWide>
__device__ __forceinline__ void sweep(Lane& L, int t, int T, int rows, int go, int ge,
                                      const int2* ein, int2* eout, bool left, bool right) {
  const int steps = rows + T - 1;
  const int lead = T & ~1;  // even, >= T - 1: every lane has started after it
  int s = 0;
  for (; s < lead; s += 2) {
    step<true, false, kWide>(L, s, t, T, rows, go, ge, ein, eout, left, right);
    step<true, true, kWide>(L, s + 1, t, T, rows, go, ge, ein, eout, left, right);
  }
  for (; s + 1 < rows; s += 2) {
    step<false, false, kWide>(L, s, t, T, rows, go, ge, ein, eout, left, right);
    step<false, true, kWide>(L, s + 1, t, T, rows, go, ge, ein, eout, left, right);
  }
  for (; s < steps; s += 2) {
    step<true, false, kWide>(L, s, t, T, rows, go, ge, ein, eout, left, right);
    step<true, true, kWide>(L, s + 1, t, T, rows, go, ge, ein, eout, left, right);
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kMaxBlock) dp_row_probe_kernel(
    int B, int N, int M, int salt, int go, int ge, int T, int strips,
    int2* __restrict__ scratch, int32_t* __restrict__ out) {
  // kWide: per warp, two kRowTile buffers of (E, H) at a strip's right edge
  extern __shared__ int2 edges[];
  const int lane = threadIdx.x & 31;
  const int t = lane & (T - 1);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((tid - lane) / T >= B) return;  // the whole warp lies past the last row
  const long long b = tid / T;
  const int W = T * kCols;
  int2* const edge = edges + (threadIdx.x >> 5) * 2 * kRowTile;

  Lane L;
  L.best = 0;
  const int tiles = kWide ? (M + kRowTile - 1) / kRowTile : 1;
  for (int tile = 0; tile < tiles; ++tile) {
    const int r0 = tile * kRowTile;
    const int rows = kWide ? min(kRowTile, M - r0) : M;
    int corner = 0;  // H above-left of the strip on the tile's first row
    for (int strip = 0; strip < (kWide ? strips : 1); ++strip) {
      const int c0 = strip * W + t * kCols;
      // parity of row + column at even steps, column c0
      const int p = (r0 - t + c0) & 1;
      int2* const hf = kWide ? scratch + ((b * strips + strip) * kCols) * 32 + lane : nullptr;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = c0 + k;
        const int s0 = j < N ? j % 11 - 4 + salt : 0;
        const int s1 = j < N ? (j + 5) % 13 - 6 - salt : 0;
        L.sa[k] = ((p + k) & 1) ? s1 : s0;
        L.sb[k] = ((p + k) & 1) ? s0 : s1;
        if (kWide && tile > 0) {
          const int2 v = hf[k * 32];
          L.h[k] = v.x;
          L.f[k] = v.y;
        } else {
          L.h[k] = 0;
          L.f[k] = kNegL;
        }
      }
      const int corner_next = __shfl_sync(kAll, L.h[kCols - 1], T - 1, T);
      const bool left = kWide && strip > 0;
      const bool right = kWide && strip + 1 < strips;
      const int2* ein = edge + ((strip + 1) & 1) * kRowTile;
      int2* eout = edge + (strip & 1) * kRowTile;
      // the edges of the first step, as step() passes them on
      L.diag = t == 0 ? corner : 0;
      L.e = -go;
      L.hl = __shfl_up_sync(kAll, L.h[kCols - 1], 1, T);
      if (t == 0) {
        if (left) {
          const int2 v = ein[0];
          L.e = v.x;
          L.hl = v.y;
        } else {
          L.hl = 0;
        }
      }
      sweep<kWide>(L, t, T, rows, go, ge, ein, eout, left, right);
      if (kWide) {
        if (tile + 1 < tiles) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) hf[k * 32] = make_int2(L.h[k], L.f[k]);
        }
        corner = corner_next;
        __syncwarp();
      }
    }
  }
  int best = L.best;
  if (T == 32) {
    best = __reduce_max_sync(kAll, best);
  } else {
    for (int o = T >> 1; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(kAll, best, o, T));
  }
  if (t == 0 && b < B) out[b] = best;
}

}  // namespace
}  // namespace sift4g

// Bytes of device scratch a launch of B rows in `strips` strips needs
// (the layout above, at T = 32): 0 for one strip.
extern "C" long long sift4g_dp_row_scratch_bytes(int B, int strips) {
  return strips > 1 ? static_cast<long long>(B) * strips * sift4g::kCols * 32 * sizeof(int2) : 0;
}

// C entry for ctypes.  Launches on `stream`; neither synchronises nor
// allocates.  T is the lanes a row (a power of two <= 32), `strips` the
// strips of 16 T columns that cover N (roofline.dp_row_geometry), `block`
// the threads a block (a multiple of 32, <= 128); several strips need
// T = 32 and sift4g_dp_row_scratch_bytes of `scratch`.  Returns
// cudaGetLastError().
extern "C" int sift4g_dp_row_probe(int B, int N, int M, int salt, int go, int ge, int T,
                                   int strips, int block, void* scratch, int32_t* out,
                                   void* stream) {
  using namespace sift4g;
  if (B <= 0 || N <= 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (T < 1 || T > 32 || (T & (T - 1)) || block < 32 || block > kMaxBlock || block % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long W = static_cast<long long>(T) * kCols;
  if (strips < 1 || (strips - 1) * W >= N || strips * W < N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (strips > 1 && (T != 32 || scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(B) * T + block - 1) / block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strips == 1) {
    dp_row_probe_kernel<false><<<static_cast<int>(blocks), block, 0, st>>>(
        B, N, M, salt, go, ge, T, 1, nullptr, out);
  } else {
    const size_t smem = static_cast<size_t>(block / 32) * 2 * kRowTile * sizeof(int2);
    dp_row_probe_kernel<true><<<static_cast<int>(blocks), block, smem, st>>>(
        B, N, M, salt, go, ge, T, strips, static_cast<int2*>(scratch), out);
  }
  return static_cast<int>(cudaGetLastError());
}

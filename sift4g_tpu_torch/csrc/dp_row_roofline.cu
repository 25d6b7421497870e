// K5: the Smith-Waterman row-engine probe, the bench's ceiling for K1.
//
// Replaces sift4g_tpu/align/roofline.py:44 (kern of dp_row_roofline,
// pallas_call at :88).  Each of B rows runs the same M-row local
// alignment recurrence over N columns.  Column j of query row i scores
// s0[j] = j % 11 - 4 + salt when j + i is even, else
// s1[j] = (j + 5) % 13 - 6 - salt; the top row has H = 0 and F = -10^7,
// the left column H = 0.  The result is each row's best cell, (B,) int32,
// bit-identical to the Pallas kernel (and to the plain PyTorch version
// in sift4g_tpu_torch/align/roofline.py).
//
// Design: K1's inner loop (sw_grouped.cuh) with its matrix lookup
// replaced by a table, so that the bench's roofline_pct says how close K1
// is to its own inner loop.  One thread per row b; plain serial Gotoh
// along the row (E_0 = -go, E_j = max(E_{j-1} - ge, G_{j-1} - go), the
// exact serial form of the Pallas kernel's decayed-prefix max); H and F
// of the previous row in a device-memory int2 scratch laid out [j][b] as
// K1 lays out [g][j][b]; the columns in runs of 16, unrolled as K1 walks
// its 16-byte target words.  The two column-score rows, one per parity
// of the query row, are built once per block into shared memory, so a
// cell does one shared load, as K1 does for its matrix row, and no %.
// The row count and the salt are runtime arguments.  Every row is
// computed by its own thread: the rows are identical by construction,
// and the kernel does not use that.
//
// What bounds it on the card: as K1, each cell loads and stores its H/F
// pair, 16 bytes of scratch traffic.  At the bench's B = 65,536 rows the
// scratch is 268 MB, past the 50 MB L2, so the probe is bound by device
// memory (16 B/cell at 3.35 TB/s is about 209 G cells/s), as K1 is at
// the bench launch.  At the JAX default B = 1024 the 4 MB scratch sits in
// L2 but only 8 blocks of 128 threads run, on 8 of the 132 SMs: that
// rate measures one SM's latency-bound row engine, not the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sift4g {
namespace {

constexpr int kThreads = 128;
constexpr int kNegL = -10000000;   // roofline.py NEGL: F on the top row
constexpr int kNeg = -(1 << 28);   // G left of column 0

__global__ void __launch_bounds__(kThreads) dp_row_probe_kernel(
    int B, int N, int M, int salt, int go, int ge,
    int2* __restrict__ scratch, int32_t* __restrict__ out) {
  // stab[r * N + j]: the score of column j in a query row of parity r
  extern __shared__ int32_t stab[];
  for (int k = threadIdx.x; k < 2 * N; k += blockDim.x) {
    const int r = k >= N;
    const int j = k - r * N;
    stab[k] = ((j + r) & 1) ? (j + 5) % 13 - 6 - salt : j % 11 - 4 + salt;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int2* hf = scratch + b;  // hf[j * B] = (H, F) of the previous row
  for (int j = 0; j < N; ++j) hf[(size_t)j * B] = make_int2(0, kNegL);

  int best = 0;
  for (int i = 0; i < M; ++i) {
    const int32_t* srow = stab + (i & 1) * N;
    int diag = 0;        // H[i, 0]: the left column
    int e = -go + ge;    // so that max(e - ge, gprev - go) gives E_0 = -go
    int gprev = kNeg;
    for (int jc = 0; jc < N; jc += 16) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = jc + k;
        if (j < N) {
          int2* cell = hf + (size_t)j * B;
          const int2 up = *cell;
          const int f = max(up.x - go, up.y - ge);
          const int g = max(max(diag + srow[j], f), 0);
          e = max(e - ge, gprev - go);
          const int h = max(g, e);
          *cell = make_int2(h, f);
          diag = up.x;
          gprev = g;
          best = max(best, h);
        }
      }
    }
  }
  out[b] = best;
}

}  // namespace
}  // namespace sift4g

// C entry for ctypes.  Launches on `stream`; neither synchronises nor
// allocates (scratch holds N * B int2); returns cudaGetLastError().
extern "C" int sift4g_dp_row_probe(int B, int N, int M, int salt, int go,
                                   int ge, void* scratch, int32_t* out,
                                   void* stream) {
  if (B <= 0 || N <= 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(int32_t) * (size_t)N;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + sift4g::kThreads - 1) / sift4g::kThreads);
  sift4g::dp_row_probe_kernel<<<grid, sift4g::kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      B, N, M, salt, go, ge, static_cast<int2*>(scratch), out);
  return static_cast<int>(cudaGetLastError());
}

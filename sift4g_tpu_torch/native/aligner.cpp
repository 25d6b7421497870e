// Native batch aligner: affine-gap DP with full traceback (SW/NW/HW/OV).
//
// Produces the edit paths for the <= max_alignments E-value survivors per
// query — the role swsharp's reconstruct/traceback plays after its scoring
// kernels (the TPU Pallas/XLA kernels here are score-only; paths for the
// few hundred kept pairs are cheapest on host).  Semantics are a line-for-
// line mirror of the Python oracle align_pair (align/dp_numpy.py):
// SW#-style affine gaps (gap of length L costs open + (L-1)*extend), the
// same mode boundary conditions, and the same deterministic traceback tie
// order DIAG > LEFT(E) > UP(F).
//
// Move encoding matches align/records.py: 0 = DIAG, 1 = LEFT (gap in
// query, consumes target), 2 = UP (gap in target, consumes query).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include "sw_simd.h"

namespace {

constexpr int32_t NEG = INT32_MIN / 4;
// An int16 striped fill whose every H stays below this is exact
// (sift4g_align_batch gives the argument).
constexpr int32_t kInt16Limit = 30000;

enum Mode { SW = 0, NW = 1, HW = 2, OV = 3 };

struct AlignResult {
  int32_t score;
  int32_t query_start, query_end;    // end inclusive
  int32_t target_start, target_end;  // end inclusive
  std::vector<uint8_t> moves;
};

struct DpBuffers {
  std::vector<int32_t> H;      // the ONLY stored matrix (scalar path)
  std::vector<int32_t> Frow;   // rolling F row for the fill
  std::vector<int32_t> e_row;  // lazily rebuilt E row (traceback)
  std::vector<int32_t> f_col;  // lazily rebuilt F column (traceback)
  std::vector<uint8_t> trace;  // striped trace bytes (SIMD path)
  sift4g_simd::Striped16Buffers sbuf;
};

// The scalar path's answers to the walk's tests, from the stored int32 H.
// E and F are rebuilt lazily: E(i, .) is one left-to-right pass over H row
// i, F(., j) one top-down pass over H column j — the fill's own recurrence
// replayed on the final (write-once) H values, so every compared value is
// bit-identical to a stored-matrix version.  A row/column is rebuilt at
// most once per visit (cached).
struct ScalarCells {
  const int32_t* H;
  int w, m, n;
  const uint8_t* q;
  const uint8_t* t;
  const int32_t* mat;
  int go, ge;
  std::vector<int32_t>& e_row;
  std::vector<int32_t>& f_col;
  int e_valid = -1, f_valid = -1;

  int32_t h(int a, int b) const { return H[static_cast<size_t>(a) * w + b]; }
  int32_t E(int a, int b) {
    if (e_valid != a) {
      int32_t e = NEG;
      for (int jj = 1; jj <= n; ++jj) {
        e = std::max(h(a, jj - 1) - go, e - ge);
        e_row[jj] = e;
      }
      e_valid = a;
    }
    return e_row[b];
  }
  int32_t F(int a, int b) {
    if (f_valid != b) {
      int32_t f = NEG;
      for (int ii = 1; ii <= m; ++ii) {
        f = std::max(h(ii - 1, b) - go, f - ge);
        f_col[ii] = f;
      }
      f_valid = b;
    }
    return f_col[a];
  }
  bool zero(int i, int j) const { return h(i, j) == 0; }
  bool diag(int i, int j) const {
    return h(i, j) == h(i - 1, j - 1) + mat[q[i - 1] * 26 + t[j - 1]];
  }
  bool e_open(int i, int j) { return h(i, j) == E(i, j); }
  bool f_open(int i, int j) { return h(i, j) == F(i, j); }
  bool e_ext(int i, int j) { return E(i, j) == E(i, j - 1) - ge; }
  bool f_ext(int i, int j) { return F(i, j) == F(i - 1, j) - ge; }
};

// The striped path's answers, read from the fill's trace bytes
// (sw_striped16_trace, de-striped on access).  In SW a cell with H > 0
// where neither the diagonal nor E gives H takes it from F, so f_open
// needs no bit.
struct TraceCells {
  const uint8_t* trace;
  int seg_len;

  uint8_t at(int i, int j) const {
    const int p = i - 1;
    return trace[static_cast<size_t>(j - 1) * seg_len * 16 +
                 static_cast<size_t>(p % seg_len) * 16 + p / seg_len];
  }
  bool zero(int i, int j) const { return at(i, j) & sift4g_simd::kTraceZero; }
  bool diag(int i, int j) const { return at(i, j) & sift4g_simd::kTraceDiag; }
  bool e_open(int i, int j) const { return at(i, j) & sift4g_simd::kTraceE; }
  bool f_open(int, int) const { return true; }
  bool e_ext(int i, int j) const { return at(i, j) & sift4g_simd::kTraceEExt; }
  bool f_ext(int i, int j) const { return at(i, j) & sift4g_simd::kTraceFExt; }
};

// Traceback from (ei, ej), generic over the cell tests (ScalarCells or
// TraceCells).  Tie order DIAG > E > F, identical to dp_numpy.py
// align_pair.  e_ext(i, j) is E(i, j) == E(i, j - 1) - ge, asked of the
// cell a LEFT move leaves; f_ext(i, j) likewise of the cell an UP move
// leaves.
template <class Cells>
void traceback_from(Cells& c, int ei, int ej, int mode, int32_t score,
                    AlignResult* out) {
  const bool local = mode == SW;
  std::vector<uint8_t>& moves = out->moves;
  moves.clear();
  int i = ei, j = ej;
  int state = 0;  // 0 = H, 1 = E, 2 = F
  for (;;) {
    if (state == 0) {
      if (i == 0 || j == 0) break;
      if (local && c.zero(i, j)) break;
      if (c.diag(i, j)) {
        moves.push_back(0);
        --i; --j;
      } else if (c.e_open(i, j)) {
        state = 1;
      } else if (c.f_open(i, j)) {
        state = 2;
      } else {
        break;  // boundary-derived (free end gaps)
      }
    } else if (state == 1) {
      moves.push_back(1);
      --j;
      state = (j > 0 && c.e_ext(i, j + 1)) ? 1 : 0;
    } else {
      moves.push_back(2);
      --i;
      state = (i > 0 && c.f_ext(i + 1, j)) ? 2 : 0;
    }
  }
  std::reverse(moves.begin(), moves.end());
  if (mode == NW) {
    // python order: UP-gaps prepended first, then LEFT-gaps prepended
    // before them -> final prefix is LEFT^j then UP^i
    std::vector<uint8_t> prefix;
    for (int x = 0; x < j; ++x) prefix.push_back(1);
    for (int x = 0; x < i; ++x) prefix.push_back(2);
    moves.insert(moves.begin(), prefix.begin(), prefix.end());
    i = 0;
    j = 0;
  } else if (mode == HW) {
    moves.insert(moves.begin(), static_cast<size_t>(i), 2);
    i = 0;
  }
  out->score = score;
  out->query_start = i;
  out->query_end = ei - 1;
  out->target_start = j;
  out->target_end = ej - 1;
}

void align_one(const uint8_t* q, int m, const uint8_t* t, int n,
               const int32_t* mat /* 26x26 */, int go, int ge, int mode,
               AlignResult* out, DpBuffers* buf) {
  const int w = n + 1;
  const size_t cells = static_cast<size_t>(m + 1) * w;
  // Only H is materialized: E and F are single-row/column recurrences in
  // their own axis (E(i,j) depends only on H[i][<j]; F(i,j) only on
  // H[<i][j]), so the traceback rebuilds the one row/column it walks
  // instead of storing full matrices — 3x less memory and no full-matrix
  // NEG pre-fill (the old assign() wrote 36 bytes/cell before the DP even
  // started).  Values and tie order are bit-identical to the stored-E/F
  // version (property-tested vs the oracle, moves included).
  std::vector<int32_t>& H = buf->H;
  H.resize(cells);
  std::vector<int32_t>& Frow = buf->Frow;
  Frow.assign(w, NEG);

  H[0] = 0;
  for (int j = 1; j <= n; ++j)
    H[j] = (mode == NW) ? -(go + (j - 1) * ge) : 0;
  for (int i = 1; i <= m; ++i)
    H[static_cast<size_t>(i) * w] =
        (mode == NW || mode == HW) ? -(go + (i - 1) * ge) : 0;

  const bool local = mode == SW;
  for (int i = 1; i <= m; ++i) {
    int32_t* Hi = H.data() + static_cast<size_t>(i) * w;
    int32_t* Hp = H.data() + static_cast<size_t>(i - 1) * w;
    const int32_t* srow = mat + static_cast<size_t>(q[i - 1]) * 26;
    int32_t e = NEG;
    int32_t diag = Hp[0];
    for (int j = 1; j <= n; ++j) {
      int32_t f = std::max(Hp[j] - go, Frow[j] - ge);
      Frow[j] = f;
      int32_t g = std::max(diag + srow[t[j - 1]], f);
      diag = Hp[j];
      if (local) g = std::max(g, 0);
      e = std::max(Hi[j - 1] - go, e - ge);
      Hi[j] = std::max(g, e);
    }
  }

  // endpoint
  int ei, ej;
  int32_t score;
  if (mode == NW) {
    ei = m; ej = n; score = H[static_cast<size_t>(m) * w + n];
  } else if (mode == SW) {
    size_t best = 0;
    for (size_t x = 1; x < H.size(); ++x)
      if (H[x] > H[best]) best = x;  // first max wins (argmax semantics)
    ei = static_cast<int>(best / w);
    ej = static_cast<int>(best % w);
    score = H[best];
  } else if (mode == HW) {
    ei = m; ej = 0;
    const int32_t* Hm = H.data() + static_cast<size_t>(m) * w;
    for (int j = 1; j <= n; ++j)
      if (Hm[j] > Hm[ej]) ej = j;
    score = Hm[ej];
  } else {  // OV
    int bj = 0;
    const int32_t* Hm = H.data() + static_cast<size_t>(m) * w;
    for (int j = 1; j <= n; ++j)
      if (Hm[j] > Hm[bj]) bj = j;
    int bi = 0;
    for (int i = 1; i <= m; ++i)
      if (H[static_cast<size_t>(i) * w + n] > H[static_cast<size_t>(bi) * w + n]) bi = i;
    if (Hm[bj] >= H[static_cast<size_t>(bi) * w + n]) {
      ei = m; ej = bj; score = Hm[bj];
    } else {
      ei = bi; ej = n; score = H[static_cast<size_t>(bi) * w + n];
    }
  }

  buf->e_row.resize(n + 1);
  buf->f_col.resize(m + 1);
  ScalarCells tests{H.data(), w, m, n, q, t, mat, go, ge, buf->e_row, buf->f_col};
  traceback_from(tests, ei, ej, mode, score, out);
}

// SW traceback via the striped AVX2 int16 fill (sw_simd.cpp), which
// writes one trace byte a cell and finds the endpoint; the walk reads the
// bytes.  Exact when every H the fill computes stays below kInt16Limit,
// which the fill's own best says (see sift4g_align_batch); returns false
// without touching *out otherwise, and the caller reruns the pair on the
// scalar path.  Moves are bit-identical to the scalar path (the same walk
// on the same tests of the same values) — property-tested in
// tests/test_torch_native_aligner.py.  *walk_s, when not null, gains the
// seconds after the fill.
bool align_one_striped(const sift4g_simd::Profile16& prof, const uint8_t* t,
                       int n, int go, int ge, AlignResult* out, DpBuffers* buf,
                       double* walk_s) {
  buf->trace.resize(static_cast<size_t>(n) * prof.seg_len * 16);
  int ei = 0, ej = 0;
  const int32_t best = sift4g_simd::sw_striped16_trace(
      prof, t, n, go, ge, &buf->sbuf, buf->trace.data(), &ei, &ej);
  if (best >= kInt16Limit) return false;
  std::chrono::steady_clock::time_point t0;
  if (walk_s != nullptr) t0 = std::chrono::steady_clock::now();
  TraceCells tests{buf->trace.data(), prof.seg_len};
  traceback_from(tests, ei, ej, SW, best, out);
  if (walk_s != nullptr)
    *walk_s += std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  return true;
}

// Score-only affine DP in linear memory (two rolling rows) — the honest
// CPU twin of the TPU scoring kernels (no traceback matrices, no O(mn)
// memory).  Same recurrences and mode boundaries as align_one / the
// Pallas kernels; bit-identical scores (property-tested).
int32_t score_one(const uint8_t* q, int m, const uint8_t* t, int n,
                  const int32_t* mat, int go, int ge, int mode,
                  std::vector<int32_t>* hbuf, std::vector<int32_t>* fbuf) {
  const bool local = mode == SW;
  const bool free_top = mode != NW;
  const bool free_left = mode == SW || mode == OV;
  std::vector<int32_t>& H = *hbuf;
  std::vector<int32_t>& F = *fbuf;
  H.assign(n + 1, 0);
  F.assign(n + 1, NEG);
  if (!free_top)
    for (int j = 1; j <= n; ++j) H[j] = -(go + (j - 1) * ge);
  int32_t best = local ? 0 : NEG;
  int32_t last_col_best = free_top ? 0 : NEG;  // OV: H[0][n] boundary is 0
  for (int i = 1; i <= m; ++i) {
    const int32_t* srow = mat + static_cast<size_t>(q[i - 1]) * 26;
    int32_t left = free_left ? 0 : -(go + (i - 1) * ge);
    int32_t diag = H[0];
    H[0] = left;
    int32_t e = NEG;
    for (int j = 1; j <= n; ++j) {
      int32_t f = std::max(H[j] - go, F[j] - ge);
      F[j] = f;
      int32_t g = std::max(diag + srow[t[j - 1]], f);
      if (local) g = std::max(g, 0);
      e = std::max(H[j - 1] - go, e - ge);
      int32_t h = std::max(g, e);
      diag = H[j];
      H[j] = h;
      if (local && h > best) best = h;
    }
    if (n > 0 && H[n] > last_col_best) last_col_best = H[n];
  }
  // the rolling row ends holding H[m][.], boundaries included
  if (mode == NW) return H[n];
  if (mode == SW) return best;
  // HW: best of the final row; OV: best of final row and last column
  int32_t row_best = NEG;
  for (int j = 0; j <= n; ++j) row_best = std::max(row_best, H[j]);
  if (mode == HW) return row_best;
  return std::max(std::max(row_best, last_col_best), 0);
}

}  // namespace

extern "C" {

// Score-only batch: one query vs n_targets addressed as (base + starts[i],
// lens[i]) — PackedTargets passes its arrays zero-copy, contiguous callers
// pass starts=offsets[:-1], lens=diff(offsets).  Linear memory per thread.
void sift4g_score_batch(const uint8_t* q, int32_t qlen, const uint8_t* base,
                        const int64_t* starts, const int32_t* lens,
                        int32_t n_targets, const int32_t* matrix26,
                        int32_t gap_open, int32_t gap_extend, int32_t mode,
                        int32_t n_threads, int32_t* out_score) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : (hw ? static_cast<int>(hw) : 4);
  nt = std::min<int>(nt, std::max<int32_t>(1, n_targets));
  // striped SIMD path (SW only): one shared read-only query profile, a
  // per-target int16 overflow guard (max attainable score is bounded by
  // min(m, n) * max|sub|), scalar fallback everywhere else
  int32_t matmax = 0;
  for (int x = 0; x < 26 * 26; ++x)
    matmax = std::max(matmax, std::abs(matrix26[x]));
  const bool striped_ok =
      mode == SW && qlen > 0 && sift4g_simd::have_avx2() &&
      gap_open < kInt16Limit && gap_extend < kInt16Limit &&
      std::getenv("SIFT4G_TPU_NO_SIMD") == nullptr;  // scalar A/B knob
  sift4g_simd::Profile16 prof;
  if (striped_ok) sift4g_simd::build_profile16(q, qlen, matrix26, &prof);
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    std::vector<int32_t> hbuf, fbuf;
    sift4g_simd::Striped16Buffers sbuf;
    for (;;) {
      int32_t idx = next.fetch_add(1);
      if (idx >= n_targets) return;
      const int32_t len = lens[idx];
      if (striped_ok && len > 0 &&
          static_cast<int64_t>(std::min<int32_t>(qlen, len)) * matmax <
              kInt16Limit) {
        out_score[idx] = sift4g_simd::sw_striped16(
            prof, base + starts[idx], len, gap_open, gap_extend, &sbuf);
      } else {
        out_score[idx] =
            score_one(q, qlen, base + starts[idx], len, matrix26,
                      gap_open, gap_extend, mode, &hbuf, &fbuf);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

// Align one query against n_targets targets (concatenated codes + offsets).
// Outputs: per-target score/starts/ends; edit paths concatenated into
// moves_buf (caller-sized to sum(m + n_i)) with moves_off (n_targets + 1).
// out_stats, when not null, receives ALIGN_STATS doubles: the cells (query
// length x target length) of the pairs the striped int16 path finished and
// of those the scalar int32 path took, the seconds the worker threads
// spent in each path (a steady_clock pair around each pair's fill and
// traceback, summed over the pairs), the threads used, the pairs whose
// striped fill saturated and were rerun on the scalar path (their cells
// and both attempts' seconds count as scalar), and the part of the striped
// seconds spent after the fill (the walk over the trace bytes).  Null
// reads no clock.
// Returns 0 on success, -1 if moves_buf would overflow.
enum AlignStat { STRIPED_CELLS, SCALAR_CELLS, STRIPED_THREAD_S, SCALAR_THREAD_S, THREADS,
                 SATURATED_PAIRS, WALK_THREAD_S, ALIGN_STATS };

int sift4g_align_batch(const uint8_t* q, int32_t qlen, const uint8_t* targets,
                       const int64_t* offsets, int32_t n_targets,
                       const int32_t* matrix26 /* 26x26 row-major */,
                       int32_t gap_open, int32_t gap_extend, int32_t mode,
                       int32_t n_threads, int32_t* out_score,
                       int32_t* out_qstart, int32_t* out_qend,
                       int32_t* out_tstart, int32_t* out_tend,
                       uint8_t* moves_buf, int64_t moves_cap,
                       int64_t* moves_off, double* out_stats) {
  std::vector<AlignResult> results(n_targets);
  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : (hw ? static_cast<int>(hw) : 4);
  nt = std::min<int>(nt, std::max<int32_t>(1, n_targets));

  // striped AVX2 traceback fill (SW only): one shared read-only query
  // profile; every pair tries it first and keeps its result only if the
  // fill's own best is below kInt16Limit.  Why that check suffices: the
  // profile holds each substitution exactly (|sub| < kInt16Limit, checked
  // here) and -30000 on pad rows.  H >= 0 after the local clamp, so
  // the diagonal add H + sub never clips downward.  E is max(prev - ge,
  // H - go) >= -go > -kInt16Limit, so a prev - ge that clips downward
  // loses to H - go, as its true value would; F+ >= 0 likewise, and a
  // carry decayed past int16 stays below it.  The only clip that can
  // alter a value is the diagonal add's upward one, to 32767, and that
  // value becomes an H.  The fill's best is the max of every final H (pad
  // lanes included), and no H it computes exceeds its cell's final H, so
  // best < kInt16Limit means no H clipped and every value is the int32
  // recurrence's.  The trace bits compare those values (the diagonal test
  // its unclipped sum; an extension test's clipped prev - ge is below
  // every E and F+, as its true value is), so each bit is the int32
  // recurrence's test, F+ standing for F where the walk reads it
  // (sw_striped16_trace).  A bound before the fill
  // (min(qlen, n) * max|sub|, as sift4g_score_batch keeps) would send
  // every long pair to the scalar path though few come near the limit.
  int32_t matmax = 0;
  for (int x = 0; x < 26 * 26; ++x)
    matmax = std::max(matmax, std::abs(matrix26[x]));
  // The trace fill's F scan also needs 0 < ge <= go, which every scorer
  // of the CLI holds.
  const bool striped_ok =
      mode == SW && qlen > 0 && sift4g_simd::have_avx2() &&
      matmax < kInt16Limit && gap_open < kInt16Limit &&
      0 < gap_extend && gap_extend <= gap_open &&
      std::getenv("SIFT4G_TPU_NO_SIMD") == nullptr;
  sift4g_simd::Profile16 prof;
  if (striped_ok) sift4g_simd::build_profile16(q, qlen, matrix26, &prof);

  std::atomic<int32_t> next{0};
  std::mutex stats_mu;
  if (out_stats != nullptr) {
    std::fill(out_stats, out_stats + ALIGN_STATS, 0.0);
    out_stats[THREADS] = nt;
  }
  auto worker = [&]() {
    DpBuffers buf;
    double mine[ALIGN_STATS] = {0.0};
    for (;;) {
      int32_t idx = next.fetch_add(1);
      if (idx >= n_targets) break;
      const uint8_t* t = targets + offsets[idx];
      int n = static_cast<int>(offsets[idx + 1] - offsets[idx]);
      std::chrono::steady_clock::time_point t0;
      if (out_stats != nullptr) t0 = std::chrono::steady_clock::now();
      const bool tried = striped_ok && n > 0;
      const bool striped =
          tried && align_one_striped(prof, t, n, gap_open, gap_extend, &results[idx], &buf,
                                     out_stats != nullptr ? &mine[WALK_THREAD_S] : nullptr);
      if (!striped)
        align_one(q, qlen, t, n, matrix26, gap_open, gap_extend, mode,
                  &results[idx], &buf);
      if (out_stats != nullptr) {
        const std::chrono::duration<double> dt = std::chrono::steady_clock::now() - t0;
        mine[striped ? STRIPED_CELLS : SCALAR_CELLS] += static_cast<double>(qlen) * n;
        mine[striped ? STRIPED_THREAD_S : SCALAR_THREAD_S] += dt.count();
        if (tried && !striped) mine[SATURATED_PAIRS] += 1.0;
      }
    }
    if (out_stats != nullptr) {
      std::lock_guard<std::mutex> hold(stats_mu);
      for (int k = 0; k < ALIGN_STATS; ++k)
        if (k != THREADS) out_stats[k] += mine[k];
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();

  int64_t w = 0;
  for (int32_t i = 0; i < n_targets; ++i) {
    const AlignResult& r = results[i];
    out_score[i] = r.score;
    out_qstart[i] = r.query_start;
    out_qend[i] = r.query_end;
    out_tstart[i] = r.target_start;
    out_tend[i] = r.target_end;
    moves_off[i] = w;
    if (w + static_cast<int64_t>(r.moves.size()) > moves_cap) return -1;
    memcpy(moves_buf + w, r.moves.data(), r.moves.size());
    w += static_cast<int64_t>(r.moves.size());
  }
  moves_off[n_targets] = w;
  return 0;
}

}  // extern "C"

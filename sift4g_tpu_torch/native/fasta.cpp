// Native streaming FASTA parser with residue-byte-budget parts.
//
// C-ABI engine behind io/fasta.py (ctypes).  Replaces the
// swsharp readFastaChainsPartInit/readFastaChainsPart capability the
// reference streams its database through (database_search.cpp:81-97,
// database_alignment.cpp:36-48), with identical part-boundary semantics to
// the Python fallback in io/fasta.py:
//   * name = first whitespace-delimited token after '>';
//   * sequence letters are upcased to codes 0..25, everything else dropped;
//   * a part ends immediately after the header line that exhausts the
//     residue budget — the new record opens the next part.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FastaCtx {
  FILE* fh = nullptr;
  std::string carry;          // unconsumed tail of the read buffer
  bool eof_file = false;      // underlying file exhausted
  bool finished = false;      // all records emitted
  bool have_pending = false;  // a record is open (header seen)
  std::string pending_name;
  std::vector<uint8_t> pending_codes;

  // current part results
  std::vector<uint8_t> codes;
  std::vector<int64_t> offsets{0};
  std::string names;
  std::vector<int64_t> name_offsets{0};
  int64_t part_residues = 0;

  std::vector<char> buf;
};

// letter -> code 0..25, 255 = drop
uint8_t kCodeMap[256];
struct CodeMapInit {
  CodeMapInit() {
    memset(kCodeMap, 255, sizeof(kCodeMap));
    for (int c = 'A'; c <= 'Z'; ++c) {
      kCodeMap[c] = static_cast<uint8_t>(c - 'A');
      kCodeMap[c + 32] = static_cast<uint8_t>(c - 'A');
    }
  }
} code_map_init;

void emit(FastaCtx* ctx) {
  ctx->codes.insert(ctx->codes.end(), ctx->pending_codes.begin(),
                    ctx->pending_codes.end());
  ctx->offsets.push_back(static_cast<int64_t>(ctx->codes.size()));
  ctx->names += ctx->pending_name;
  ctx->name_offsets.push_back(static_cast<int64_t>(ctx->names.size()));
  ctx->part_residues += static_cast<int64_t>(ctx->pending_codes.size());
  ctx->pending_codes.clear();
  ctx->pending_name.clear();
  ctx->have_pending = false;
}

// process one complete line [p, p+len); returns true if the part is full
bool handle_line(FastaCtx* ctx, const char* p, size_t len, int64_t budget) {
  // strip trailing CR / whitespace
  while (len && (p[len - 1] == '\r' || p[len - 1] == ' ' || p[len - 1] == '\t'))
    --len;
  size_t b = 0;
  while (b < len && (p[b] == ' ' || p[b] == '\t')) ++b;
  if (b == len) return false;
  if (p[b] == '>') {
    if (ctx->have_pending) emit(ctx);
    size_t s = b + 1;
    while (s < len && isspace(static_cast<unsigned char>(p[s]))) ++s;
    size_t e = s;
    while (e < len && !isspace(static_cast<unsigned char>(p[e]))) ++e;
    ctx->pending_name.assign(p + s, e - s);
    ctx->have_pending = true;
    return ctx->part_residues >= budget;
  }
  if (ctx->have_pending) {
    for (size_t j = b; j < len; ++j) {
      uint8_t c = kCodeMap[static_cast<unsigned char>(p[j])];
      if (c != 255) ctx->pending_codes.push_back(c);
    }
  }
  return false;
}

}  // namespace

extern "C" {

void* sift4g_fasta_open(const char* path) {
  FILE* fh = fopen(path, "rb");
  if (!fh) return nullptr;
  auto* ctx = new FastaCtx();
  ctx->fh = fh;
  ctx->buf.resize(4u << 20);
  return ctx;
}

// Parse until ~max_residues residues are buffered. Returns 1 if more data
// remains after this part, 0 if this part is the last (EOF reached).
int sift4g_fasta_read_part(void* handle, int64_t max_residues) {
  auto* ctx = static_cast<FastaCtx*>(handle);
  ctx->codes.clear();
  ctx->offsets.assign(1, 0);
  ctx->names.clear();
  ctx->name_offsets.assign(1, 0);
  ctx->part_residues = 0;
  if (ctx->finished) return 0;

  for (;;) {
    // consume complete lines from carry
    size_t start = 0;
    const char* data = ctx->carry.data();
    size_t n = ctx->carry.size();
    bool full = false;
    while (start < n) {
      const char* nl =
          static_cast<const char*>(memchr(data + start, '\n', n - start));
      if (!nl) {
        if (!ctx->eof_file) break;  // need more bytes for a complete line
        full = handle_line(ctx, data + start, n - start, max_residues);
        start = n;
        if (full) break;
        continue;
      }
      size_t len = static_cast<size_t>(nl - (data + start));
      full = handle_line(ctx, data + start, len, max_residues);
      start = static_cast<size_t>(nl - data) + 1;
      if (full) break;
    }
    ctx->carry.erase(0, start);

    if (full) return 1;
    if (ctx->eof_file) {
      if (ctx->have_pending) emit(ctx);
      ctx->finished = true;
      return 0;
    }
    size_t got = fread(ctx->buf.data(), 1, ctx->buf.size(), ctx->fh);
    if (got == 0)
      ctx->eof_file = true;
    else
      ctx->carry.append(ctx->buf.data(), got);
  }
}

int64_t sift4g_fasta_part_nseq(void* handle) {
  auto* ctx = static_cast<FastaCtx*>(handle);
  return static_cast<int64_t>(ctx->offsets.size()) - 1;
}

int64_t sift4g_fasta_part_residues(void* handle) {
  return static_cast<FastaCtx*>(handle)->part_residues;
}

int64_t sift4g_fasta_part_names_bytes(void* handle) {
  return static_cast<int64_t>(static_cast<FastaCtx*>(handle)->names.size());
}

void sift4g_fasta_part_fill(void* handle, uint8_t* codes, int64_t* offsets,
                            char* names, int64_t* name_offsets) {
  auto* ctx = static_cast<FastaCtx*>(handle);
  memcpy(codes, ctx->codes.data(), ctx->codes.size());
  memcpy(offsets, ctx->offsets.data(), ctx->offsets.size() * sizeof(int64_t));
  memcpy(names, ctx->names.data(), ctx->names.size());
  memcpy(name_offsets, ctx->name_offsets.data(),
         ctx->name_offsets.size() * sizeof(int64_t));
}

void sift4g_fasta_close(void* handle) {
  auto* ctx = static_cast<FastaCtx*>(handle);
  if (ctx->fh) fclose(ctx->fh);
  delete ctx;
}

}  // extern "C"

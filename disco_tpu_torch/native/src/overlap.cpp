// Native host overlap-relation kernel (OpenMP).
//
// Computes the same verified overlap/containment relation as the
// XLA/numpy path in disco_tpu/overlap/relation.py: for every read r1 and
// window j in [0, len1-k), look the window's (k)-mer key up in the sorted
// canonical fingerprint table and verify every bucket entry with 2-bit
// packed-word compares (the reference does this with byte-wise
// std::string::substr equality inside chained hash buckets,
// reference: src/BuildGraph/src/OverlapGraph.cpp:401-478,631-674,
// HashTable.cpp:521-571).
//
// Emission order is the relation's required order by construction:
// reads ascending, window j ascending, and within a bucket the table's
// (file-index, record-type) sort order.
//
// Single-pass protocol: reads are split into fixed contiguous blocks;
// threads claim blocks dynamically and append verified hits to the block's
// own buffer, so concatenating buffers in block order is bit-deterministic
// for any thread count (collect returns an opaque handle + total, export
// copies the columns out and frees).  A count+fill two-pass design would
// verify every candidate twice — verification IS the kernel's cost.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// word covering bases [off + 32*wi, +32) of a packed row (funnel shift over
// 32-bit words; mirrors disco_tpu/overlap/verify.py::_window_word).  The third word may step one
// past the row's zero-pad word for windows near the row end; clamping is
// safe because any bases it would contribute are masked off by the caller
// (they lie beyond the compared length).
static inline uint64_t window_word64(const uint32_t* row, int64_t off,
                                     int64_t wi, int64_t row_words) {
  const int64_t word_idx = off / 16 + 2 * wi;
  const uint32_t bit = 2u * static_cast<uint32_t>(off % 16);
  const uint64_t w0 = row[word_idx];
  const uint64_t w1 = row[word_idx + 1];
  const uint64_t hi = (w0 << 32) | w1;
  if (bit == 0) return hi;
  const int64_t i2 = (word_idx + 2 < row_words) ? word_idx + 2 : row_words - 1;
  const uint64_t w2 = row[i2];
  return (hi << bit) | (w2 >> (32u - bit));
}

// fwd-row window [o1, o1+n) == other-row window [o2, o2+n) ?
// (32 bases per iteration; verification is the kernel's largest cost)
static inline bool windows_equal(const uint32_t* row1, int64_t o1,
                                 const uint32_t* row2, int64_t o2,
                                 int64_t n, int64_t row_words) {
  for (int64_t wi = 0; n > 0; ++wi, n -= 32) {
    const uint64_t x = window_word64(row1, o1, wi, row_words);
    const uint64_t y = window_word64(row2, o2, wi, row_words);
    const uint64_t mask =
        (n >= 32) ? ~uint64_t(0)
                  : (~uint64_t(0) << (2u * (32u - (uint32_t)n)));
    if ((x ^ y) & mask) return false;
  }
  return true;
}

struct Table {
  const uint64_t* keys;
  const int32_t* read;
  const int8_t* orient;
  const int8_t* typ;
  int64_t m;
  // top-RBITS radix index narrowing the binary search range.  RBITS is
  // sized to ~4 buckets per entry so the index (uint32 slots) stays small
  // enough to live in the last-level cache — the per-window lookup is one
  // random load into this array, and with most windows being misses that
  // load dominates the kernel when the index spills to DRAM.
  int rbits = 16;
  int rshift = 48;
  std::vector<uint32_t> radix;

  void build_radix() {
    // radix slots are uint32 table positions
    if (m > int64_t(0xFFFFFFFF)) __builtin_trap();
    int b = 16;
    while (b < 24 && (int64_t(1) << b) < 4 * m) ++b;
    rbits = b;
    rshift = 64 - b;
    radix.assign((int64_t(1) << b) + 1, 0);
    int64_t pos = 0;
    for (int64_t p = 0; p <= (int64_t(1) << b); ++p) {
      while (pos < m && (keys[pos] >> rshift) < static_cast<uint64_t>(p))
        ++pos;
      radix[p] = static_cast<uint32_t>(pos);
    }
  }

};

// 12-byte packed hit: j fits int16 (the reference itself caps read length
// at 15 bits, src/BuildGraph/src/HashTable.cpp:437-448) and typ/cont/edge
// pack into one flags byte (bit0 edge, bit1 cont, bits 2-3 typ) — at
// metagenome scale the collected hit blocks are the single largest
// allocation of the build, so 16 -> 12 B/hit matters.
struct Hit {
  int32_t r1, r2;
  int16_t j;
  int8_t orient;
  uint8_t flags;
};

// (window, table-position) candidate pair, collected per chunk so
// verification loads can be prefetched a fixed distance ahead.  p is the
// full-width table position: the table can exceed 2^31 entries at
// metagenome scale (4 records/read), and the radix slots (uint32) already
// cap m at 2^32 — asserted in build_radix.
struct Cand {
  int64_t p;
  int32_t j;
};

struct Collected {
  std::vector<std::vector<Hit>> blocks;
};

constexpr int64_t kBlockReads = 2048;

}  // namespace

// mode: 0 = full relation (containment + edge checks, all reads);
//       1 = containment-only pass (edge check skipped);
//       2 = edge-only pass over UNCONTAINED reads: queries of contained
//           reads and candidates that are contained are skipped before
//           verification (the reference's superReadID==0 pruning,
//           src/BuildGraph/src/OverlapGraph.cpp:435-436,645) — `contained`
//           is a (n,) 0-based byte mask, required iff mode==2.
// Modes 1+2 together form the bounded-memory streaming path: the full
// relation is never materialized (pass 1 yields only cont rows; pass 2
// yields exactly the edge-eligible rows the traversal replay consumes).
static void* collect_impl(
    const uint32_t* packed, const uint32_t* packed_rc, const int32_t* lengths,
    int64_t n, int64_t row_words, const uint64_t* keys, const int32_t* tread,
    const int8_t* torient, const int8_t* ttyp, int64_t m, int64_t k,
    int64_t* total_out, int mode, const uint8_t* contained) {
  Table t;
  t.keys = keys;
  t.read = tread;
  t.orient = torient;
  t.typ = ttyp;
  t.m = m;
  t.build_radix();

  const int64_t kk = (k < 32) ? k : 32;
  const int64_t key_shift = 64 - 2 * kk;

  auto* col = new Collected();
  const int64_t n_blocks = (n + kBlockReads - 1) / kBlockReads;
  col->blocks.resize(static_cast<size_t>(n_blocks));

#if defined(ABLATE_STAGE) && ABLATE_STAGE < 3
  int64_t cand_total = 0;  // per-call; summed once after the parallel loop
#endif

#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t bi = 0; bi < n_blocks; ++bi) {
    std::vector<Hit>& out = col->blocks[bi];
    const int64_t r_end = ((bi + 1) * kBlockReads < n) ? (bi + 1) * kBlockReads
                                                       : n;
    // per-read window-code scratch; chunked so long reads stay bounded
    constexpr int64_t kWinChunk = 512;
    uint64_t qcodes[kWinChunk];
    uint32_t los[kWinChunk], his[kWinChunk];
    std::vector<Cand> cand;
    cand.reserve(4 * kWinChunk);
    for (int64_t r1 = bi * kBlockReads; r1 < r_end; ++r1) {
      if (mode == 2 && contained[r1]) continue;
      const uint32_t* row1 = packed + r1 * row_words;
      const int64_t len1 = lengths[r1];
      const int64_t n_win = len1 - k;
      for (int64_t jc = 0; jc < n_win; jc += kWinChunk) {
      const int64_t j_end = (jc + kWinChunk < n_win) ? jc + kWinChunk : n_win;
      // pass 1: compute the chunk's window codes and prefetch their radix
      // slots — the random load into the (tens-of-MB) radix index is the
      // dominant stall of this kernel; batching hides it
      for (int64_t j = jc; j < j_end; ++j) {
        // window code: first kk bases of window j, packed into the top bits
        const int64_t wbase = j / 16;
        const uint32_t phase = 2u * static_cast<uint32_t>(j % 16);
        const uint64_t w0 = row1[wbase];
        const uint64_t w1 = row1[wbase + 1];
        // row has a trailing zero word; wbase+2 may step past it for j near
        // the end of a max-length read, so clamp like the XLA path does
        const int64_t i2 = (wbase + 2 < row_words) ? wbase + 2 : row_words - 1;
        const uint64_t w2 = row1[i2];
        const uint64_t hi = (w0 << 32) | w1;
        const uint64_t win =
            (phase == 0) ? hi : (hi << phase) | (w2 >> (32u - phase));
        const uint64_t qcode = win >> key_shift;
        qcodes[j - jc] = qcode;
        __builtin_prefetch(&t.radix[qcode >> t.rshift], 0, 0);
      }
#if defined(ABLATE_STAGE) && ABLATE_STAGE < 2
      // ablation: consume qcodes so pass 1 isn't dead-code-eliminated
      uint64_t sinkv = 0;
      for (int64_t j = jc; j < j_end; ++j) sinkv ^= qcodes[j - jc];
      if (sinkv == 0xdeadbeefcafef00dULL)
        out.push_back(Hit{0, 0, 0, 0, 0});
      continue;
#endif
      // pass 2a: radix-range fetch + key-line prefetch.  The binary search's
      // key loads are dependent random DRAM hits on ~25% of windows; batching
      // the range fetch first lets the key lines stream in while the rest of
      // the chunk's ranges are read.
      for (int64_t j = jc; j < j_end; ++j) {
        const int64_t p = static_cast<int64_t>(qcodes[j - jc] >> t.rshift);
        const uint32_t lo = t.radix[p], hi = t.radix[p + 1];
        los[j - jc] = lo;
        his[j - jc] = hi;
        if (lo != hi) {
          __builtin_prefetch(&t.keys[lo], 0, 0);
          __builtin_prefetch(&t.keys[hi - 1], 0, 0);
        }
      }
      // pass 2a': bucket search; collect candidate (j, p) pairs in emission
      // order so pass 2b can prefetch verification loads a fixed distance
      // ahead instead of stalling once per candidate.
      cand.clear();
      for (int64_t j = jc; j < j_end; ++j) {
        int64_t lo = los[j - jc], hiix = his[j - jc];
        if (lo == hiix) continue;
        const uint64_t qcode = qcodes[j - jc];
        if (hiix - lo == 1) {  // ~4 keys/radix slot => mostly 0-1 entries
          if (t.keys[lo] == qcode)
            cand.push_back(Cand{lo, static_cast<int32_t>(j)});
          continue;
        }
        // lower_bound
        int64_t a = lo, b = hiix;
        while (a < b) {
          const int64_t mid = (a + b) >> 1;
          if (t.keys[mid] < qcode) a = mid + 1; else b = mid;
        }
        lo = a;
        // upper_bound
        b = hiix;
        while (a < b) {
          const int64_t mid = (a + b) >> 1;
          if (t.keys[mid] <= qcode) a = mid + 1; else b = mid;
        }
        for (int64_t p = lo; p < a; ++p)
          cand.push_back(Cand{p, static_cast<int32_t>(j)});
      }
#if defined(ABLATE_STAGE) && ABLATE_STAGE < 3
      {
        const int64_t c = static_cast<int64_t>(cand.size());
#pragma omp atomic
        cand_total += c;
        if (c == -1) out.push_back(Hit{0, 0, 0, 0, 0});
      }
      continue;
#endif
      // pass 2b: two-level software-pipelined verification.  Prefetching a
      // candidate's packed row needs t.read[p] first — itself a random DRAM
      // load — so metadata is prefetched at distance 2*kPfd and the row (via
      // the by-then-cached metadata) at distance kPfd; a single-level scheme
      // blocks on the metadata load inside the prefetch routine.
      constexpr size_t kPfd = 12;  // ~LFB depth per core
      const size_t n_cand = cand.size();
      auto pf_meta = [&](size_t i) {
        __builtin_prefetch(&t.read[cand[i].p], 0, 0);
        __builtin_prefetch(&t.orient[cand[i].p], 0, 0);
      };
      auto pf_row = [&](size_t i) {
        const int64_t p = cand[i].p;
        const int64_t r2 = t.read[p];
        __builtin_prefetch(&lengths[r2], 0, 0);
        const uint32_t* row2 = (t.orient[p] & 2) ? packed_rc + r2 * row_words
                                                 : packed + r2 * row_words;
        __builtin_prefetch(row2, 0, 0);
        __builtin_prefetch(row2 + row_words - 1, 0, 0);
      };
      for (size_t i = 0; i < n_cand && i < 2 * kPfd; ++i) pf_meta(i);
      for (size_t i = 0; i < n_cand && i < kPfd; ++i) pf_row(i);
      for (size_t ci = 0; ci < n_cand; ++ci) {
        if (ci + 2 * kPfd < n_cand) pf_meta(ci + 2 * kPfd);
        if (ci + kPfd < n_cand) pf_row(ci + kPfd);
        const int64_t j = cand[ci].j;
        {
          const int64_t p = cand[ci].p;
          const int64_t r2 = t.read[p];
          if (r2 == r1) continue;
          if (mode == 2 && contained[r2]) continue;
          const int32_t ho = t.orient[p];
          const int64_t len2 = lengths[r2];
          const bool suffix_case = (ho == 1) || (ho == 3);
          const uint32_t* row2 =
              ((ho == 2) || (ho == 3)) ? packed_rc + r2 * row_words
                                       : packed + r2 * row_words;
          // edge: proper suffix-prefix overlap extending to both ends
          // (reference: OverlapGraph.cpp:567-595)
          bool edge_ok = false;
          if (mode != 1 && j >= 1 &&
              (suffix_case ? (j <= len2 - k) : (len1 - j < len2))) {
            const int64_t en = suffix_case ? j + k : len1 - j;
            const int64_t eo1 = suffix_case ? 0 : j;
            const int64_t eo2 = suffix_case ? len2 - en : 0;
            edge_ok = windows_equal(row1, eo1, row2, eo2, en, row_words);
          }
          // containment: read2 entirely inside read1
          // (reference: OverlapGraph.cpp:517-554)
          bool cont_ok = false;
          if (mode != 2 &&
              (suffix_case ? (j >= len2 - k) : (j + len2 <= len1))) {
            const int64_t co1 = suffix_case ? j + k - len2 : j;
            cont_ok = windows_equal(row1, co1, row2, 0, len2, row_words);
          }
          if (!(edge_ok || cont_ok)) continue;
          out.push_back(Hit{static_cast<int32_t>(r1),
                            static_cast<int32_t>(r2),
                            static_cast<int16_t>(j), t.orient[p],
                            static_cast<uint8_t>(
                                (static_cast<uint8_t>(t.typ[p]) << 2) |
                                (cont_ok ? 2u : 0u) | (edge_ok ? 1u : 0u))});
        }
      }
      }
    }
  }

#if defined(ABLATE_STAGE) && ABLATE_STAGE < 3
  // ablation diagnostic: report the candidate count instead of the hit
  // count (blocks are empty under ablation)
  *total_out = cand_total;
#else
  int64_t total = 0;
  for (const auto& b : col->blocks) total += static_cast<int64_t>(b.size());
  *total_out = total;
#endif
  return col;
}

extern "C" {

// Scans all (read, window) queries, verifies candidates, and stores hits
// grouped by contiguous read blocks.  Returns an opaque handle; *total_out
// is the hit count.  Call overlap_relation_export exactly once to copy the
// columns out and free the handle.
void* overlap_relation_collect(
    const uint32_t* packed, const uint32_t* packed_rc, const int32_t* lengths,
    int64_t n, int64_t row_words, const uint64_t* keys, const int32_t* tread,
    const int8_t* torient, const int8_t* ttyp, int64_t m, int64_t k,
    int64_t* total_out) {
  return collect_impl(packed, packed_rc, lengths, n, row_words, keys, tread,
                      torient, ttyp, m, k, total_out, 0, nullptr);
}

// Streaming-mode entry: see collect_impl's mode docs.
void* overlap_relation_collect_mode(
    const uint32_t* packed, const uint32_t* packed_rc, const int32_t* lengths,
    int64_t n, int64_t row_words, const uint64_t* keys, const int32_t* tread,
    const int8_t* torient, const int8_t* ttyp, int64_t m, int64_t k,
    int64_t* total_out, int64_t mode, const uint8_t* contained) {
  return collect_impl(packed, packed_rc, lengths, n, row_words, keys, tread,
                      torient, ttyp, m, k, total_out,
                      static_cast<int>(mode), contained);
}

// Copies the collected hits into column arrays (block order = read order)
// and frees the handle.
void overlap_relation_export(void* handle, int32_t* out_r1, int32_t* out_j,
                             int32_t* out_r2, int8_t* out_orient,
                             int8_t* out_typ, uint8_t* out_cont,
                             uint8_t* out_edge) {
  auto* col = static_cast<Collected*>(handle);
  const int64_t n_blocks = static_cast<int64_t>(col->blocks.size());
  std::vector<int64_t> offs(n_blocks + 1, 0);
  for (int64_t bi = 0; bi < n_blocks; ++bi)
    offs[bi + 1] = offs[bi] + static_cast<int64_t>(col->blocks[bi].size());
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t bi = 0; bi < n_blocks; ++bi) {
    int64_t slot = offs[bi];
    for (const Hit& h : col->blocks[bi]) {
      out_r1[slot] = h.r1;
      out_j[slot] = h.j;
      out_r2[slot] = h.r2;
      out_orient[slot] = h.orient;
      out_typ[slot] = static_cast<int8_t>(h.flags >> 2);
      out_cont[slot] = (h.flags >> 1) & 1u;
      out_edge[slot] = h.flags & 1u;
      ++slot;
    }
  }
  delete col;
}

// Grouped slim export for the edge-only (mode=2) pass: emits per-read group
// bounds (starts[i] = first slot with r1 >= i, i in [0, n]) plus only the
// columns the traversal replay consumes — j (int16), r2+1 (int32, 1-based),
// orient — and frees each hit block as soon as it is copied, so the peak is
// ~max(internal, exported) instead of their sum.  Rows are r1-ascending by
// construction (blocks are read-ascending, rows within a block too).
void overlap_relation_export_grouped(void* handle, int64_t n,
                                     int64_t* out_starts, int16_t* out_j,
                                     int32_t* out_r2p1, int8_t* out_orient) {
  auto* col = static_cast<Collected*>(handle);
  int64_t slot = 0;
  int64_t cur = 0;
  for (auto& b : col->blocks) {
    for (const Hit& h : b) {
      while (cur <= h.r1) out_starts[cur++] = slot;
      out_j[slot] = h.j;
      out_r2p1[slot] = h.r2 + 1;
      out_orient[slot] = h.orient;
      ++slot;
    }
    std::vector<Hit>().swap(b);
  }
  while (cur <= n) out_starts[cur++] = slot;
  delete col;
}

}  // extern "C"

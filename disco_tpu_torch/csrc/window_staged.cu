// Window checks and a row checksum that read their table rows from staged
// row windows (window.cuh: RowWindow), for NVIDIA Hopper (compiled for
// sm_90a).  Three kernels, one per TPU kernel they replace, and two timing
// controls:
//
//   window_compare_ring_both    <- disco_tpu/overlap/fused_kernel.py::
//                                  verify_windows_fused_mxu_both (Pallas body
//                                  _mxu3_kernel, K5): both rows fetched from
//                                  one 32-word line table (relabeled rows),
//                                  compared over its first W_CMP = 24 words.
//   window_compare_anchored     <- tools/exp_fetch_variants.py::verify_sync
//                                  (_sync_kernel, T1): read1's row from a
//                                  64-row window anchored at the 1024-pair
//                                  tile's first row & ~3; read2's row as
//                                  (Wb, P) columns.
//   row_checksum_ring           <- tools/exp_mxu_fetch.py::main (closure
//                                  kern, T3): sum(word & 0x7FFF) over the
//                                  words of row rows[p] + salt, from a
//                                  32-row window at bases[tile] + salt
//                                  (row_checksum_ring_any at widths other
//                                  than the main path's 17 words).
//   window_compare_staged_both, window_compare_staged, row_checksum_staged:
//   K5's, T1's and T3's kernels as they were before they overlapped their
//   copies (the _unpipelined controls, on no path; see below).
//
// tools/exp_fetch_variants.py::verify_pipe_nc (T2) runs K4's Pallas body
// (_mxu2_kernel) without its guard; its Hopper kernel is K4's
// window_compare_fetch (window_compare.cu), which has no guard: one body,
// two call sites, one kernel.
//
// The window rules are the TPU kernels' per-tile line windows (VMEM,
// scalar-prefetched block indices, make_async_copy), per tile of
// kTilePairs = 1024 pairs: K5 stages 192 rows from the tile's least read1
// row and 384 from its least read2 row, T1 64 rows from its first pair's
// row & ~3.  Here a row outside its window is read from device memory and
// counted, so every result is exact without a span precondition or a
// fallback, and `misses` says how often the window missed
// (fused_kernel.py _both_misses, exp_fetch_variants.py sync_misses).
//
// What bounds them on an H100: device-memory bytes, as for window_compare.cu
// (a funnel shift, an XOR and a compare per 16 bases of each pair).  Staging
// moves each distinct row of a tile once, from device memory or L2, into
// shared memory, where the tile's pairs re-read it; a staged row's words
// past ws (the words a window inside its row can reach: Wp = n_words + 1
// for packed reads) come from device memory.  The rows are staged at an
// odd stride (ws | 1), which puts word w of 32 consecutive rows on 32
// banks, by 4-B cp.async: an odd stride breaks the 16-B alignment of the
// wider copies, and not TMA, whose boxes are a multiple of 16 B wide (17
// words are not) and fixed in height (a tile's row range is not).
//
// The earlier kernels (the controls) copied a tile's window, waited and
// synced before its first compare, so nothing overlapped the copy: they
// lost to the direct fetch on the same bytes (K5 to K6, T1 to T2).  The
// kernels that replace them overlap the next tile's copy with a tile's
// compare:
//   - T1 runs on the ring of tile_ring.cuh (K4's, with the read1 rule
//     AnchoredRows): 256-pair tiles, a persistent grid of three blocks an
//     SM, two stages, geometry two tiles ahead.  A 256-pair tile stages the
//     rows [max(lo, a, 0), min(hi, a + 63, n_rows - 1)] of its least and
//     greatest live rows1 (lo, hi; n = 0 pairs included, as the count
//     includes them) and its 1024-pair tile's anchor a, so a live row is
//     staged exactly when it lies inside its window;
//   - K5 keeps the 1024-pair tile as its unit, four pairs a thread: its
//     window rule is per 1024 pairs, and read2's rows are far less local
//     than read1's (after the BFS relabel a quarter of a tile's read2 rows
//     span nearly as many rows as the whole tile's), so 256-pair tiles
//     would copy read2's rows several times over.  A persistent grid walks
//     the tiles with two stages: while tile j is compared, tile j + 1's
//     windows are copied (its least and greatest rows, block-wide, from
//     rows loaded a tile earlier), tile j + 1's geometry is loaded, and
//     tile j + 2's rows.  Two stages of 576 rows of 17 words (78,336 B)
//     leave room for two blocks an SM.  Each row is copied by a thread that
//     steps through the window's words without a division
//     (window.cuh stage_rows_stepped).  A window whose words all lie in the
//     staged words compares them without an early exit (window.cuh
//     staged_rows_equal; at most 16 words: the launcher takes at most 17
//     staged words, as K5 takes reads of at most 256 bp): with the exit,
//     each word's shared load waited on the compare before it, and the
//     kernel took a fifth longer (PERF.md, section 6).
// Any other window reads through staged_row_at, which reads device memory
// past the staged words or outside the window.
//   - T3 walks its 1024-pair tiles on a persistent grid with three stages
//     (two tiles' windows in flight while one is summed), the next tile's
//     rows loaded a tile ahead, four consecutive pairs a thread (one
//     streaming 16-B load of rows, one streaming 16-B store of sums).  Its window is 32 consecutive
//     rows of a row-major table, one span of 32 wt words: at an odd width
//     the span keeps the table's stride, which is odd and so already the
//     conflict-free layout, and is copied by 16-B cp.async.cg with 4-B
//     copies up to the first 16-B boundary and after the last (stage_span;
//     exp_mxu_fetch.span_copies states the pieces); an even width is
//     copied row by row at stride wt + 1.  A pair checks once that its row
//     lies in the window and then sums the row's words with no checks; the
//     four pairs' sums are interleaved, four independent shared loads a
//     word.  Rows too wide for three stages (over 605 words) go to the
//     copy-then-sum kernel, which the launcher counts as T3's.
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns the CUDA error of
// the launch (cudaGetLastError()) or of its launch-shape query.
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_ring.cuh"
#include "window.cuh"

namespace {

using disco::ColumnRow;
using disco::RowWindow;
using disco::TileSpan;
using disco::add_count;
using disco::block_min_max;
using disco::cp_async_wait_all;
using disco::kThreads;
using disco::kTilePairs;
using disco::row_window;
using disco::stage_rows;
using disco::staged_row;
using disco::staged_row_at;
using disco::window_equal;
namespace ring = disco::ring;

constexpr int kPerThread = kTilePairs / kThreads;
constexpr int kBothRows1 = 192;  // K5 read1 window (TPU: NB_A = 3 x 64)
constexpr int kBothRows2 = 384;  // K5 read2 window (TPU: NB_B = 6 x 64)
constexpr int kSyncRows = 64;    // T1 window (TPU: K_LINES = 16 lines of 4)
constexpr int kSumRows = 32;     // T3 window (TPU: K = 32)
constexpr int64_t kNoRow = INT64_MAX;
static_assert(ring::AnchoredRows::kRows == kSyncRows, "T1's window");

__device__ __forceinline__ int64_t pair_index(int k) {
  return static_cast<int64_t>(blockIdx.x) * kTilePairs + k * kThreads +
         threadIdx.x;
}

// ---------------------------------------------------------------------------
// K5: a ring of 1024-pair tiles, four pairs a thread
// ---------------------------------------------------------------------------
constexpr int kBothStages = 2;
constexpr int kBothBlocksPerSm = 2;
constexpr int kBothSlotInts = 2 * 2 * 32;  // tile_spans<2>' scratch
// windows of up to 16 words (reads <= 256 bp, all K5 takes) compare
// without an early exit (window.cuh staged_rows_equal); K5 stages at most
// kUnrolledWords + 1 words a row, so a window inside them has no more
constexpr int kUnrolledWords = 16;

struct TilePairRows {
  int r1[kPerThread], r2[kPerThread];
};

struct TileGeometry {
  int o1[kPerThread], o2[kPerThread], n[kPerThread];
};

__global__ void __launch_bounds__(kThreads, kBothBlocksPerSm)
window_compare_ring_both_kernel(const uint32_t* __restrict__ table,
                                int64_t n_rows, int wt, int words, int ws,
                                const int32_t* __restrict__ rows1,
                                const int32_t* __restrict__ rows2,
                                int64_t P,
                                const int32_t* __restrict__ o1,
                                const int32_t* __restrict__ o2,
                                const int32_t* __restrict__ n,
                                uint8_t* __restrict__ ok,
                                unsigned long long* __restrict__ misses) {
  extern __shared__ uint32_t smem[];
  __shared__ int scratch[kBothStages * kBothSlotInts];
  const int stride = ws | 1;
  const int sw = (kBothRows1 + kBothRows2) * stride;
  const int64_t tiles = (P + kTilePairs - 1) / kTilePairs;
  const int64_t step = gridDim.x;

  auto pair_at = [&](int64_t t, int k) {
    return t * kTilePairs + k * kThreads + threadIdx.x;
  };
  auto load_rows = [&](int64_t t, TilePairRows& r) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t p = pair_at(t, k);
      r.r1[k] = p < P ? __ldg(rows1 + p) : 0;
      r.r2[k] = p < P ? __ldg(rows2 + p) : 0;
    }
  };
  auto load_geometry = [&](int64_t t, TileGeometry& g) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t p = pair_at(t, k);
      g.o1[k] = p < P ? __ldg(o1 + p) : 0;
      g.o2[k] = p < P ? __ldg(o2 + p) : 0;
      g.n[k] = p < P ? __ldg(n + p) : 0;
    }
  };
  // The least and greatest row of each side over the tile's live pairs;
  // every thread calls this (one sync).
  auto spans_of = [&](int64_t t, const TilePairRows& r, int slot,
                      TileSpan(&out)[2]) {
    TileSpan mine[2] = {disco::no_span(), disco::no_span()};
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (pair_at(t, k) >= P) continue;
      mine[0] = TileSpan{min(mine[0].lo, r.r1[k]), max(mine[0].hi, r.r1[k])};
      mine[1] = TileSpan{min(mine[1].lo, r.r2[k]), max(mine[1].hi, r.r2[k])};
    }
    disco::tile_spans<2>(mine, scratch + slot * kBothSlotInts, out);
  };
  auto windows_of = [&](int slot, const TileSpan(&sp)[2], RowWindow& w1,
                        RowWindow& w2) {
    uint32_t* s = smem + slot * sw;
    w1 = row_window(s, sp[0].lo, sp[0].hi, kBothRows1, n_rows, ws);
    w2 = row_window(s + kBothRows1 * stride, sp[1].lo, sp[1].hi, kBothRows2,
                    n_rows, ws);
  };
  auto stage = [&](int slot, const TileSpan(&sp)[2]) {
    RowWindow w1, w2;
    windows_of(slot, sp, w1, w2);
    disco::stage_rows_stepped(w1, table, wt);
    disco::stage_rows_stepped(w2, table, wt);
    disco::cp_async_commit();
  };

  int64_t t = blockIdx.x;  // < tiles: the grid is no larger
  TilePairRows r0, r1n, r2n;
  TileGeometry g0, g1;
  TileSpan sp0[2], sp1[2];
  load_rows(t, r0);
  load_geometry(t, g0);
  spans_of(t, r0, 0, sp0);
  stage(0, sp0);
  load_rows(t + step, r1n);
  int slot = 0, missed = 0;
  for (;; t += step) {
    // tile t + step goes into the stage that tile t - step used: every
    // thread has passed that compare (spans_of syncs first)
    spans_of(t + step, r1n, slot ^ 1, sp1);
    stage(slot ^ 1, sp1);
    load_geometry(t + step, g1);
    load_rows(t + 2 * step, r2n);
    disco::cp_async_wait<1>();
    __syncthreads();

    RowWindow w1, w2;
    windows_of(slot, sp0, w1, w2);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t p = pair_at(t, k);
      bool v = true;
      if (p < P) {
        const int64_t k1 = r0.r1[k] - w1.base, k2 = r0.r2[k] - w2.base;
        const bool s1 = k1 >= 0 && k1 < w1.rows;
        const bool s2 = k2 >= 0 && k2 < w2.rows;
        missed += !s1 + !s2;
        const int q1 = g0.o1[k], q2 = g0.o2[k], nn = g0.n[k];
        const int d1 = q1 >> 4, d2 = q2 >> 4;
        const int nw = (nn >> 4) + ((nn & 15) != 0);
        if (nn > 0 && s1 && s2 && d1 >= 0 && d1 + nw < ws && d2 >= 0 &&
            d2 + nw < ws) {
          const uint32_t* a = w1.smem + k1 * stride + d1;
          const uint32_t* b = w2.smem + k2 * stride + d2;
          v = disco::staged_rows_equal<kUnrolledWords>(
              a, (q1 & 15) << 1, b, (q2 & 15) << 1, nn);
        } else {
          v = window_equal(
              staged_row_at(w1, table, n_rows, wt, words, r0.r1[k]), q1,
              staged_row_at(w2, table, n_rows, wt, words, r0.r2[k]), q2, nn);
        }
      }
      disco::store_flags(ok, p, P, v);
    }
    if (t + step >= tiles) break;
    r0 = r1n;
    r1n = r2n;
    g0 = g1;
    sp0[0] = sp1[0];
    sp0[1] = sp1[1];
    slot ^= 1;
  }
  disco::cp_async_wait<0>();  // the empty stage past the last tile
  add_count(missed, misses);
}

// ---------------------------------------------------------------------------
// T3: a ring of 1024-pair tiles, four consecutive pairs a thread
// ---------------------------------------------------------------------------
constexpr int kSumStages = 3;        // the tile summed and two in flight
constexpr int kSumBlocksPerSm = 4;   // <= 64 registers
constexpr int kSumPerThread = kTilePairs / kThreads;
static_assert(kSumPerThread == 4, "one 16-B load of rows a thread");

// Words of one stage: the 32-row window at stride wt | 1, and 4 words of
// room for the span copy's alignment shift (a multiple of 4, so that every
// stage starts 16-B aligned).
__host__ __device__ inline int sum_stage_words(int wt) {
  return kSumRows * (wt | 1) + 4;
}

// The word of a stage where row w.base of an odd-width window lands: the
// span copy keeps the table's 16-B phase, so its 16-B pieces are aligned
// on both sides.  Even widths are copied row by row at the odd stride
// wt + 1, unshifted.
__device__ __forceinline__ int span_shift(const uint32_t* table, int64_t base,
                                          int wt) {
  return (wt & 1) ? static_cast<int>((reinterpret_cast<uintptr_t>(
                                          table + base * wt) >> 2) & 3)
                  : 0;
}

// Start (no wait) the block's copies of window `w` (its smem already
// shifted by span_shift).  An odd width keeps the table's own stride, so
// the window's rows are one span of rows * wt words in both memories:
// 4-B copies up to the first 16-B boundary, 16-B cp.async.cg pieces, and
// 4-B copies of the rest (exp_mxu_fetch.span_copies states the pieces).
// An even width is staged row by row at stride wt + 1 (stage_rows_stepped).
__device__ __forceinline__ void stage_span(const RowWindow& w,
                                           const uint32_t* table, int wt) {
  if (!(wt & 1)) {
    disco::stage_rows_stepped(w, table, wt);
    return;
  }
  const int total = w.rows * wt;
  const uint32_t* src = table + w.base * wt;
  const int head = min((4 - static_cast<int>(
                            (reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3,
                       total);
  const int chunks = (total - head) >> 2;
  const int tail = total - head - 4 * chunks;
  const int i = threadIdx.x;
  if (i < head) disco::cp_async4(w.smem + i, src + i);
  for (int c = i; c < chunks; c += kThreads)
    disco::cp_async16(w.smem + head + 4 * c, src + head + 4 * c);
  if (i < tail) {
    const int o = head + 4 * chunks + i;
    disco::cp_async4(w.smem + o, src + o);
  }
}

// The 32-row window of the tile whose first row is `first` (its base row
// plus the salt) in stage `slot`: row_window's rows, cut to the table, at
// span_shift.
__device__ __forceinline__ RowWindow sum_window(uint32_t* smem, int slot,
                                                int64_t first,
                                                const uint32_t* table,
                                                int64_t n_rows, int wt) {
  RowWindow w = row_window(smem + slot * sum_stage_words(wt), first,
                           first + kSumRows - 1, kSumRows, n_rows, wt);
  w.smem += span_shift(table, w.base, wt);
  return w;
}

// The tiles blockIdx.x, blockIdx.x + gridDim.x, ... of T3 (see the top of
// this file); kWt > 0 fixes the width at compile time (the main path's 17
// words), 0 takes wt.
template <int kWt>
__device__ __forceinline__ void checksum_tiles(
    uint32_t* smem, const uint32_t* __restrict__ table, int64_t n_rows,
    int wt, const int32_t* __restrict__ rows, int64_t P,
    const int32_t* __restrict__ bases, int salt, int32_t* __restrict__ out,
    unsigned long long* __restrict__ misses) {
  if (kWt > 0) wt = kWt;
  const int stride = wt | 1;
  const int64_t tiles = (P + kTilePairs - 1) / kTilePairs;
  const int64_t step = gridDim.x;
  // 16-B loads of rows and stores of sums where the pointers allow them,
  // streaming (they leave L1 and L2 to the table)
  const bool vec = ((reinterpret_cast<uintptr_t>(rows) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;

  auto first_of = [&](int64_t t) -> int64_t {
    return t < tiles ? static_cast<int64_t>(__ldg(bases + t)) + salt : 0;
  };
  auto load_rows = [&](int64_t t, int (&r)[kSumPerThread]) {
    const int64_t p = t * kTilePairs + kSumPerThread * threadIdx.x;
    if (vec && p + kSumPerThread <= P) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(rows + p));
      r[0] = x.x;
      r[1] = x.y;
      r[2] = x.z;
      r[3] = x.w;
    } else {
#pragma unroll
      for (int m = 0; m < kSumPerThread; ++m)
        r[m] = p + m < P ? __ldg(rows + p + m) : 0;
    }
  };
  auto stage = [&](int slot, int64_t first) {
    stage_span(sum_window(smem, slot, first, table, n_rows, wt), table, wt);
  };

  // Tile j of this block stages into slot j % kSumStages.  Iteration j
  // waits for tile j's copies, syncs (every thread is then past tile j - 1),
  // stages tile j + kSumStages - 1 into the slot tile j - 1 used, and sums
  // tile j.  The window's first rows ride along in registers: f[i] is tile
  // j + i's.
  int64_t t = blockIdx.x;  // < tiles: the grid is no larger
  int64_t f[kSumStages];
#pragma unroll
  for (int i = 0; i < kSumStages; ++i) f[i] = first_of(t + i * step);
#pragma unroll
  for (int i = 0; i + 1 < kSumStages; ++i) {
    if (t + i * step < tiles) stage(i, f[i]);
    disco::cp_async_commit();
  }
  int r[kSumPerThread];
  load_rows(t, r);
  int slot = 0, missed = 0;
  for (; t < tiles; t += step) {
    disco::cp_async_wait<kSumStages - 2>();
    __syncthreads();
    const int ahead = slot == 0 ? kSumStages - 1 : slot - 1;
    if (t + (kSumStages - 1) * step < tiles)
      stage(ahead, f[kSumStages - 1]);
    disco::cp_async_commit();
    int rn[kSumPerThread];
    load_rows(t + step, rn);
    const int64_t fn = first_of(t + kSumStages * step);

    const RowWindow w = sum_window(smem, slot, f[0], table, n_rows, wt);
    const int64_t p = t * kTilePairs + kSumPerThread * threadIdx.x;
    int32_t sums[kSumPerThread] = {0, 0, 0, 0};
    const uint32_t* s[kSumPerThread];
    bool all = true;
#pragma unroll
    for (int m = 0; m < kSumPerThread; ++m) {
      const int64_t k = static_cast<int64_t>(r[m]) + salt - w.base;
      const bool staged = k >= 0 && k < w.rows;
      missed += p + m < P && !staged;
      all = all && staged;
      s[m] = staged ? w.smem + k * stride : nullptr;
    }
    if (all) {
      // the path's case: the four sums interleaved, four independent
      // shared loads a word (one pair's sum after another waited on each
      // load in turn: PERF.md, section 6)
#pragma unroll 4
      for (int c = 0; c < wt; ++c) {
#pragma unroll
        for (int m = 0; m < kSumPerThread; ++m)
          sums[m] += static_cast<int32_t>(s[m][c] & 0x7FFFu);
      }
    } else {
#pragma unroll
      for (int m = 0; m < kSumPerThread; ++m) {
        const int64_t row = static_cast<int64_t>(r[m]) + salt;
        if (s[m] != nullptr) {
          for (int c = 0; c < wt; ++c)
            sums[m] += static_cast<int32_t>(s[m][c] & 0x7FFFu);
        } else if (row >= 0 && row < n_rows) {
          const uint32_t* g = table + row * wt;
          for (int c = 0; c < wt; ++c)
            sums[m] += static_cast<int32_t>(__ldg(g + c) & 0x7FFFu);
        }
      }
    }
    if (vec && p + kSumPerThread <= P) {
      __stcs(reinterpret_cast<int4*>(out + p),
             make_int4(sums[0], sums[1], sums[2], sums[3]));
    } else {
#pragma unroll
      for (int m = 0; m < kSumPerThread; ++m)
        if (p + m < P) out[p + m] = sums[m];
    }
#pragma unroll
    for (int m = 0; m < kSumPerThread; ++m) r[m] = rn[m];
#pragma unroll
    for (int i = 0; i + 1 < kSumStages; ++i) f[i] = f[i + 1];
    f[kSumStages - 1] = fn;
    slot = slot + 1 == kSumStages ? 0 : slot + 1;
  }
  disco::cp_async_wait<0>();  // the empty groups past the last tile
  add_count(missed, misses);
}

// T3 at the main path's width (17 words: reads of 250 bp), and at any
// width.
constexpr int kPathWords = 17;

__global__ void __launch_bounds__(kThreads, kSumBlocksPerSm)
row_checksum_ring_kernel(const uint32_t* __restrict__ table, int64_t n_rows,
                         int wt, const int32_t* __restrict__ rows, int64_t P,
                         const int32_t* __restrict__ bases, int salt,
                         int32_t* __restrict__ out,
                         unsigned long long* __restrict__ misses) {
  extern __shared__ uint4 smem4[];
  checksum_tiles<kPathWords>(reinterpret_cast<uint32_t*>(smem4), table,
                             n_rows, wt, rows, P, bases, salt, out, misses);
}

__global__ void __launch_bounds__(kThreads, kSumBlocksPerSm)
row_checksum_ring_any_kernel(const uint32_t* __restrict__ table,
                             int64_t n_rows, int wt,
                             const int32_t* __restrict__ rows, int64_t P,
                             const int32_t* __restrict__ bases, int salt,
                             int32_t* __restrict__ out,
                             unsigned long long* __restrict__ misses) {
  extern __shared__ uint4 smem4[];
  checksum_tiles<0>(reinterpret_cast<uint32_t*>(smem4), table, n_rows, wt,
                    rows, P, bases, salt, out, misses);
}

// ---------------------------------------------------------------------------
// T1 on the ring of tile_ring.cuh
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(ring::kMaxTile, ring::kBlocksPerSm)
window_compare_anchored_kernel(const uint32_t* __restrict__ table,
                               int64_t n_rows, int wt, int ws,
                               const uint32_t* __restrict__ b, int wb,
                               const int32_t* __restrict__ rows1, int64_t P,
                               const int32_t* __restrict__ o1,
                               const int32_t* __restrict__ o2,
                               const int32_t* __restrict__ n,
                               uint8_t* __restrict__ ok,
                               unsigned long long* __restrict__ misses) {
  extern __shared__ uint4 smem4[];
  __shared__ int scratch[ring::kScratchInts];
  ring::compare_tiles<ring::AnchoredRows>(
      reinterpret_cast<uint32_t*>(smem4), scratch, nullptr, table, n_rows,
      wt, ws, b, wb, rows1, P, o1, o2, n, ok, misses);
}

// ---------------------------------------------------------------------------
// One block a 1024-pair tile, copy then compare: T3, and the controls of K5
// and T1 (their kernels before the copies overlapped the compares)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
window_compare_staged_both_kernel(const uint32_t* __restrict__ table,
                                  int64_t n_rows, int wt, int words, int ws,
                                  const int32_t* __restrict__ rows1,
                                  const int32_t* __restrict__ rows2,
                                  int64_t P,
                                  const int32_t* __restrict__ o1,
                                  const int32_t* __restrict__ o2,
                                  const int32_t* __restrict__ n,
                                  uint8_t* __restrict__ ok,
                                  unsigned long long* __restrict__ misses) {
  extern __shared__ uint32_t smem[];
  __shared__ int64_t scratch[2][2 * kThreads / 32];
  int64_t r1[kPerThread], r2[kPerThread];
  int64_t lo1 = kNoRow, hi1 = -1, lo2 = kNoRow, hi2 = -1;
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t p = pair_index(k);
    r1[k] = p < P ? rows1[p] : kNoRow;
    r2[k] = p < P ? rows2[p] : kNoRow;
    if (p < P) {
      lo1 = disco::min64(lo1, r1[k]);
      hi1 = disco::max64(hi1, r1[k]);
      lo2 = disco::min64(lo2, r2[k]);
      hi2 = disco::max64(hi2, r2[k]);
    }
  }
  block_min_max(lo1, hi1, scratch[0], lo1, hi1);
  block_min_max(lo2, hi2, scratch[1], lo2, hi2);
  const RowWindow w1 =
      row_window(smem, lo1, hi1, kBothRows1, n_rows, ws);
  const RowWindow w2 = row_window(smem + kBothRows1 * w1.stride, lo2, hi2,
                                  kBothRows2, n_rows, ws);
  stage_rows(w1, table, wt);
  stage_rows(w2, table, wt);
  cp_async_wait_all();
  __syncthreads();
  int missed = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t p = pair_index(k);
    if (p >= P) continue;
    const auto a = staged_row(w1, table, n_rows, wt, words, r1[k], missed);
    const auto b = staged_row(w2, table, n_rows, wt, words, r2[k], missed);
    ok[p] = window_equal(a, o1[p], b, o2[p], n[p]);
  }
  add_count(missed, misses);
}

__global__ void __launch_bounds__(kThreads)
window_compare_staged_kernel(const uint32_t* __restrict__ table,
                             int64_t n_rows, int wt, int ws,
                             const uint32_t* __restrict__ b, int wb,
                             const int32_t* __restrict__ rows1, int64_t P,
                             const int32_t* __restrict__ o1,
                             const int32_t* __restrict__ o2,
                             const int32_t* __restrict__ n,
                             uint8_t* __restrict__ ok,
                             unsigned long long* __restrict__ misses) {
  extern __shared__ uint32_t smem[];
  const int64_t first = static_cast<int64_t>(
      rows1[static_cast<int64_t>(blockIdx.x) * kTilePairs] & ~3);
  const RowWindow w = row_window(smem, first, first + kSyncRows - 1,
                                 kSyncRows, n_rows, ws);
  stage_rows(w, table, wt);
  cp_async_wait_all();
  __syncthreads();
  int missed = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t p = pair_index(k);
    if (p >= P) continue;
    const auto a = staged_row(w, table, n_rows, wt, wt, rows1[p], missed);
    const ColumnRow rb{b + p, P, wb};
    ok[p] = window_equal(a, o1[p], rb, o2[p], n[p]);
  }
  add_count(missed, misses);
}

__global__ void __launch_bounds__(kThreads)
row_checksum_staged_kernel(const uint32_t* __restrict__ table,
                           int64_t n_rows, int wt,
                           const int32_t* __restrict__ rows, int64_t P,
                           const int32_t* __restrict__ bases, int salt,
                           int32_t* __restrict__ out,
                           unsigned long long* __restrict__ misses) {
  extern __shared__ uint32_t smem[];
  const int64_t first = static_cast<int64_t>(bases[blockIdx.x]) + salt;
  const RowWindow w = row_window(smem, first, first + kSumRows - 1, kSumRows,
                                 n_rows, wt);
  stage_rows(w, table, wt);
  cp_async_wait_all();
  __syncthreads();
  int missed = 0;
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t p = pair_index(k);
    if (p >= P) continue;
    const auto row = staged_row(w, table, n_rows, wt, wt,
                                static_cast<int64_t>(rows[p]) + salt, missed);
    int32_t sum = 0;
    for (int c = 0; c < wt; ++c) sum += static_cast<int32_t>(row(c) & 0x7FFFu);
    out[p] = sum;
  }
  add_count(missed, misses);
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

const uint32_t* u32(const void* x) { return static_cast<const uint32_t*>(x); }

const int32_t* i32(const void* x) { return static_cast<const int32_t*>(x); }

unsigned long long* u64(void* x) {
  return static_cast<unsigned long long*>(x);
}

unsigned tiles_for(int64_t P) {
  return static_cast<unsigned>((P + kTilePairs - 1) / kTilePairs);
}

// Dynamic shared memory of `rows` staged rows of ws words; raises the
// kernel's limit above the default 48 KB.  Returns the bytes, or -1 with
// the error in *err.
template <class K>
int64_t smem_for(K kernel, int rows, int ws, cudaError_t* err) {
  const int64_t bytes = static_cast<int64_t>(rows) * (ws | 1) * 4;
  *err = cudaSuccess;
  if (bytes > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
  }
  return *err == cudaSuccess ? bytes : -1;
}

// K5's dynamic shared memory (its stages of ws-word rows, ws <= 17) and
// grid.
cudaError_t both_shape(int ws, int64_t P, size_t* smem, unsigned* grid) {
  if (ws < 1 || ws > kUnrolledWords + 1) return cudaErrorInvalidValue;
  *smem = static_cast<size_t>(kBothStages) * 4 * (kBothRows1 + kBothRows2) *
          (ws | 1);
  return ring::persistent_grid(window_compare_ring_both_kernel, kThreads,
                               *smem, (P + kTilePairs - 1) / kTilePairs,
                               grid);
}

// T3's kernel for rows of wt words.
auto* sum_kernel(int wt) {
  return wt == kPathWords ? row_checksum_ring_kernel
                          : row_checksum_ring_any_kernel;
}

// Whether rows of wt words fit T3's ring: its kSumStages stages of
// sum_stage_words(wt) in a block's shared memory (rows of at most 605
// words).  Wider rows take the copy-then-sum kernel.
bool sum_fits(int wt) {
  return wt >= 1 && static_cast<int64_t>(kSumStages) * 4 *
                            sum_stage_words(wt) <= ring::kSmemBytes;
}

// T3's ring at wt words a row (sum_fits): dynamic shared memory and
// persistent grid.
cudaError_t sum_shape(int wt, int64_t P, size_t* smem, unsigned* grid) {
  if (!sum_fits(wt)) return cudaErrorInvalidValue;
  *smem = static_cast<size_t>(kSumStages) * 4 * sum_stage_words(wt);
  return ring::persistent_grid(sum_kernel(wt), kThreads, *smem,
                               (P + kTilePairs - 1) / kTilePairs, grid);
}

}  // namespace

extern "C" {

int disco_window_compare_staged_both(const void* table, int64_t n_rows,
                                     int wt, int words, int ws,
                                     const void* rows1, const void* rows2,
                                     int64_t P, const void* o1,
                                     const void* o2, const void* n, void* ok,
                                     void* misses, void* stream) {
  if (P <= 0) return 0;
  if (ws < 1 || ws > words || words > wt) return cudaErrorInvalidValue;
  size_t smem;
  unsigned grid;
  const cudaError_t e = both_shape(ws, P, &smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_compare_ring_both_kernel<<<grid, kThreads, smem,
                                    as_stream(stream)>>>(
      u32(table), n_rows, wt, words, ws, i32(rows1), i32(rows2), P, i32(o1),
      i32(o2), i32(n), static_cast<uint8_t*>(ok), u64(misses));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_staged(const void* table, int64_t n_rows, int wt,
                                int ws, const void* b, int wb,
                                const void* rows1, int64_t P, const void* o1,
                                const void* o2, const void* n, void* ok,
                                void* misses, void* stream) {
  if (P <= 0) return 0;
  if (ws < 1 || ws > wt) return cudaErrorInvalidValue;
  int tile;
  size_t smem;
  unsigned grid;
  const cudaError_t e = ring::tiled_shape<ring::AnchoredRows>(
      window_compare_anchored_kernel, wb, ws, P, &tile, &smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  window_compare_anchored_kernel<<<grid, tile, smem, as_stream(stream)>>>(
      u32(table), n_rows, wt, ws, u32(b), wb, i32(rows1), P, i32(o1),
      i32(o2), i32(n), static_cast<uint8_t*>(ok), u64(misses));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of K5's kernel (both != 0; words unused) or T1's (read2's
// columns `words` wide) at ws staged words a row and P pairs: pairs per
// tile, blocks, and the stages of the ring.
int disco_window_staged_shape(int both, int words, int ws, int64_t P,
                              int* tile, int* grid, int* stages) {
  size_t smem;
  unsigned g = 0;
  cudaError_t e;
  if (both) {
    e = both_shape(ws, P, &smem, &g);
    *tile = kTilePairs;
    *stages = kBothStages;
  } else {
    e = ring::tiled_shape<ring::AnchoredRows>(
        window_compare_anchored_kernel, words, ws, P, tile, &smem, &g);
    *stages = ring::kStages;
  }
  *grid = static_cast<int>(g);
  return static_cast<int>(e);
}


int disco_window_compare_staged_both_unpipelined(
    const void* table, int64_t n_rows, int wt, int words, int ws,
    const void* rows1, const void* rows2, int64_t P, const void* o1,
    const void* o2, const void* n, void* ok, void* misses, void* stream) {
  if (P <= 0) return 0;
  if (ws < 1 || ws > words || words > wt) return cudaErrorInvalidValue;
  cudaError_t err;
  const int64_t bytes = smem_for(window_compare_staged_both_kernel,
                                 kBothRows1 + kBothRows2, ws, &err);
  if (bytes < 0) return static_cast<int>(err);
  window_compare_staged_both_kernel<<<tiles_for(P), kThreads, bytes,
                                      as_stream(stream)>>>(
      u32(table), n_rows, wt, words, ws, i32(rows1), i32(rows2), P, i32(o1),
      i32(o2), i32(n), static_cast<uint8_t*>(ok), u64(misses));
  return static_cast<int>(cudaGetLastError());
}

int disco_window_compare_staged_unpipelined(
    const void* table, int64_t n_rows, int wt, int ws, const void* b, int wb,
    const void* rows1, int64_t P, const void* o1, const void* o2,
    const void* n, void* ok, void* misses, void* stream) {
  if (P <= 0) return 0;
  if (ws < 1 || ws > wt) return cudaErrorInvalidValue;
  cudaError_t err;
  const int64_t bytes =
      smem_for(window_compare_staged_kernel, kSyncRows, ws, &err);
  if (bytes < 0) return static_cast<int>(err);
  window_compare_staged_kernel<<<tiles_for(P), kThreads, bytes,
                                 as_stream(stream)>>>(
      u32(table), n_rows, wt, ws, u32(b), wb, i32(rows1), P, i32(o1),
      i32(o2), i32(n), static_cast<uint8_t*>(ok), u64(misses));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of T3 at wt words a row and P pairs: stages of its ring
// and blocks, or *stages = 0 where the rows are too wide for the ring.
int disco_row_checksum_shape(int wt, int64_t P, int* stages, int* grid) {
  *stages = 0;
  *grid = 0;
  if (!sum_fits(wt)) return 0;
  size_t smem;
  unsigned g = 0;
  const cudaError_t e = sum_shape(wt, P, &smem, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  *stages = kSumStages;
  *grid = static_cast<int>(g);
  return 0;
}

int disco_row_checksum_staged(const void* table, int64_t n_rows, int wt,
                              const void* rows, int64_t P, const void* bases,
                              int salt, void* out, void* misses,
                              void* stream) {
  if (P <= 0) return 0;
  if (wt < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  const int64_t bytes =
      smem_for(row_checksum_staged_kernel, kSumRows, wt, &err);
  if (bytes < 0) return static_cast<int>(err);
  row_checksum_staged_kernel<<<tiles_for(P), kThreads, bytes,
                               as_stream(stream)>>>(
      u32(table), n_rows, wt, i32(rows), P, i32(bases), salt,
      static_cast<int32_t*>(out), u64(misses));
  return static_cast<int>(cudaGetLastError());
}

// T3: the ring, or for rows too wide for its stages the copy-then-sum
// kernel (disco_row_checksum_staged), which the caller counts as its own.
int disco_row_checksum(const void* table, int64_t n_rows, int wt,
                       const void* rows, int64_t P, const void* bases,
                       int salt, void* out, void* misses, void* stream) {
  if (P <= 0) return 0;
  if (!sum_fits(wt))
    return disco_row_checksum_staged(table, n_rows, wt, rows, P, bases, salt,
                                     out, misses, stream);
  size_t smem;
  unsigned grid;
  const cudaError_t e = sum_shape(wt, P, &smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto kernel = sum_kernel(wt);
  kernel<<<grid, kThreads, smem, as_stream(stream)>>>(
      u32(table), n_rows, wt, i32(rows), P, i32(bases), salt,
      static_cast<int32_t*>(out), u64(misses));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The ring of tiles shared by the tiled window checks: window_compare.cu's
// K3 and K4 (T2 runs K4's kernel) and window_staged.cu's T1.
//
// A persistent grid of as many blocks as fit on the SMs walks tiles of T
// pairs (256, fewer for wide rows), one thread a pair: block b takes tiles
// b, b + gridDim.x, ...  A ring of kStages shared-memory stages keeps the
// next tile's cp.async copies in flight while a tile is compared, and each
// tile's geometry is loaded two steps before its row ranges are needed
// (loaded one step before, the wait on it came to a device-memory latency
// a tile).  Two stages let three blocks of 256 pairs share an SM, which
// measured faster than three stages and two blocks (PERF.md, section 6).
//
// What a stage holds is the tile's staged inputs:
//   - K3 (`Columns`): the word rows of both (w, P) column inputs that the
//     tile's windows read (window.cuh pair_words, tile_spans, tile_rows,
//     stage_columns);
//   - K4 and T1: read2's (w, P) columns the same way, and read1's rows of a
//     row-major (n_rows, wt) table as a RowWindow of the first `wr` words
//     of each row, at an odd stride.  Which rows is the read1-window rule,
//     a template parameter:
//       `NearestRows` (K4, T2): up to 32 rows from the tile's least row over
//         its pairs with n > 0, no count;
//       `AnchoredRows` (T1): the rows of the tile inside the 64-row window
//         of its 1024-pair tile (csrc/window_staged.cu), every live pair
//         counted, n = 0 included; a row outside the window is read from
//         device memory and counted in `misses`.
//     A row outside the staged rows, or a word past the staged ones, is
//     read from device memory, so the result is exact for any rows1.
// A window whose words all lie in the staged words takes
// staged_window_equal (no bounds checks, one mask); any other the readers,
// which give 0 or read device memory.
//
// Not TMA: a tile's row ranges change from tile to tile (a box per row, or
// a tensor map per range), P % 4 != 0 rules out a tensor map for the
// columns, and the copy is spread over all the block's threads anyway;
// what matters is the bytes in flight, which cp.async gives.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace disco {
namespace ring {

constexpr int kStages = 2;           // the tile compared and kStages - 1 in flight
constexpr int kSlots = kStages + 2;  // tiles whose geometry is held
constexpr int kMaxTile = 256;        // pairs per tile, one thread each
// blocks an SM: the stages of three blocks fit at 17 words (K3) and 32 (K4)
constexpr int kBlocksPerSm = 3;
constexpr int kMaxWords = 256;       // widest staged column input or row
constexpr int kSmemBytes = 232448;   // shared memory a block may use (sm_90)
// tile_spans' scratch, one slot per stage (static shared memory)
constexpr int kSlotInts = 2 * 2 * 32;
constexpr int kScratchInts = kStages * kSlotInts;

struct Pair {
  int o1, o2, n, r1;
  int anchor;  // AnchoredRows: rows1 of the 1024-pair tile's first pair & ~3
  bool live;   // p < P
};

// K3: both rows arrive as (w, P) column inputs.
struct Columns {
  static constexpr bool kFetch = false;
  static constexpr bool kCount = false;
  static constexpr bool kAnchored = false;
  static constexpr int kRows = 0;
};

// K4, T2: read1's rows from up to kRows rows of the tile's least row over
// its pairs with n > 0.
struct NearestRows {
  static constexpr bool kFetch = true;
  static constexpr bool kCount = false;
  static constexpr bool kAnchored = false;
  static constexpr int kRows = 32;
  __device__ static TileSpan span(const Pair& q) {
    return q.live && q.n > 0 ? TileSpan{q.r1, q.r1} : no_span();
  }
  __device__ static TileSpan clip(TileSpan sp, const Pair&) { return sp; }
};

// T1: the tile's rows inside [a, a + 64), a = q.anchor, over every live
// pair (n = 0 included, as its count is), so a live pair's row is staged
// exactly when it lies in its 1024-pair tile's window (NearestRows' span
// skips n = 0 pairs, and would read the row of one at a tile's least or
// greatest row from device memory and count it).  The tile's span is
// cut to the window when it is reduced, so the compare needs no anchor
// (held in every slot, it cost 60 B of spills at the 80-register cap).
struct AnchoredRows {
  static constexpr bool kFetch = true;
  static constexpr bool kCount = true;
  static constexpr bool kAnchored = true;
  static constexpr int kRows = 64;
  __device__ static TileSpan span(const Pair& q) {
    return q.live ? TileSpan{q.r1, q.r1} : no_span();
  }
  __device__ static TileSpan clip(TileSpan sp, const Pair& q) {
    const int64_t a = q.anchor;
    return TileSpan{static_cast<int>(max64(sp.lo, a)),
                    static_cast<int>(min64(sp.hi, a + kRows - 1))};
  }
};

// Words of one stage: the staged column inputs (K3: a and b; K4, T1: b) of
// `words` rows and T columns, and (K4, T1) the read1 RowWindow of Rule::kRows
// rows of wr words at an odd stride.  A multiple of 4 words (T is a
// multiple of 32, kRows of 4), so every stage starts 16-B aligned.
template <class Rule>
__host__ __device__ constexpr int stage_words(int words, int wr, int T) {
  return Rule::kFetch ? words * T + Rule::kRows * (wr | 1) : 2 * words * T;
}

template <class Rule>
__device__ __forceinline__ Pair load_pair(int64_t tile, int T, int64_t P,
                                          const int32_t* __restrict__ o1,
                                          const int32_t* __restrict__ o2,
                                          const int32_t* __restrict__ n,
                                          const int32_t* __restrict__ rows1) {
  const int64_t p0 = tile * T, p = p0 + threadIdx.x;
  Pair q{0, 0, 0, 0, 0, p < P};
  if (q.live) {
    q.o1 = __ldg(o1 + p);
    q.o2 = __ldg(o2 + p);
    q.n = __ldg(n + p);
    if (Rule::kFetch) q.r1 = __ldg(rows1 + p);
  }
  // every thread of a live tile, so that all compute the same window
  if (Rule::kAnchored && p0 < P)
    q.anchor = __ldg(rows1 + (p0 & ~static_cast<int64_t>(kTilePairs - 1))) & ~3;
  return q;
}

// The tiles blockIdx.x, blockIdx.x + gridDim.x, ... of T = blockDim.x
// pairs (see the top of this file).  a: K3's read1 columns; table (n_rows,
// wt) and wr: K4's and T1's read1 rows and the words staged of each; b: the
// (w, P) read2 columns.  smem holds kStages stages of stage_words,
// scratch kScratchInts ints.  Rule::kCount: the live pairs whose row lies
// outside the staged rows are added to *misses.
template <class Rule>
__device__ __forceinline__ void compare_tiles(
    uint32_t* smem, int* scratch, const uint32_t* __restrict__ a,
    const uint32_t* __restrict__ table, int64_t n_rows, int wt, int wr,
    const uint32_t* __restrict__ b, int w,
    const int32_t* __restrict__ rows1, int64_t P,
    const int32_t* __restrict__ o1, const int32_t* __restrict__ o2,
    const int32_t* __restrict__ n, uint8_t* __restrict__ ok,
    unsigned long long* __restrict__ misses) {
  const int T = blockDim.x;
  const int sw = stage_words<Rule>(w, wr, T);
  const int64_t tiles = (P + T - 1) / T;
  const int64_t step = gridDim.x;
  const int64_t t0 = blockIdx.x;

  auto pair_of = [&](int64_t tile) {
    return load_pair<Rule>(tile, T, P, o1, o2, n, rows1);
  };
  // The tile's spans (K3: [0] the words read of a, [1] of b; K4, T1: [0]
  // the words read of b, [1] the rows of read1); every thread calls this
  // (one sync).
  auto spans_of = [&](const Pair& q, int slot, TileSpan(&out)[2]) {
    TileSpan mine[2];
    if constexpr (Rule::kFetch) {
      mine[0] = pair_words(q.o2, q.n, q.live);
      mine[1] = Rule::span(q);
    } else {
      mine[0] = pair_words(q.o1, q.n, q.live);
      mine[1] = pair_words(q.o2, q.n, q.live);
    }
    tile_spans<2>(mine, scratch + slot * kSlotInts, out);
    if constexpr (Rule::kFetch) out[1] = Rule::clip(out[1], q);
  };
  // K4, T1: the read1 rows staged, up to Rule::kRows from the (clipped)
  // span's least row
  auto window_of = [&](uint32_t* s, const TileSpan& r) {
    return row_window(s + w * T, r.lo, r.hi, Rule::kRows, n_rows, wr);
  };
  auto stage = [&](int slot, int64_t tile, const TileSpan(&sp)[2]) {
    uint32_t* s = smem + slot * sw;
    if constexpr (Rule::kFetch) {
      stage_columns(s, b, P, tile * T, tile_rows(sp[0], w));
      stage_rows(window_of(s, sp[1]), table, wt);
    } else {
      stage_columns(s, a, P, tile * T, tile_rows(sp[0], w));
      stage_columns(s + w * T, b, P, tile * T, tile_rows(sp[1], w));
    }
  };

  // Tile j of this block (t0 + j * step) keeps its geometry and spans in
  // slot j % kSlots and its rows in stage j % kStages.  Iteration j stages
  // tile j + kStages - 1, loads the geometry of tile j + kStages + 1 into
  // the slot tile j - 1 freed, and compares tile j: a tile's geometry
  // arrives two iterations before its spans are taken.  The loop is
  // unrolled over the slots, so a slot is a fixed set of registers.
  Pair g[kSlots];
  TileSpan sp[kSlots][2];
  int missed = 0;
#pragma unroll
  for (int j = 0; j < kSlots - 1; ++j) g[j] = pair_of(t0 + j * step);
#pragma unroll
  for (int j = 0; j + 1 < kStages; ++j) {
    spans_of(g[j], j, sp[j]);
    stage(j, t0 + j * step, sp[j]);
    cp_async_commit();
  }
  int slot = 0;  // the stage of tile j
  for (int64_t t = t0;; t += kSlots * step) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int64_t tile = t + j * step;
      if (tile >= tiles) {
        cp_async_wait<0>();
        if constexpr (Rule::kCount) add_count(missed, misses);
        return;
      }
      // tile j + kStages - 1 goes into the stage that tile j - 1 used:
      // every thread has passed that compare (spans_of syncs first)
      constexpr int kAhead = kStages - 1;
      const int ahead = slot == 0 ? kStages - 1 : slot - 1;
      const int ja = (j + kAhead) % kSlots;
      spans_of(g[ja], ahead, sp[ja]);
      stage(ahead, tile + kAhead * step, sp[ja]);
      cp_async_commit();
      g[(j + kSlots - 1) % kSlots] = pair_of(tile + (kSlots - 1) * step);
      cp_async_wait<kStages - 1>();
      __syncthreads();

      const Pair& q = g[j];
      uint32_t* s = smem + slot * sw;
      const int d1 = q.o1 >> 4, d2 = q.o2 >> 4;
      const int nw = (q.n >> 4) + ((q.n & 15) != 0);
      bool v;
      if constexpr (Rule::kFetch) {
        const RowWindow rw = window_of(s, sp[j][1]);
        const TileRows rb = tile_rows(sp[j][0], w);
        const int64_t k = static_cast<int64_t>(q.r1) - rw.base;
        const bool staged = k >= 0 && k < rw.rows;
        if constexpr (Rule::kCount) missed += q.live && !staged;
        if (q.n > 0 && staged && d1 >= 0 && d1 + nw < rw.ws &&
            d2 >= rb.lo && d2 + nw < rb.lo + rb.rows) {
          v = staged_window_equal(rw.smem + k * rw.stride + d1, 1,
                                  (q.o1 & 15) << 1,
                                  s + (d2 - rb.lo) * T + threadIdx.x, T,
                                  (q.o2 & 15) << 1, q.n);
        } else {
          v = window_equal(staged_row_at(rw, table, n_rows, wt, wt, q.r1),
                           q.o1, TileColumn{s + threadIdx.x, rb, T}, q.o2,
                           q.n);
        }
      } else {
        const TileRows ra = tile_rows(sp[j][0], w);
        const TileRows rb = tile_rows(sp[j][1], w);
        if (q.n > 0 && d1 >= ra.lo && d1 + nw < ra.lo + ra.rows &&
            d2 >= rb.lo && d2 + nw < rb.lo + rb.rows) {
          v = staged_window_equal(
              s + (d1 - ra.lo) * T + threadIdx.x, T, (q.o1 & 15) << 1,
              s + w * T + (d2 - rb.lo) * T + threadIdx.x, T,
              (q.o2 & 15) << 1, q.n);
        } else {
          v = window_equal(TileColumn{s + threadIdx.x, ra, T}, q.o1,
                           TileColumn{s + w * T + threadIdx.x, rb, T}, q.o2,
                           q.n);
        }
      }
      store_flags(ok, tile * T + threadIdx.x, P, v);
      slot = slot + 1 == kStages ? 0 : slot + 1;
    }
  }
}

// Pairs per tile: 256, or the largest multiple of 32 whose kStages stages
// fit a block's shared memory (32 for K3 at 256 words).  AnchoredRows takes
// a power of two, so that a tile lies inside one 1024-pair tile.
template <class Rule>
inline int tile_pairs(int words, int wr) {
  const int budget = (kSmemBytes - 4 * kScratchInts) / (4 * kStages);
  const int fixed = stage_words<Rule>(0, wr, 0);
  const int per_pair =
      stage_words<Rule>(words > 1 ? words : 1, wr, 1) - fixed;
  const int t = (budget - fixed) / per_pair;
  if (t >= kMaxTile) return kMaxTile;
  int tile = t / 32 * 32;
  if (Rule::kAnchored)
    while (tile & (tile - 1)) tile &= tile - 1;
  return tile;
}

// A persistent grid for `kernel` at `threads` threads and `smem` bytes of
// dynamic shared memory a block: as many blocks as fit on the card's SMs,
// but no more than `tiles`.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            int64_t tiles, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  *grid = static_cast<unsigned>(tiles < most ? tiles : most);
  return cudaSuccess;
}

// The launch shape of a tiled kernel: its tile, its dynamic shared memory,
// and its persistent grid.
template <class Rule, class Kernel>
cudaError_t tiled_shape(Kernel kernel, int words, int wr, int64_t P,
                        int* tile, size_t* smem, unsigned* grid) {
  if (words < 0 || words > kMaxWords || wr < 0 || wr > kMaxWords)
    return cudaErrorInvalidValue;
  *tile = tile_pairs<Rule>(words, wr);
  *smem = static_cast<size_t>(kStages) * 4 *
          stage_words<Rule>(words, wr, *tile);
  return persistent_grid(kernel, *tile, *smem, (P + *tile - 1) / *tile,
                         grid);
}

}  // namespace ring
}  // namespace disco

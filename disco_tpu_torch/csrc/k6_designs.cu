// Designs of K6's kernel (window_compare.cu window_compare_fetch_both),
// timed in turns with the kept kernel and its control by
// tools/exp_k6_designs.py.  None of them is on a path.  Each computes K6's
// function exactly: ok[p] = row rows1[p] @ o1[p] == row rows2[p] @ o2[p]
// over n[p] bases, for rows of the (n_rows, 16) pack_lines16 table, a row
// outside the table or a word past the row reading as 0.  A window that a
// design's fast path does not hold (more than 16 compared words, a word
// offset outside the row) takes the checked readers of window.cuh.
//
// The designs ask which of two things holds the direct kernel (one thread
// a pair, each compared word of both rows by its own 4-B load, stopping at
// the first mismatch) back:
//   (a) load wavefronts: a warp's 4-B load from 32 different rows costs
//       about one L1 wavefront a row;
//   (b) issue slots: the loads, their bounds checks and the compares, some
//       18 instructions a compared word.
// Staged designs (a warp copies its pairs' whole rows into shared memory by
// coalesced cp.async, 8 rows a 16-B instruction) cut (a); register designs
// (rows by 16-B loads, several pairs a thread) cut (b); the lanes designs
// (8 or 16 lanes a pair, one or two words a lane, reduced by __ballot_sync)
// put a warp's loads on 4 or 2 pairs' rows, cutting (a) at more
// instructions a pair.
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

using disco::kRow16Words;
using disco::kThreads;
using disco::row_words;
using disco::table_row;
using disco::window_equal;

constexpr int kWarps = kThreads / 32;

// The checked compare (window.cuh's readers), for any window.
__device__ __forceinline__ bool checked_equal(const uint32_t* table,
                                             int64_t n_rows, int r1, int r2,
                                             int o1, int o2, int n) {
  return window_equal(table_row(table, n_rows, kRow16Words, r1), o1,
                      table_row(table, n_rows, kRow16Words, r2), o2, n);
}

__device__ __forceinline__ int compared_words(int n) {
  return (n >> 4) + ((n & 15) != 0);
}

// Whether a window of nw compared words at word offset d lies in a staged
// row of 16 words and the zero word after it (words d .. d + nw).
__device__ __forceinline__ bool held_in_row(int d, int nw) {
  return d >= 0 && d + nw <= kRow16Words;
}

// ---------------------------------------------------------------------------
// Staged: a warp copies the rows its 32 pairs name into shared memory, then
// compares from there with staged_rows_equal (no early exit).
//
// Layout: slot s of a warp (a staged row) holds the row's 16 words at
// smem[s * kStride .. s * kStride + 15] and zeros at words 16 .. kStride - 1
// (the one-past word of a window that ends at the row's end).  A warp
// reading word w of 32 slots hits bank (s * kStride + w) mod 32:
//   - kStride 17 (odd): 32 distinct banks, no conflict; the copies are 4 B
//     (a 16-B copy needs a stride that is a multiple of 4 words);
//   - kStride 20: 20 s mod 32 takes 8 values, a 4-way conflict.  Any stride
//     that is a multiple of 4, or any swizzle of 16-B chunks within a row,
//     keeps word w on a bank = w mod 4, 8 banks in all, so 32 rows meet at
//     least a 4-way conflict (exp_k6_designs.bank_conflict states this and
//     tests/test_torch_k6_designs.py checks it).
// kMode: 0 both rows of every pair (64 slots); 1 read1's rows once a warp
// (a run of equal rows1, as the relabel gives, shares one slot), read2's as
// in 0; 2 read2's rows alone, read1's by row_words from device memory.
// ---------------------------------------------------------------------------
template <int kStride, bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads)
k6_staged_kernel(const uint32_t* __restrict__ table, int64_t n_rows,
                 const int32_t* __restrict__ rows1,
                 const int32_t* __restrict__ rows2, int64_t P,
                 const int32_t* __restrict__ o1,
                 const int32_t* __restrict__ o2,
                 const int32_t* __restrict__ n, uint8_t* __restrict__ ok) {
  static_assert(kStride > kRow16Words && (!kVec || kStride % 4 == 0),
                "a zero word after each row; 16-B aligned rows for 16-B "
                "copies");
  __shared__ __align__(16) uint32_t smem[kWarps][64 * kStride];
  __shared__ int slot_row[kWarps][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < P;
  const int r1 = live ? __ldg(rows1 + p) : -1;
  const int r2 = live ? __ldg(rows2 + p) : -1;
  const int a1 = live ? __ldg(o1 + p) : 0, a2 = live ? __ldg(o2 + p) : 0;
  const int len = live ? __ldg(n + p) : 0;
  uint32_t* s = smem[warp];
  int* rows = slot_row[warp];

  // the warp's slots: read1's in [0, n1), read2's in [32, 64)
  int slot1 = lane, n1 = 32;
  if (kMode == 1) {
    const int prev = __shfl_up_sync(0xFFFFFFFFu, r1, 1);
    const unsigned first = __ballot_sync(0xFFFFFFFFu, lane == 0 || r1 != prev);
    slot1 = __popc(first & (0xFFFFFFFFu >> (31 - lane))) - 1;
    n1 = __popc(first);
    if ((first >> lane) & 1) rows[slot1] = r1;
  } else if (kMode == 0) {
    rows[lane] = r1;
  } else {
    n1 = 0;
  }
  rows[32 + lane] = r2;
  __syncwarp();

  // copies: kVec 4 lanes a row (8 rows an instruction), else 32 lanes over
  // two rows; each row's zero words written by the lane of its last chunk
  constexpr int kPer = kVec ? 4 : kRow16Words;   // copies a row
  for (int c = lane; c < 64 * kPer; c += 32) {
    const int slot = c / kPer, q = c % kPer;
    if (slot >= n1 && slot < 32) continue;
    const int r = rows[slot];
    uint32_t* dst = s + slot * kStride;
    if (r >= 0 && r < n_rows) {
      const uint32_t* src = table + static_cast<int64_t>(r) * kRow16Words;
      if (kVec)
        disco::cp_async16(dst + 4 * q, src + 4 * q);
      else
        disco::cp_async4(dst + q, src + q);
    } else if (kVec) {
      *reinterpret_cast<uint4*>(dst + 4 * q) = make_uint4(0, 0, 0, 0);
    } else {
      dst[q] = 0;
    }
    if (q == kPer - 1)
      for (int w = kRow16Words; w < kStride; ++w) dst[w] = 0;
  }
  disco::cp_async_wait_all();
  __syncwarp();

  bool v = true;
  if (live && len > 0) {
    const int d1 = a1 >> 4, d2 = a2 >> 4, nw = compared_words(len);
    const int s1 = (a1 & 15) << 1, s2 = (a2 & 15) << 1;
    if (nw > kRow16Words || !held_in_row(d2, nw) ||
        (kMode != 2 && !held_in_row(d1, nw))) {
      v = checked_equal(table, n_rows, r1, r2, a1, a2, len);
    } else if (kMode != 2) {
      v = disco::staged_rows_equal<kRow16Words>(s + slot1 * kStride + d1, s1,
                                                s + (32 + lane) * kStride + d2,
                                                s2, len);
    } else {
      uint32_t a[20];
      row_words(table, n_rows, r1, d1, a);
      const uint32_t* pb = s + (32 + lane) * kStride + d2;
      const uint32_t last = 0xFFFFFFFFu << (2 * (16 * nw - len));
      uint32_t diff = 0, b_cur = pb[0];
#pragma unroll
      for (int i = 0; i < kRow16Words; ++i) {
        if (i < nw) {
          const uint32_t b_nxt = pb[i + 1];
          const uint32_t x = __funnelshift_l(a[i + 1], a[i], s1) ^
                             __funnelshift_l(b_nxt, b_cur, s2);
          diff |= i + 1 == nw ? x & last : x;
          b_cur = b_nxt;
        }
      }
      v = diff == 0;
    }
  }
  disco::store_flags(ok, p, P, v);
}

// ---------------------------------------------------------------------------
// Registers: kPairs consecutive pairs a thread, each row by row_words (16-B
// loads aligned in registers), no early exit, no shared memory.  <4, true,
// false, 4> is the kept kernel's body; the others change one thing:
// kStream (geometry by streaming loads, which leave L1 to the rows),
// kLimit (load only the chunks up to the window's last word), kBlocks (the
// blocks an SM the register budget is set for: 4 is 64 registers).
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool regs_equal(const uint32_t* table,
                                           int64_t n_rows, int r1, int r2,
                                           int o1, int o2, int n,
                                           bool limit) {
  if (n <= 0) return true;
  const int nw = compared_words(n);
  if (nw > kRow16Words) return checked_equal(table, n_rows, r1, r2, o1, o2, n);
  const int d1 = o1 >> 4, d2 = o2 >> 4;
  uint32_t a[20], b[20];
  row_words(table, n_rows, r1, d1, a, limit ? ((d1 & 3) + nw) / 4 + 1 : 5);
  row_words(table, n_rows, r2, d2, b, limit ? ((d2 & 3) + nw) / 4 + 1 : 5);
  const int s1 = (o1 & 15) << 1, s2 = (o2 & 15) << 1;
  const uint32_t last = 0xFFFFFFFFu << (2 * (16 * nw - n));
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < kRow16Words; ++i) {
    if (i < nw) {
      const uint32_t x = __funnelshift_l(a[i + 1], a[i], s1) ^
                         __funnelshift_l(b[i + 1], b[i], s2);
      diff |= i + 1 == nw ? x & last : x;
    }
  }
  return diff == 0;
}

template <int kPairs, bool kStream, bool kLimit, int kBlocks>
__global__ void __launch_bounds__(kThreads, kBlocks)
k6_regs_kernel(const uint32_t* __restrict__ table, int64_t n_rows,
               const int32_t* __restrict__ rows1,
               const int32_t* __restrict__ rows2, int64_t P,
               const int32_t* __restrict__ o1, const int32_t* __restrict__ o2,
               const int32_t* __restrict__ n, uint8_t* __restrict__ ok) {
  static_assert(kPairs == 1 || kPairs == 4, "one pair, or four by 16-B loads");
  const int64_t p =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPairs;
  if (p >= P) return;
  const int32_t* src[5] = {rows1, rows2, o1, o2, n};
  uintptr_t bits = reinterpret_cast<uintptr_t>(ok) & 3;
#pragma unroll
  for (int a = 0; a < 5; ++a) bits |= reinterpret_cast<uintptr_t>(src[a]) & 15;
  const bool vec = kPairs == 4 && bits == 0 && p + kPairs <= P;
  int g[5][kPairs];
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    if (vec) {
      const int4* q = reinterpret_cast<const int4*>(src[a] + p);
      const int4 x = kStream ? __ldcs(q) : __ldg(q);
      g[a][0] = x.x;
      g[a][kPairs > 1 ? 1 : 0] = x.y;
      g[a][kPairs > 2 ? 2 : 0] = x.z;
      g[a][kPairs > 3 ? 3 : 0] = x.w;
    } else {
#pragma unroll
      for (int m = 0; m < kPairs; ++m)
        g[a][m] = p + m < P ? (kStream ? __ldcs(src[a] + p + m)
                                       : __ldg(src[a] + p + m))
                            : 0;
    }
  }
  unsigned flags = 0;
#pragma unroll
  for (int m = 0; m < kPairs; ++m)
    flags |= static_cast<unsigned>(regs_equal(table, n_rows, g[0][m],
                                              g[1][m], g[2][m], g[3][m],
                                              g[4][m], kLimit))
             << (8 * m);
  if (vec) {
    *reinterpret_cast<uint32_t*>(ok + p) = flags;
  } else {
    for (int m = 0; m < kPairs && p + m < P; ++m)
      ok[p + m] = (flags >> (8 * m)) & 1;
  }
}

// ---------------------------------------------------------------------------
// Lanes: kLanes lanes a pair (8 or 16), lane g comparing window words g,
// g + kLanes, ... (two words a lane at 8, one at 16, for reads of 256 bp)
// through the checked readers, the group's verdict by one __ballot_sync.
// A warp's load then touches 4 or 2 pairs' rows, in runs of neighbouring
// words.
// ---------------------------------------------------------------------------
template <int kLanes>
__global__ void __launch_bounds__(kThreads)
k6_lanes_kernel(const uint32_t* __restrict__ table, int64_t n_rows,
                const int32_t* __restrict__ rows1,
                const int32_t* __restrict__ rows2, int64_t P,
                const int32_t* __restrict__ o1,
                const int32_t* __restrict__ o2,
                const int32_t* __restrict__ n, uint8_t* __restrict__ ok) {
  static_assert(kLanes == 8 || kLanes == 16, "8 or 16 lanes a pair");
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t p = t / kLanes;
  const int g = static_cast<int>(t % kLanes);
  bool bad = false;
  if (p < P) {
    const int len = __ldg(n + p);
    if (len > 0) {
      const int a1 = __ldg(o1 + p), a2 = __ldg(o2 + p);
      const auto ra = table_row(table, n_rows, kRow16Words, __ldg(rows1 + p));
      const auto rb = table_row(table, n_rows, kRow16Words, __ldg(rows2 + p));
      const int d1 = a1 >> 4, d2 = a2 >> 4, nw = compared_words(len);
      const int s1 = (a1 & 15) << 1, s2 = (a2 & 15) << 1;
      const uint32_t last = 0xFFFFFFFFu << (2 * (16 * nw - len));
#pragma unroll 2
      for (int wi = g; wi < nw; wi += kLanes) {
        const uint32_t x =
            __funnelshift_l(ra(d1 + wi + 1), ra(d1 + wi), s1) ^
            __funnelshift_l(rb(d2 + wi + 1), rb(d2 + wi), s2);
        bad |= (wi + 1 == nw ? x & last : x) != 0;
      }
    }
  }
  const unsigned votes = __ballot_sync(0xFFFFFFFFu, bad);
  const int lane = threadIdx.x & 31;
  const unsigned group = (kLanes == 32 ? 0xFFFFFFFFu : ((1u << kLanes) - 1u))
                         << (lane & ~(kLanes - 1));
  if (g == 0 && p < P) ok[p] = (votes & group) == 0;
}

// ---------------------------------------------------------------------------
// Runs: the direct kernel's body (one thread a pair, word by word, early
// exit) on a persistent grid whose blocks each walk one contiguous run of
// pairs, so that the band of read2 rows that neighbouring pairs share
// after the relabel stays in the SM's L1.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
k6_runs_kernel(const uint32_t* __restrict__ table, int64_t n_rows,
               const int32_t* __restrict__ rows1,
               const int32_t* __restrict__ rows2, int64_t P,
               const int32_t* __restrict__ o1, const int32_t* __restrict__ o2,
               const int32_t* __restrict__ n, uint8_t* __restrict__ ok,
               int64_t run) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * run;
  const int64_t end = start + run < P ? start + run : P;
  for (int64_t p = start + threadIdx.x; p < end; p += kThreads)
    ok[p] = checked_equal(table, n_rows, __ldg(rows1 + p), __ldg(rows2 + p),
                          __ldg(o1 + p), __ldg(o2 + p), __ldg(n + p));
}

using Kernel = void (*)(const uint32_t*, int64_t, const int32_t*,
                        const int32_t*, int64_t, const int32_t*,
                        const int32_t*, const int32_t*, uint8_t*);

// Design ids of tools/exp_k6_designs.py DESIGNS, in order; the runs design
// (kRuns) has its own launcher.
const Kernel kDesigns[] = {
    k6_staged_kernel<20, true, 0>,    // 0 staged16
    k6_staged_kernel<17, false, 0>,   // 1 staged4
    k6_staged_kernel<17, false, 1>,   // 2 staged4_read1_once
    k6_staged_kernel<20, true, 2>,    // 3 staged16_read2
    k6_regs_kernel<1, false, false, 4>,  // 4 regs_one_pair
    k6_regs_kernel<4, false, false, 4>,  // 5 regs_four_pairs
    k6_regs_kernel<4, true, true, 4>,    // 6 regs_limited
    k6_regs_kernel<4, true, false, 3>,   // 7 regs_3_blocks
    k6_regs_kernel<4, true, false, 2>,   // 8 regs_2_blocks
    k6_lanes_kernel<8>,               // 9 lanes8
    k6_lanes_kernel<16>,              // 10 lanes16
};
constexpr int kFixed = sizeof(kDesigns) / sizeof(kDesigns[0]);
constexpr int kRuns = kFixed;         // 11 runs

// Threads a design launches for P pairs.
int64_t threads_for(int design, int64_t P) {
  if (design >= 4 && design <= 8)
    return design == 4 ? P : (P + 3) / 4;
  if (design == 9) return 8 * P;
  if (design == 10) return 16 * P;
  return P;
}

cudaError_t runs_shape(int64_t P, unsigned* grid, int64_t* run) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k6_runs_kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  const int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *run = ((P + blocks - 1) / blocks + kThreads - 1) / kThreads * kThreads;
  *grid = static_cast<unsigned>((P + *run - 1) / *run);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int disco_k6_design_count() { return kRuns + 1; }

int disco_k6_design(int design, const void* table, int64_t n_rows,
                    const void* rows1, const void* rows2, int64_t P,
                    const void* o1, const void* o2, const void* n, void* ok,
                    void* stream) {
  if (design < 0 || design > kRuns) return cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const auto* t = static_cast<const uint32_t*>(table);
  const auto* r1 = static_cast<const int32_t*>(rows1);
  const auto* r2 = static_cast<const int32_t*>(rows2);
  const auto* g1 = static_cast<const int32_t*>(o1);
  const auto* g2 = static_cast<const int32_t*>(o2);
  const auto* len = static_cast<const int32_t*>(n);
  auto* out = static_cast<uint8_t*>(ok);
  auto* s = static_cast<cudaStream_t>(stream);
  if (design == kRuns) {
    unsigned grid;
    int64_t run;
    const cudaError_t e = runs_shape(P, &grid, &run);
    if (e != cudaSuccess) return static_cast<int>(e);
    k6_runs_kernel<<<grid, kThreads, 0, s>>>(t, n_rows, r1, r2, P, g1, g2,
                                             len, out, run);
  } else {
    kDesigns[design]<<<disco::blocks_for(threads_for(design, P)), kThreads,
                       0, s>>>(t, n_rows, r1, r2, P, g1, g2, len, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// A design kernel's registers, local (spilled) bytes a thread, static
// shared bytes a block, and resident blocks an SM.
int disco_k6_design_attrs(int design, int* regs, int* local_bytes,
                          int* smem_bytes, int* blocks_per_sm) {
  if (design < 0 || design > kRuns) return cudaErrorInvalidValue;
  const void* fn = design == kRuns ? reinterpret_cast<const void*>(
                                         k6_runs_kernel)
                                   : reinterpret_cast<const void*>(
                                         kDesigns[design]);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

}  // extern "C"

// Window checks and a row checksum that read their table rows from a staged
// row window (window.cuh: RowWindow), for NVIDIA Hopper (compiled for
// sm_90a).  Three kernels, one per TPU kernel they replace:
//
//   window_compare_staged_both  <- disco_tpu/overlap/fused_kernel.py::
//                                  verify_windows_fused_mxu_both (Pallas body
//                                  _mxu3_kernel, K5): both rows fetched from
//                                  one 32-word line table (relabeled rows),
//                                  compared over its first W_CMP = 24 words.
//   window_compare_staged       <- tools/exp_fetch_variants.py::verify_sync
//                                  (_sync_kernel, T1): read1's row from a
//                                  64-row window anchored at the tile's first
//                                  row & ~3; read2's row as (Wb, P) columns.
//   row_checksum_staged         <- tools/exp_mxu_fetch.py::main (closure
//                                  kern, T3): sum(word & 0x7FFF) over the
//                                  words of row rows[p] + salt, from a
//                                  32-row window at bases[tile] + salt.
//
// tools/exp_fetch_variants.py::verify_pipe_nc (T2) runs K4's Pallas body
// (_mxu2_kernel) without its guard; its Hopper kernel is K4's
// window_compare_fetch (window_compare.cu), which has no guard: one body,
// two call sites, one kernel.
//
// A block of kThreads threads takes a tile of kTilePairs = 1024 pairs, four
// a thread, strided so that a warp's loads of geometry stay coalesced.  It
// stages its window with cp.async, waits and syncs, then checks its pairs.
// This is what the TPU kernels do with their per-tile line windows (VMEM,
// scalar-prefetched block indices, make_async_copy); here a row outside the
// window is read from device memory and counted, so every result is exact
// without a span precondition or a fallback, and `misses` says how often
// the window missed.
//
// What bounds them on an H100: device-memory bytes, as for window_compare.cu
// (a funnel shift, an XOR and a compare per 16 bases of each pair).  Staging
// moves each distinct row of a tile once, from device memory or L2, into
// shared memory, where the tile's pairs re-read it without touching L1/L2
// again; a staged row's words past ws (the words a window inside its row can
// reach: Wp = n_words + 1 for packed reads) come from device memory.
//
// Shared memory, registers (ptxas -v, sm_90a) and occupancy (ws = 17 words,
// stride 17, 256 threads a block):
//   K5  read1 window 192 rows + read2 window 384 rows (the TPU's budgets:
//       3 and 6 blocks of 64 rows) = 576 x 17 x 4 B = 39,168 B a block,
//       room for 5 blocks an SM; 54 registers a thread allow 4: 1,024
//       threads an SM (50% of 2,048);
//   T1  64 rows = 4,352 B a block, 35 registers: 6 blocks, 1,536 threads
//       an SM (75%);
//   T3  32 rows = 2,176 B a block, 26 registers: 8 blocks, 2,048 threads
//       an SM (100%).
// Above 48 KB a launch first raises the kernel's dynamic shared memory
// limit; above the card's 227 KB it is refused.
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns the CUDA error of
// the launch (cudaGetLastError()).
#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

using disco::ColumnRow;
using disco::RowWindow;
using disco::add_count;
using disco::block_min_max;
using disco::cp_async_wait_all;
using disco::kThreads;
using disco::kTilePairs;
using disco::row_window;
using disco::stage_rows;
using disco::staged_row;
using disco::window_equal;

constexpr int kPerThread = kTilePairs / kThreads;
constexpr int kBothRows1 = 192;  // K5 read1 window (TPU: NB_A = 3 x 64)
constexpr int kBothRows2 = 384;  // K5 read2 window (TPU: NB_B = 6 x 64)
constexpr int kSyncRows = 64;    // T1 window (TPU: K_LINES = 16 lines of 4)
constexpr int kSumRows = 32;     // T3 window (TPU: K = 32)
constexpr int64_t kNoRow = INT64_MAX;

__device__ __forceinline__ int64_t pair_index(int k) {
  return static_cast<int64_t>(blockIdx.x) * kTilePairs + k * kThreads +
         threadIdx.x;
}

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

int disco_window_compare_staged(const void* table, int64_t n_rows, int wt,
                                int ws, const void* b, int wb,
                                const void* rows1, int64_t P, const void* o1,
                                const void* o2, const void* n, void* ok,
                                void* misses, void* stream) {
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

}  // extern "C"

// The designs of K1's rows route timed against the kept one
// (dual_compare.cu's dual_compare_rows, the kFused kernel of
// dual_rows.cuh) in turns, for NVIDIA Hopper (sm_90a): timing controls,
// launched by disco_tpu_torch/tools/exp_k1_rows_designs.py, on no path.
//
//   kScalar, kRowChunks, kLanes4, kLanes8, kLanes16: two kernels.  A
//     compaction (dual_live_lanes_kernel) writes every lane's flags and
//     appends each block's live lanes to a list in device memory with one
//     atomicAdd a block (the blocks' order in the list varies from run to
//     run; each live lane writes only its own flags, so the output does
//     not); then a check of that list on a persistent grid that reads the
//     count on the card: one thread a live lane reading its rows word by
//     word (kScalar) or through the aligned 16-B chunk that holds each
//     word (kRowChunks: a chunk that holds a word of the row lies in the
//     row's page, so the load cannot fault; words outside the row are
//     masked to 0), or a group of 4, 8 or 16 lanes a live lane whose loads
//     of a row are contiguous (kLanes*).  Each has the stages apart:
//     stage 1 the compaction alone, stage 2 the check of a list stage 1
//     left.
//   kDense: every lane in one pass, one thread a lane, no compaction.
//   kFusedLoop, kFused4: the kept kernel loading each row's words one by
//     one with an early exit, or four at a time.
//
// The launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "dual_rows.cuh"
#include "window.cuh"

namespace {

using disco::TableRow;
using disco::blocks_for;
using disco::kThreads;
using disco::table_row;
using disco::window_equal;
using disco::rows::Args;
using disco::rows::kTileLanes;
using disco::rows::kWarpLanes;
using disco::rows::list_live;
using disco::rows::live_mask;

enum Design {
  kScalar = 0, kRowChunks = 1, kLanes4 = 2, kLanes8 = 3, kLanes16 = 4,
  kDense = 5, kFusedLoop = 6, kFused4 = 7, kDesigns = 8
};

// Word w of a row of a row-major table, read through the aligned 16-B chunk
// that holds it; the last chunk read is kept, so a window's words cost one
// load every four words.  A word outside the row is 0 and loads nothing.
struct ChunkRow {
  const uint32_t* row;
  int words;
  mutable uintptr_t chunk = 0;   // address of the kept chunk; 0: none
  mutable uint4 c;
  __device__ __forceinline__ uint32_t operator()(int w) const {
    if (static_cast<unsigned>(w) >= static_cast<unsigned>(words)) return 0u;
    const uintptr_t a = reinterpret_cast<uintptr_t>(row + w);
    const uintptr_t at = a & ~static_cast<uintptr_t>(15);
    if (at != chunk) {
      c = __ldg(reinterpret_cast<const uint4*>(at));
      chunk = at;
    }
    const unsigned k = (a >> 2) & 3;
    return k == 0 ? c.x : k == 1 ? c.y : k == 2 ? c.z : c.w;
  }
};

// Both windows of lane p, one thread (kScalar, kRowChunks, kDense): its
// rows read by index, word by word (TableRow) or by 16-B chunks
// (ChunkRow), each compare stopping at its first mismatching word.
template <int kDesign>
__device__ __forceinline__ void check_lane(const Args& x, int64_t p,
                                           bool& e, bool& c) {
  const TableRow ra = table_row(x.table1, x.n1, x.wp, __ldg(x.rows1 + p));
  const TableRow rb = table_row(x.table2, x.n2, x.wp, __ldg(x.rows2 + p));
  const int e_n = __ldg(x.e_n + p), c_n = __ldg(x.c_n + p);
  if constexpr (kDesign == kRowChunks) {
    const ChunkRow ca{ra.row, ra.words}, cb{rb.row, rb.words};
    e = window_equal(ca, __ldg(x.e_o1 + p), cb, __ldg(x.e_o2 + p), e_n);
    const ChunkRow da{ra.row, ra.words}, db{rb.row, rb.words};
    c = window_equal(da, __ldg(x.c_o1 + p), db, 0, c_n);
  } else {
    e = window_equal(ra, __ldg(x.e_o1 + p), rb, __ldg(x.e_o2 + p), e_n);
    c = window_equal(ra, __ldg(x.c_o1 + p), rb, 0, c_n);
  }
}

// The listing designs' compaction: each warp takes 512 lanes, a block
// 4096, and appends its live lanes to the list with one atomicAdd a
// block.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dual_live_lanes_kernel(const int32_t* __restrict__ e_n,
                       const int32_t* __restrict__ c_n, int64_t P,
                       uint8_t* __restrict__ edge_ok,
                       uint8_t* __restrict__ cont_ok,
                       int32_t* __restrict__ live,
                       unsigned* __restrict__ n_live) {
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTileLanes +
                     static_cast<int64_t>(threadIdx.x >> 5) * kWarpLanes;
  const unsigned m =
      w0 < P ? live_mask<kVec>(e_n, c_n, w0, P, edge_ok + w0, cont_ok + w0)
             : 0u;
  list_live(
      m, w0,
      [n_live](unsigned count) {
        return count ? atomicAdd(n_live, count) : 0u;
      },
      [live](unsigned place, int64_t p, int) {
        live[place] = static_cast<int32_t>(p);
      });
}

// The check on the live list, on a persistent grid: the count is read on
// the card, so the host never waits for it.
template <int kDesign>
__global__ void __launch_bounds__(kThreads)
dual_compare_rows_kernel(Args x, const int32_t* __restrict__ live,
                         const unsigned* __restrict__ n_live) {
  const unsigned n = *n_live;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int64_t p = __ldg(live + i);
    bool e, c;
    check_lane<kDesign>(x, p, e, c);
    x.edge_ok[p] = e;
    x.cont_ok[p] = c;
  }
}

// The check by a group of G lanes a live lane (kLanes4, 8, 16): lane j of
// the group takes compared words j, j + G, ... of both windows, loading
// words d + i and d + i + 1 of each row, so that the group's loads of a
// row are contiguous.  No early exit; one __ballot_sync a window for the
// group.  A warp walks its groups of the list in step, so that every lane
// reaches the ballots.
template <int G>
__global__ void __launch_bounds__(kThreads)
dual_compare_rows_group_kernel(Args x, const int32_t* __restrict__ live,
                               const unsigned* __restrict__ n_live) {
  constexpr unsigned kGroups = 32 / G;
  const unsigned n = *n_live;
  const unsigned lane = threadIdx.x & 31, grp = lane / G, j = lane % G;
  const unsigned mine = ((1u << G) - 1u) << (grp * G);
  const unsigned stride = gridDim.x * (kThreads / 32) * kGroups;
  for (unsigned base = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
                       kGroups;
       base < n; base += stride) {
    const unsigned i = base + grp;
    const bool active = i < n;
    int64_t p = 0;
    int e_o1 = 0, e_o2 = 0, e_n = 0, c_o1 = 0, c_n = 0;
    TableRow ra{x.table1, 0}, rb{x.table2, 0};
    if (active) {
      p = __ldg(live + i);
      ra = table_row(x.table1, x.n1, x.wp, __ldg(x.rows1 + p));
      rb = table_row(x.table2, x.n2, x.wp, __ldg(x.rows2 + p));
      e_o1 = __ldg(x.e_o1 + p);
      e_o2 = __ldg(x.e_o2 + p);
      e_n = __ldg(x.e_n + p);
      c_o1 = __ldg(x.c_o1 + p);
      c_n = __ldg(x.c_n + p);
    }
    const int nwe = e_n > 0 ? (e_n + 15) >> 4 : 0;
    const int nwc = c_n > 0 ? (c_n + 15) >> 4 : 0;
    const uint32_t last_e = nwe ? 0xFFFFFFFFu << (2 * (16 * nwe - e_n)) : 0u;
    const uint32_t last_c = nwc ? 0xFFFFFFFFu << (2 * (16 * nwc - c_n)) : 0u;
    const int da = e_o1 >> 4, sa = (e_o1 & 15) << 1;
    const int db = e_o2 >> 4, sb = (e_o2 & 15) << 1;
    const int dc = c_o1 >> 4, sc = (c_o1 & 15) << 1;
    uint32_t diff_e = 0, diff_c = 0;
    for (int k = j; k < nwe || k < nwc; k += G) {
      if (k < nwe) {
        const uint32_t v = __funnelshift_l(ra(da + k + 1), ra(da + k), sa) ^
                           __funnelshift_l(rb(db + k + 1), rb(db + k), sb);
        diff_e |= k == nwe - 1 ? v & last_e : v;
      }
      if (k < nwc) {
        const uint32_t v = __funnelshift_l(ra(dc + k + 1), ra(dc + k), sc) ^
                           __funnelshift_l(rb(k + 1), rb(k), 0);
        diff_c |= k == nwc - 1 ? v & last_c : v;
      }
    }
    const unsigned bad_e = __ballot_sync(0xFFFFFFFFu, diff_e != 0) & mine;
    const unsigned bad_c = __ballot_sync(0xFFFFFFFFu, diff_c != 0) & mine;
    if (active && j == 0) {
      x.edge_ok[p] = bad_e == 0;
      x.cont_ok[p] = bad_c == 0;
    }
  }
}

// kDense: every lane in one pass, one thread a lane, no compaction.
__global__ void __launch_bounds__(kThreads)
dual_compare_rows_dense_kernel(Args x, int64_t P) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  bool e = true, c = true;
  if (__ldg(x.e_n + p) > 0 || __ldg(x.c_n + p) > 0)
    check_lane<kScalar>(x, p, e, c);
  x.edge_ok[p] = e;
  x.cont_ok[p] = c;
}

// As many blocks of `kernel` as the card holds at once.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, unsigned* most) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *most = static_cast<unsigned>(per_sm * sms);
  return cudaSuccess;
}

// The check on a persistent grid: as many blocks as the card holds, but
// no more than P lanes need at `lanes_a_block` lanes a block.
template <class Kernel>
cudaError_t launch_check(Kernel kernel, int64_t lanes_a_block,
                         const Args& x, int64_t P, const int32_t* live,
                         const unsigned* n_live, cudaStream_t stream) {
  unsigned most = 0;
  const cudaError_t e = resident_blocks(kernel, &most);
  if (e != cudaSuccess) return e;
  const int64_t need = (P + lanes_a_block - 1) / lanes_a_block;
  const unsigned grid = need < most ? static_cast<unsigned>(need) : most;
  kernel<<<grid, kThreads, 0, stream>>>(x, live, n_live);
  return cudaGetLastError();
}

cudaError_t check_list(int design, const Args& x, int64_t P,
                       const int32_t* live, const unsigned* n_live,
                       cudaStream_t stream) {
  switch (design) {
    case kScalar:
      return launch_check(dual_compare_rows_kernel<kScalar>, kThreads, x, P,
                          live, n_live, stream);
    case kRowChunks:
      return launch_check(dual_compare_rows_kernel<kRowChunks>, kThreads, x,
                          P, live, n_live, stream);
    case kLanes4:
      return launch_check(dual_compare_rows_group_kernel<4>, kThreads / 4, x,
                          P, live, n_live, stream);
    case kLanes8:
      return launch_check(dual_compare_rows_group_kernel<8>, kThreads / 8, x,
                          P, live, n_live, stream);
    case kLanes16:
      return launch_check(dual_compare_rows_group_kernel<16>, kThreads / 16,
                          x, P, live, n_live, stream);
  }
  return cudaErrorInvalidValue;
}

// stage: 0 the whole design, 1 the compaction alone (count zeroed), 2 the
// check alone on a list left by stage 1; only the listing designs have
// stages, and only they take `live` (P int32) and `n_live` (one).
cudaError_t run_design(int design, int stage, const Args& x, int64_t P,
                       int32_t* live, unsigned* n_live, cudaStream_t stream) {
  if (design == kDense || design == kFusedLoop || design == kFused4) {
    if (stage != 0) return cudaErrorInvalidValue;
    if (design == kFusedLoop)
      return disco::rows::launch_fused<0>(x, P, stream);
    if (design == kFused4) return disco::rows::launch_fused<4>(x, P, stream);
    dual_compare_rows_dense_kernel<<<blocks_for(P), kThreads, 0, stream>>>(
        x, P);
    return cudaGetLastError();
  }
  if (stage != 2) {
    cudaError_t e = cudaMemsetAsync(n_live, 0, sizeof(unsigned), stream);
    if (e != cudaSuccess) return e;
    const unsigned tiles =
        static_cast<unsigned>((P + kTileLanes - 1) / kTileLanes);
    if (disco::rows::vector_ok(x))
      dual_live_lanes_kernel<true><<<tiles, kThreads, 0, stream>>>(
          x.e_n, x.c_n, P, x.edge_ok, x.cont_ok, live, n_live);
    else
      dual_live_lanes_kernel<false><<<tiles, kThreads, 0, stream>>>(
          x.e_n, x.c_n, P, x.edge_ok, x.cont_ok, live, n_live);
    e = cudaGetLastError();
    if (e != cudaSuccess || stage == 1) return e;
  }
  return check_list(design, x, P, live, n_live, stream);
}

}  // namespace

extern "C" {

int disco_k1_rows_design_count() { return kDesigns; }

int disco_k1_rows_design(int design, int stage, const void* table1,
                         int64_t n1, const void* table2, int64_t n2, int wp,
                         const void* rows1, const void* rows2, int64_t P,
                         const void* e_o1, const void* e_o2, const void* e_n,
                         const void* c_o1, const void* c_n, void* edge_ok,
                         void* cont_ok, void* live, void* n_live,
                         void* stream) {
  if (P <= 0) return 0;
  if (P > INT32_MAX || wp < 0 || design < 0 || design >= kDesigns ||
      stage < 0 || stage > 2)
    return cudaErrorInvalidValue;
  return static_cast<int>(run_design(
      design, stage,
      disco::rows::make_args(table1, n1, table2, n2, wp, rows1, rows2, e_o1,
                             e_o2, e_n, c_o1, c_n, edge_ok, cont_ok),
      P, static_cast<int32_t*>(live), static_cast<unsigned*>(n_live),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"

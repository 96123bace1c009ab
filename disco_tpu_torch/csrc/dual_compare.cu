// Dual window check (edge + containment) for candidate read pairs, for
// NVIDIA Hopper (compiled for sm_90a).  Two kernels, one per TPU kernel
// they replace:
//
//   dual_compare        <- disco_tpu/overlap/fused_kernel.py::fused_compare_dual
//                          (Pallas body _dual_kernel): both rows arrive as
//                          pre-gathered (Wp, P) columns.
//   dual_compare_fetch  <- disco_tpu/overlap/fused_kernel.py::fused_compare_dual_mxu
//                          (Pallas body _mxu2_dual_kernel): read1's row is
//                          fetched inside the kernel from the row-major
//                          (2N, Wp) packed table; read2's row arrives as
//                          (Wb, P) columns, Wb >= Wp.
//
// For pair p:
//   edge_ok[p] = a[e_o1 : e_o1 + e_n] == b[e_o2 : e_o2 + e_n]
//   cont_ok[p] = a[c_o1 : c_o1 + c_n] == b[0 : c_n]
// over 2-bit bases packed 16 to a uint32 word, base i in bits
// [30 - 2(i%16), 32 - 2(i%16)) of word i/16.  A length of 0 gives true
// without reading any row word (invalid lanes carry n = 0 and untrusted
// offsets).  A word index outside the row reads as 0: the TPU kernels
// zero-fill their word rolls (fused_kernel.py::_roll_up).  Offsets split as
// o >> 4 (word) and (o & 15) << 1 (bit phase), as in _split_off.
//
// What bounds these kernels on an H100: device-memory bytes.  Per pair the
// work is a few funnel shifts, XORs and compares per 16 bases; the data is
// about Wp x 4 B of b's column per pair (dual_compare reads a's column as
// well, dual_compare_fetch reads read1's row) plus 20 B of window geometry.
// The design for that:
//   - one thread per pair, so the (Wp, P) column layout puts neighbouring
//     threads on neighbouring words: every column load is coalesced;
//   - each check reads only the ceil(n/16) + 1 words its window spans and
//     stops at the first mismatching word; n = 0 lanes, most of a
//     main-path batch, read only their geometry;
//   - the bit funnel is one __funnelshift_l per word and side;
//   - dual_compare_fetch: candidates arrive sorted by read1 (window-scan
//     order), so neighbouring threads read the same row and hit in L1/L2.
//     There is no span precondition and so no fallback: the TPU kernel's
//     128-row line window, its _mxu_prep guard and lax.cond fallback, and
//     the clip/offset mismatch of its block index (fused_kernel.py:417,768)
//     have no counterpart here.  A row index outside the table reads as a
//     row of zeros.  Staging a sorted tile's rows in shared memory is left
//     for later.
//
// Each launcher is a plain C function: it launches on the given stream,
// does not synchronise, allocates nothing, and returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

using disco::ColumnRow;
using disco::blocks_for;
using disco::kThreads;
using disco::table_row;
using disco::window_equal;

__global__ void __launch_bounds__(kThreads)
dual_compare_kernel(const uint32_t* __restrict__ a,
                    const uint32_t* __restrict__ b, int wp, int64_t P,
                    const int32_t* __restrict__ e_o1,
                    const int32_t* __restrict__ e_o2,
                    const int32_t* __restrict__ e_n,
                    const int32_t* __restrict__ c_o1,
                    const int32_t* __restrict__ c_n,
                    uint8_t* __restrict__ edge_ok,
                    uint8_t* __restrict__ cont_ok) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const ColumnRow ra{a + p, P, wp};
  const ColumnRow rb{b + p, P, wp};
  edge_ok[p] = window_equal(ra, e_o1[p], rb, e_o2[p], e_n[p]);
  cont_ok[p] = window_equal(ra, c_o1[p], rb, 0, c_n[p]);
}

__global__ void __launch_bounds__(kThreads)
dual_compare_fetch_kernel(const uint32_t* __restrict__ table, int64_t n_rows,
                          int wp, const uint32_t* __restrict__ b, int wb,
                          const int32_t* __restrict__ rows1, int64_t P,
                          const int32_t* __restrict__ e_o1,
                          const int32_t* __restrict__ e_o2,
                          const int32_t* __restrict__ e_n,
                          const int32_t* __restrict__ c_o1,
                          const int32_t* __restrict__ c_n,
                          uint8_t* __restrict__ edge_ok,
                          uint8_t* __restrict__ cont_ok) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const auto ra = table_row(table, n_rows, wp, rows1[p]);
  const ColumnRow rb{b + p, P, wb};
  edge_ok[p] = window_equal(ra, e_o1[p], rb, e_o2[p], e_n[p]);
  cont_ok[p] = window_equal(ra, c_o1[p], rb, 0, c_n[p]);
}

}  // namespace

extern "C" {

int disco_dual_compare(const void* a, const void* b, int wp, int64_t P,
                       const void* e_o1, const void* e_o2, const void* e_n,
                       const void* c_o1, const void* c_n, void* edge_ok,
                       void* cont_ok, void* stream) {
  if (P <= 0) return 0;
  dual_compare_kernel<<<blocks_for(P), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), wp, P,
      static_cast<const int32_t*>(e_o1), static_cast<const int32_t*>(e_o2),
      static_cast<const int32_t*>(e_n), static_cast<const int32_t*>(c_o1),
      static_cast<const int32_t*>(c_n), static_cast<uint8_t*>(edge_ok),
      static_cast<uint8_t*>(cont_ok));
  return static_cast<int>(cudaGetLastError());
}

int disco_dual_compare_fetch(const void* table, int64_t n_rows, int wp,
                             const void* b, int wb, const void* rows1,
                             int64_t P, const void* e_o1, const void* e_o2,
                             const void* e_n, const void* c_o1,
                             const void* c_n, void* edge_ok, void* cont_ok,
                             void* stream) {
  if (P <= 0) return 0;
  dual_compare_fetch_kernel<<<blocks_for(P), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), n_rows, wp,
      static_cast<const uint32_t*>(b), wb,
      static_cast<const int32_t*>(rows1), P,
      static_cast<const int32_t*>(e_o1), static_cast<const int32_t*>(e_o2),
      static_cast<const int32_t*>(e_n), static_cast<const int32_t*>(c_o1),
      static_cast<const int32_t*>(c_n), static_cast<uint8_t*>(edge_ok),
      static_cast<uint8_t*>(cont_ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

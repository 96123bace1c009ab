// K1's rows route (dual_compare.cu's dual_compare_rows, and the designs of
// k1_rows_designs.cu): the dual window check of the pair
// (table1[rows1[p]], table2[rows2[p]]) over row-major (R, Wp) tables, on
// the live lanes of a sparse grid (e_n > 0 or c_n > 0) only.  What the
// kernels share: their arguments, the compaction of a block's tile of
// lanes in shared memory, and the check of one live lane.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "window.cuh"

namespace disco {
namespace rows {

constexpr int kWarpLanes = 512;                              // a warp's lanes
constexpr int kTileLanes = kThreads / 32 * kWarpLanes;       // a block's

struct Args {
  const uint32_t* table1;
  int64_t n1;
  const uint32_t* table2;
  int64_t n2;
  int wp;
  const int32_t* rows1;
  const int32_t* rows2;
  const int32_t* e_o1;
  const int32_t* e_o2;
  const int32_t* e_n;
  const int32_t* c_o1;
  const int32_t* c_n;
  uint8_t* edge_ok;
  uint8_t* cont_ok;
};

inline Args make_args(const void* table1, int64_t n1, const void* table2,
                      int64_t n2, int wp, const void* rows1,
                      const void* rows2, const void* e_o1, const void* e_o2,
                      const void* e_n, const void* c_o1, const void* c_n,
                      void* edge_ok, void* cont_ok) {
  return Args{static_cast<const uint32_t*>(table1), n1,
              static_cast<const uint32_t*>(table2), n2, wp,
              static_cast<const int32_t*>(rows1),
              static_cast<const int32_t*>(rows2),
              static_cast<const int32_t*>(e_o1),
              static_cast<const int32_t*>(e_o2),
              static_cast<const int32_t*>(e_n),
              static_cast<const int32_t*>(c_o1),
              static_cast<const int32_t*>(c_n),
              static_cast<uint8_t*>(edge_ok), static_cast<uint8_t*>(cont_ok)};
}

inline bool aligned(const void* ptr, uintptr_t to) {
  return (reinterpret_cast<uintptr_t>(ptr) & (to - 1)) == 0;
}

// Every pointer the 16-B loads and stores of the lengths and flags touch
// is 16-B aligned.
inline bool vector_ok(const Args& x) {
  return aligned(x.e_n, 16) && aligned(x.c_n, 16) && aligned(x.edge_ok, 16) &&
         aligned(x.cont_ok, 16);
}

// window_equal with the words loaded kGroup compared words at a time:
// the 2 (kGroup + 1) loads of a group are issued together and the compare
// stops only between groups, so a window of up to kGroup words waits on
// one round trip to memory, where window_equal's word-by-word loop waits
// on one for each new sector of either row.
template <int kGroup>
__device__ __forceinline__ bool window_equal_grouped(const TableRow& a,
                                                     int o1,
                                                     const TableRow& b,
                                                     int o2, int n) {
  if (n <= 0) return true;
  const int d1 = o1 >> 4, s1 = (o1 & 15) << 1;
  const int d2 = o2 >> 4, s2 = (o2 & 15) << 1;
  const int nw = (n + 15) >> 4;
  for (int w0 = 0; w0 < nw; w0 += kGroup) {
    uint32_t xa[kGroup + 1], xb[kGroup + 1];
#pragma unroll
    for (int i = 0; i <= kGroup; ++i) {
      const bool in = w0 + i <= nw;
      xa[i] = in ? a(d1 + w0 + i) : 0u;
      xb[i] = in ? b(d2 + w0 + i) : 0u;
    }
    uint32_t diff = 0;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int rem = n - 16 * (w0 + i);
      const uint32_t mask =
          rem >= 16 ? 0xFFFFFFFFu
                    : rem > 0 ? 0xFFFFFFFFu << (2 * (16 - rem)) : 0u;
      diff |= (__funnelshift_l(xa[i + 1], xa[i], s1) ^
               __funnelshift_l(xb[i + 1], xb[i], s2)) & mask;
    }
    if (diff) return false;
  }
  return true;
}

// Both windows of live lane p, one thread, its rows read by index; the
// caller knows from the compaction which windows have a length (e_live,
// c_live), so only their geometry is loaded, every load issued at once: an
// edge-only lane (almost every live lane of the dist grid) reads five
// scattered words and not seven.  kGroup words at a time
// (window_equal_grouped), or word by word with an early exit for 0.
template <int kGroup>
__device__ __forceinline__ void check_live_lane(const Args& x, int64_t p,
                                                bool e_live, bool c_live,
                                                bool& e, bool& c) {
  const TableRow ra = table_row(x.table1, x.n1, x.wp, __ldg(x.rows1 + p));
  const TableRow rb = table_row(x.table2, x.n2, x.wp, __ldg(x.rows2 + p));
  int e_o1 = 0, e_o2 = 0, e_n = 0, c_o1 = 0, c_n = 0;
  if (e_live) {
    e_o1 = __ldg(x.e_o1 + p);
    e_o2 = __ldg(x.e_o2 + p);
    e_n = __ldg(x.e_n + p);
  }
  if (c_live) {
    c_o1 = __ldg(x.c_o1 + p);
    c_n = __ldg(x.c_n + p);
  }
  if constexpr (kGroup == 0) {
    e = window_equal(ra, e_o1, rb, e_o2, e_n);
    c = window_equal(ra, c_o1, rb, 0, c_n);
  } else {
    e = window_equal_grouped<kGroup>(ra, e_o1, rb, e_o2, e_n);
    c = window_equal_grouped<kGroup>(ra, c_o1, rb, 0, c_n);
  }
}

// A warp's 512 lanes [w0, w0 + 512) in four groups of 128: thread t
// holds lanes w0 + 128 g + 4 t + k, g, k in 0..3, so each of its four
// loads of e_n and of c_n is 16 B and the warp's are one contiguous 512 B.
// Bit 4 g + k of the result is set for e_n > 0, bit 16 + 4 g + k for
// c_n > 0; a live lane has either (`live_bits`).  Every lane's flags are
// written to fe[p - w0], fc[p - w0] (the warp's 512 flags, in device or
// shared memory), by one 4-B store a group: 1 for a dead lane, 0
// (overwritten by the check) for a live one.
template <bool kVec>
__device__ __forceinline__ unsigned live_mask(const int32_t* __restrict__ e_n,
                                              const int32_t* __restrict__ c_n,
                                              int64_t w0, int64_t P,
                                              uint8_t* fe, uint8_t* fc) {
  const int t = threadIdx.x & 31;
  unsigned m = 0;
  if (kVec && w0 + kWarpLanes <= P) {
    int4 a[4], b[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      a[g] = __ldcs(reinterpret_cast<const int4*>(e_n + w0 + 128 * g + 4 * t));
      b[g] = __ldcs(reinterpret_cast<const int4*>(c_n + w0 + 128 * g + 4 * t));
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const unsigned le = (a[g].x > 0) | (a[g].y > 0) << 1 |
                          (a[g].z > 0) << 2 | (a[g].w > 0) << 3;
      const unsigned lc = (b[g].x > 0) | (b[g].y > 0) << 1 |
                          (b[g].z > 0) << 2 | (b[g].w > 0) << 3;
      const unsigned live = le | lc;
      m |= le << (4 * g) | lc << (16 + 4 * g);
      uint32_t f = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) f |= (((live >> k) & 1u) ^ 1u) << (8 * k);
      *reinterpret_cast<unsigned*>(fe + 128 * g + 4 * t) = f;
      *reinterpret_cast<unsigned*>(fc + 128 * g + 4 * t) = f;
    }
  } else {
    for (int g = 0; g < 4; ++g)
      for (int k = 0; k < 4; ++k) {
        const int i = 128 * g + 4 * t + k;
        if (w0 + i >= P) continue;
        const bool le = e_n[w0 + i] > 0, lc = c_n[w0 + i] > 0;
        m |= static_cast<unsigned>(le) << (4 * g + k) |
             static_cast<unsigned>(lc) << (16 + 4 * g + k);
        fe[i] = !(le || lc);
        fc[i] = !(le || lc);
      }
  }
  return m;
}

__device__ __forceinline__ unsigned live_bits(unsigned m) {
  return (m | m >> 16) & 0xFFFFu;
}

// Lists the block's live lanes (live_bits(m) of each thread's live_mask,
// the warp's lanes from w0): returns the block's count, and calls
// put(place, lane, bit) for each live lane, `bit` its bit in `m`.  The
// places are `first(count)` (called by one thread) plus the live lanes of
// the block's earlier warps, of its warp's earlier groups, and of the
// group's earlier threads: within a block the list is in lane order.  The
// four groups' counts of a thread (at most 4 each, 128 a warp) ride in the
// four bytes of one int through one warp scan.  Every thread calls this.
template <class First, class Put>
__device__ __forceinline__ unsigned list_live(unsigned m_bits, int64_t w0,
                                              First first, Put put) {
  __shared__ unsigned warp_base[kThreads / 32];
  __shared__ unsigned block_first, block_count;
  const unsigned m = live_bits(m_bits);
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned packed = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    packed |= static_cast<unsigned>(__popc((m >> (4 * g)) & 15u)) << (8 * g);
  unsigned incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= static_cast<unsigned>(d)) incl += y;
  }
  const unsigned totals = __shfl_sync(0xFFFFFFFFu, incl, 31);
  if (lane == 31)
    warp_base[warp] = (totals & 255u) + ((totals >> 8) & 255u) +
                      ((totals >> 16) & 255u) + (totals >> 24);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const unsigned s = warp_base[w];
      warp_base[w] = total;
      total += s;
    }
    block_count = total;
    block_first = first(total);
  }
  __syncthreads();
  const unsigned excl = incl - packed;
  unsigned before = block_first + warp_base[warp];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    unsigned place = before + ((excl >> (8 * g)) & 255u);
    for (unsigned mg = (m >> (4 * g)) & 15u; mg; mg &= mg - 1) {
      const int k = __ffs(mg) - 1;
      put(place++, w0 + 128 * g + 4 * lane + k, 4 * g + k);
    }
    before += (totals >> (8 * g)) & 255u;
  }
  return block_count;
}

// K1's rows route in one kernel, a block a tile of 4096 lanes.  The block
// lists its live lanes in shared memory (list_live, no atomics: the list
// and the output are the same every run), builds the tile's flags there,
// checks its live lanes one thread each (check_live_lane, kGroup words at
// a time), and writes the flags out by 16-B stores: the flags of a live
// lane are never written to device memory alone.  While one block waits
// on its rows, the SM streams other blocks' lengths.
template <bool kVec, int kGroup>
__global__ void __launch_bounds__(kThreads)
dual_compare_rows_fused_kernel(Args x, int64_t P) {
  // a live lane's place in the tile | e_live << 12 | c_live << 13
  __shared__ int16_t ids[kTileLanes];
  __shared__ __align__(16) uint8_t fe[kTileLanes];
  __shared__ __align__(16) uint8_t fc[kTileLanes];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTileLanes;
  const int o0 = (threadIdx.x >> 5) * kWarpLanes;
  const unsigned m = b0 + o0 < P ? live_mask<kVec>(x.e_n, x.c_n, b0 + o0, P,
                                                   fe + o0, fc + o0)
                                 : 0u;
  const unsigned n = list_live(
      m, o0, [](unsigned) { return 0u; },
      [&](unsigned place, int64_t i, int bit) {
        ids[place] = static_cast<int16_t>(i | ((m >> bit) & 1u) << 12 |
                                          ((m >> (16 + bit)) & 1u) << 13);
      });
  __syncthreads();
  for (unsigned i = threadIdx.x; i < n; i += kThreads) {
    const int id = ids[i], o = id & (kTileLanes - 1);
    bool e, c;
    check_live_lane<kGroup>(x, b0 + o, id >> 12 & 1, id >> 13 & 1, e, c);
    fe[o] = e;
    fc[o] = c;
  }
  __syncthreads();
  if (kVec && b0 + kTileLanes <= P) {
    const int o = 16 * threadIdx.x;
    __stcs(reinterpret_cast<uint4*>(x.edge_ok + b0 + o),
           *reinterpret_cast<const uint4*>(fe + o));
    __stcs(reinterpret_cast<uint4*>(x.cont_ok + b0 + o),
           *reinterpret_cast<const uint4*>(fc + o));
  } else {
    for (int o = threadIdx.x; o < kTileLanes && b0 + o < P; o += kThreads) {
      x.edge_ok[b0 + o] = fe[o];
      x.cont_ok[b0 + o] = fc[o];
    }
  }
}

template <int kGroup>
cudaError_t launch_fused(const Args& x, int64_t P, cudaStream_t stream) {
  const unsigned tiles =
      static_cast<unsigned>((P + kTileLanes - 1) / kTileLanes);
  if (vector_ok(x))
    dual_compare_rows_fused_kernel<true, kGroup>
        <<<tiles, kThreads, 0, stream>>>(x, P);
  else
    dual_compare_rows_fused_kernel<false, kGroup>
        <<<tiles, kThreads, 0, stream>>>(x, P);
  return cudaGetLastError();
}

}  // namespace rows
}  // namespace disco

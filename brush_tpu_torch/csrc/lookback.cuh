// Single-pass chained scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA,
// 2016), shared by the row scan (csrc/scan.cu) and the segmented fill
// (csrc/fill.cu).
//   * `claim_tile`: each block takes the next tile from an atomic counter,
//     so a block only waits on tiles that have started, whatever order the
//     hardware runs blocks in.
//   * `scan_tile`: the block scans its tile of kThreads x kVecs 4-lane
//     vectors in registers and warp shuffles (thread t's vector k holds
//     lanes warp * 128 * kVecs + 128 k + 4 (t % 32) .. + 3 of the tile) and
//     publishes the tile's aggregate in its status word: flag in the high
//     32 bits, value bits in the low 32, so one 64-bit load sees both. One
//     warp then walks back over the predecessors' status words, 32 at a
//     time, combining aggregates until it meets an inclusive prefix (a
//     row's first tile publishes one at once), and publishes its own
//     inclusive prefix.
// The counter and the status words are the caller's scratch, zeroed by a
// cudaMemsetAsync on the same stream before the launch: scratch[0] is the
// counter, and a row's status words follow, one a tile.
#pragma once

#include <climits>

#include "common.cuh"

namespace lookback {

constexpr unsigned kFull = 0xffffffffu;

// Status word of a tile: 0 until the tile publishes; then its aggregate or
// its inclusive prefix (the row's scan up to and including the tile).
constexpr uint64_t kAggregate = 1ull << 32;
constexpr uint64_t kPrefix = 2ull << 32;

// A scan: element type, identity, combine and the 32-bit pattern the
// status word carries. The row scan adds its own sums (csrc/scan.cu).
struct MaxI32 {
  using T = int32_t;
  static __device__ __forceinline__ T identity() { return INT_MIN; }
  static __device__ __forceinline__ T combine(T a, T b) { return a > b ? a : b; }
  static __device__ __forceinline__ uint32_t bits(T v) {
    return static_cast<uint32_t>(v);
  }
  static __device__ __forceinline__ T from_bits(uint32_t b) {
    return static_cast<T>(b);
  }
};

// Status words are read and written whole, relaxed at device scope: the
// value travels in the same word as its flag, so no fence is needed.
__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

template <typename Op>
__device__ __forceinline__ typename Op::T warp_inclusive(typename Op::T v,
                                                         int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const typename Op::T n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = Op::combine(n, v);
  }
  return v;
}

// The combine of all 32 lanes' values, in every lane.
template <typename Op>
__device__ __forceinline__ typename Op::T warp_all(typename Op::T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = Op::combine(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

// Exclusive prefix of tile `t` (> 0) of a row whose status words start at
// `row_status`, by one whole warp. Lane l reads the tile l + 1 + back before
// t; lanes before the row's first tile read as an inclusive identity.
template <typename Op>
__device__ typename Op::T look_back(const uint64_t* row_status, int t,
                                    int lane) {
  using T = typename Op::T;
  T prefix = Op::identity();
  for (int back = 0;; back += 32) {
    const int i = t - 1 - lane - back;
    uint64_t w;
    for (;;) {
      w = i >= 0 ? load_status(row_status + i)
                 : (kPrefix | Op::bits(Op::identity()));
      if (__all_sync(kFull, (w >> 32) != 0)) break;
      __nanosleep(20);
    }
    const T v = Op::from_bits(static_cast<uint32_t>(w));
    const unsigned done = __ballot_sync(kFull, (w >> 32) == 2);
    if (done != 0) {
      // The nearest inclusive prefix and the aggregates after it.
      const int stop = __ffs(done) - 1;
      return Op::combine(warp_all<Op>(lane <= stop ? v : Op::identity()),
                         prefix);
    }
    prefix = Op::combine(warp_all<Op>(v), prefix);
  }
}

// The block's tile, from the counter at `counter` (every thread gets it).
__device__ __forceinline__ unsigned claim_tile(unsigned long long* counter) {
  __shared__ unsigned s_tile;
  if (threadIdx.x == 0) {
    s_tile = static_cast<unsigned>(atomicAdd(counter, 1ull));
  }
  __syncthreads();
  return s_tile;
}

// Inclusive scan of tile `t` of a row whose status words start at
// `row_status`, held as v[k][j] (lane 4 (t % 32) + j of the warp's k-th
// vector, in the layout above): on return each v[k][j] holds the combine
// of the row's lanes up to and including it.
template <typename Op, int kThreads, int kVecs>
__device__ __forceinline__ void scan_tile(typename Op::T (&v)[kVecs][4],
                                          uint64_t* row_status, int t) {
  using T = typename Op::T;
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && kWarps <= 32,
                "one warp scans the warps' totals");
  __shared__ T s_warp[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Scan within the warp: each vector's exclusive prefix among the warp's
  // lanes, and the warp's total.
  T pre[kVecs];
  T carry = Op::identity();
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const T s = Op::combine(Op::combine(v[k][0], v[k][1]),
                            Op::combine(v[k][2], v[k][3]));
    const T incl = warp_inclusive<Op>(s, lane);
    T excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = Op::identity();
    pre[k] = Op::combine(carry, excl);
    carry = Op::combine(carry, __shfl_sync(kFull, incl, 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    // The warps' totals -> each warp's exclusive prefix and the tile's
    // aggregate; then the tile's own prefix from its predecessors.
    const T wincl = warp_inclusive<Op>(
        lane < kWarps ? s_warp[lane] : Op::identity(), lane);
    const T aggregate = __shfl_sync(kFull, wincl, kWarps - 1);
    T wexcl = __shfl_up_sync(kFull, wincl, 1);
    if (lane == 0) wexcl = Op::identity();
    T tile_prefix = Op::identity();
    if (t == 0) {
      if (lane == 0) store_status(row_status, kPrefix | Op::bits(aggregate));
    } else {
      if (lane == 0) {
        store_status(row_status + t, kAggregate | Op::bits(aggregate));
      }
      tile_prefix = look_back<Op>(row_status, t, lane);
      if (lane == 0) {
        store_status(row_status + t,
                     kPrefix | Op::bits(Op::combine(tile_prefix, aggregate)));
      }
    }
    if (lane < kWarps) s_warp[lane] = Op::combine(tile_prefix, wexcl);
  }
  __syncthreads();
  const T warp_prefix = s_warp[warp];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    T run = Op::combine(warp_prefix, pre[k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run = Op::combine(run, v[k][j]);
      v[k][j] = run;
    }
  }
}

}  // namespace lookback

// Inclusive scan along each row of a row-major [rows, len] matrix: sum over
// int32, sum over float32, or running max over int32.
//
// Replaces brush_tpu/ops/scan_pallas.py:43 `_scan_kernel` (sum and max
// ops), reached through `cumsum_rows` and `cummax_1d`. The TPU kernel
// carries the running value from one grid step to the next; Hopper blocks
// run in parallel and in no order, so nothing can be carried in a block.
// One launch instead: a single-pass chained scan with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA, 2016):
//   * Each block takes the next tile of kTile lanes from an atomic counter,
//     so a block only waits on tiles that have started, whatever order the
//     hardware runs blocks in. Tiles are numbered row-major over
//     [rows, tiles_per_row].
//   * The block loads its tile (16-byte vectors wherever a row's vector
//     lies inside the row; a row's tiles start at the 16-byte boundary at
//     or before its first lane, so rows of any length vectorise; scalar
//     loads for the partial vectors at a row's two ends), scans it in
//     registers and warp shuffles, and publishes the tile's aggregate in
//     its status word: flag in the high 32 bits, value bits in the low 32,
//     so one 64-bit load sees both.
//   * One warp then walks back over the predecessors' status words, 32 at
//     a time, summing aggregates until it meets an inclusive prefix (a
//     row's first tile publishes one at once), publishes its own inclusive
//     prefix, and the block writes the tile.
// The status words and the counter are the caller's scratch, reset by a
// cudaMemsetAsync on the same stream in the same C call: one memset and
// one scan launch a call.
// Bound on the H100: bytes. The function must read and write 4 bytes per
// element, and that is all this kernel moves (the status words are one
// 8-byte word per 10,240-lane tile). Integer sums wrap modulo 2^32, as int32 sums
// do in XLA and PyTorch, and the max is exact, so both match their plain
// versions bit for bit. The float sum adds in another order than a
// sequential sum (within a thread, across a warp, across the block, and
// the tile prefixes in whatever order the look-back met them, which depends
// on timing): it may differ from run to run, and from `torch.cumsum` by
// rounding, within a few ulps of the running sum of |x|.
#include <climits>

#include "common.cuh"

namespace {

// Tile shape, as tuned on the H100 (PERF.md, section 6): 256 threads of
// 10 vectors (119 registers, 2 blocks an SM) read 4-7 % faster than 8
// vectors and 19-23 % faster than 4 at 30M lanes and [11, 6.1M].
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 10;                      // 4-lane vectors a thread
static_assert(kThreads % 32 == 0 && kWarps <= 32,
              "one warp scans the warps' totals");
constexpr int kWarpLanes = 32 * 4 * kVecs;     // lanes a warp scans
constexpr int kTile = kThreads * 4 * kVecs;    // lanes a block scans
constexpr unsigned kFull = 0xffffffffu;

// Status word of a tile: 0 until the tile publishes; then its aggregate or
// its inclusive prefix (the row's scan up to and including the tile).
constexpr uint64_t kAggregate = 1ull << 32;
constexpr uint64_t kPrefix = 2ull << 32;

// The three scans: element type, identity, combine and the 32-bit pattern
// the status word carries. The int32 sum works on uint32 words so that
// overflow wraps instead of being undefined.
struct SumU32 {
  using T = uint32_t;
  static __device__ __forceinline__ T identity() { return 0u; }
  static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
  static __device__ __forceinline__ uint32_t bits(T v) { return v; }
  static __device__ __forceinline__ T from_bits(uint32_t b) { return b; }
};
struct SumF32 {
  using T = float;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
  static __device__ __forceinline__ uint32_t bits(T v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ T from_bits(uint32_t b) {
    return __uint_as_float(b);
  }
};
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

template <typename Op>
__device__ __forceinline__ void load4(const typename Op::T* p, bool vec,
                                      int64_t pos, int64_t len,
                                      typename Op::T (&v)[4]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + pos);
    v[0] = Op::from_bits(u.x);
    v[1] = Op::from_bits(u.y);
    v[2] = Op::from_bits(u.z);
    v[3] = Op::from_bits(u.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t q = pos + j;
      v[j] = (q >= 0 && q < len) ? p[q] : Op::identity();
    }
  }
}

template <typename Op>
__device__ __forceinline__ void store4(typename Op::T* p, bool vec,
                                       int64_t pos, int64_t len,
                                       const typename Op::T (&v)[4]) {
  if (vec) {
    *reinterpret_cast<uint4*>(p + pos) =
        make_uint4(Op::bits(v[0]), Op::bits(v[1]), Op::bits(v[2]),
                   Op::bits(v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t q = pos + j;
      if (q >= 0 && q < len) p[q] = v[j];
    }
  }
}

// kVec: x and out share their alignment modulo 16 bytes, so a row's lanes
// can be read and written as 16-byte vectors from the same boundary.
template <typename Op, bool kVec>
__global__ void __launch_bounds__(kThreads)
scan_rows_kernel(const typename Op::T* __restrict__ x,
                 typename Op::T* __restrict__ out,
                 unsigned long long* __restrict__ scratch, int64_t len,
                 int tiles_per_row) {
  using T = typename Op::T;
  __shared__ unsigned s_tile;
  __shared__ T s_warp[kWarps];
  if (threadIdx.x == 0) {
    s_tile = static_cast<unsigned>(atomicAdd(scratch, 1ull));
  }
  __syncthreads();
  const int64_t row = s_tile / tiles_per_row;
  const int t = static_cast<int>(s_tile % tiles_per_row);
  uint64_t* row_status =
      reinterpret_cast<uint64_t*>(scratch) + 1 + row * tiles_per_row;
  const T* xr = x + row * len;
  T* orow = out + row * len;
  // Lanes between the 16-byte boundary at or before the row's first lane
  // and that lane: the row's tile 0 starts there.
  const int64_t head =
      kVec ? static_cast<int64_t>((reinterpret_cast<uintptr_t>(xr) >> 2) & 3)
           : 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Vector k of this thread: 4 lanes at pos0 + 128 k (a warp's k-th load
  // reads 512 contiguous bytes).
  const int64_t pos0 = static_cast<int64_t>(t) * kTile - head +
                       warp * kWarpLanes + lane * 4;

  T v[kVecs][4];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t pos = pos0 + 128 * k;
    load4<Op>(xr, kVec && pos >= 0 && pos + 3 < len, pos, len, v[k]);
  }
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
    const int64_t pos = pos0 + 128 * k;
    T run = Op::combine(warp_prefix, pre[k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      run = Op::combine(run, v[k][j]);
      v[k][j] = run;
    }
    store4<Op>(orow, kVec && pos >= 0 && pos + 3 < len, pos, len, v[k]);
  }
}

inline int64_t tiles_per_row(int64_t len) {
  return (len + 3 + kTile - 1) / kTile;
}

template <typename Op>
int scan_rows(const void* x, void* out, void* scratch, int64_t scratch_words,
              int rows, int64_t len, void* stream) {
  using T = typename Op::T;
  if (rows <= 0 || len <= 0) return 0;
  const int64_t tpr = tiles_per_row(len);
  const int64_t tiles = tpr * rows;
  if (tiles > 0x7fffffffLL || scratch_words < tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(uint64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  const bool vec = (xa & 15) == (oa & 15) && (xa & 3) == 0;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  auto* sp = static_cast<unsigned long long*>(scratch);
  const unsigned grid = static_cast<unsigned>(tiles);
  if (vec) {
    scan_rows_kernel<Op, true><<<grid, kThreads, 0, st>>>(
        xp, op, sp, len, static_cast<int>(tpr));
  } else {
    scan_rows_kernel<Op, false><<<grid, kThreads, 0, st>>>(
        xp, op, sp, len, static_cast<int>(tpr));
  }
  return brush_last_error();
}

}  // namespace

// Lanes a tile covers; a row has ceil((len + 3) / tile) tiles, and the
// scratch holds one 8-byte status word a tile plus the tile counter.
BRUSH_EXPORT int brush_scan_tile_items() { return kTile; }

// x, out: [rows, len] contiguous, 4-byte elements. scratch: scratch_words
// 8-byte words, at least rows * ceil((len + 3) / tile) + 1; the call
// clears what it uses.
BRUSH_EXPORT int brush_scan_rows_i32(const void* x, void* out, void* scratch,
                                     int64_t scratch_words, int rows,
                                     int64_t len, void* stream) {
  return scan_rows<SumU32>(x, out, scratch, scratch_words, rows, len, stream);
}

BRUSH_EXPORT int brush_scan_rows_f32(const void* x, void* out, void* scratch,
                                     int64_t scratch_words, int rows,
                                     int64_t len, void* stream) {
  return scan_rows<SumF32>(x, out, scratch, scratch_words, rows, len, stream);
}

BRUSH_EXPORT int brush_scan_rows_max_i32(const void* x, void* out,
                                         void* scratch, int64_t scratch_words,
                                         int rows, int64_t len, void* stream) {
  return scan_rows<MaxI32>(x, out, scratch, scratch_words, rows, len, stream);
}

// Inclusive scan along each row of a row-major [rows, len] matrix: sum over
// int32, sum over float32, or running max over int32.
//
// Replaces brush_tpu/ops/scan_pallas.py:43 `_scan_kernel` (sum and max
// ops), reached through `cumsum_rows` and `cummax_1d`. The TPU kernel
// carries the running value from one grid step to the next; Hopper blocks
// run in parallel and in no order, so nothing can be carried between them.
// Three passes instead:
//   1. each block scans its chunk of kChunk elements and writes the
//      chunk total;
//   2. one block per row scans the chunk totals (exclusive);
//   3. each block combines its chunk's offset into its elements.
// Bound on the H100: bytes. The function must read and write 4 bytes per
// element; passes 1 and 3 move 12 bytes per element, the chunk totals are
// negligible. Integer sums wrap modulo 2^32, as int32 sums do in XLA and
// PyTorch, and the max is exact, so both match their plain versions bit for
// bit. The float sum adds in another order than a sequential sum (within a
// thread, across a warp, across the block, across chunks), so it differs
// from `torch.cumsum` by rounding: at most a few ulps of the running sum
// of |x|.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;  // elements per block in pass 1

// The three scans: element type, identity and combine. The int32 sum works
// on uint32 words so that overflow wraps instead of being undefined.
struct SumU32 {
  using T = uint32_t;
  static __device__ __forceinline__ T identity() { return 0u; }
  static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
};
struct SumF32 {
  using T = float;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  static __device__ __forceinline__ T combine(T a, T b) { return a + b; }
};
struct MaxI32 {
  using T = int32_t;
  static __device__ __forceinline__ T identity() { return INT_MIN; }
  static __device__ __forceinline__ T combine(T a, T b) { return a > b ? a : b; }
};

// Inclusive scan of one value per thread across the block. `warp_vals` is
// shared scratch of at least blockDim.x / 32 entries; blockDim.x must be a
// multiple of 32.
template <typename Op>
__device__ __forceinline__ typename Op::T block_scan(typename Op::T v,
                                                     typename Op::T* warp_vals) {
  using T = typename Op::T;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T n = __shfl_up_sync(full, v, off);
    if (lane >= off) v = Op::combine(n, v);
  }
  __syncthreads();  // warp_vals may still be read by a previous call
  if (lane == 31) warp_vals[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? warp_vals[lane] : Op::identity();
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T n = __shfl_up_sync(full, w, off);
      if (lane >= off) w = Op::combine(n, w);
    }
    if (lane < nwarps) warp_vals[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = Op::combine(warp_vals[warp - 1], v);
  return v;
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
scan_chunks_kernel(const typename Op::T* __restrict__ x,
                   typename Op::T* __restrict__ out,
                   typename Op::T* __restrict__ chunk_vals, int64_t len,
                   int nchunks) {
  using T = typename Op::T;
  __shared__ T warp_vals[kThreads / 32];
  const int64_t row = blockIdx.y;
  const int64_t c = blockIdx.x;
  const int64_t first = c * kChunk + static_cast<int64_t>(threadIdx.x) * kItems;
  const T* xr = x + row * len;
  T* orow = out + row * len;

  T v[kItems];
  T total = Op::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t pos = first + i;
    v[i] = pos < len ? xr[pos] : Op::identity();
    total = Op::combine(total, v[i]);
  }
  const T incl = block_scan<Op>(total, warp_vals);
  // Exclusive prefix of this thread: the inclusive value of the thread
  // before it (a max has no inverse to subtract `total` with).
  T run = __shfl_up_sync(0xffffffffu, incl, 1);
  if ((threadIdx.x & 31) == 0) {
    run = threadIdx.x == 0 ? Op::identity() : warp_vals[(threadIdx.x >> 5) - 1];
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = Op::combine(run, v[i]);
    const int64_t pos = first + i;
    if (pos < len) orow[pos] = run;
  }
  if (threadIdx.x == kThreads - 1) chunk_vals[row * nchunks + c] = incl;
}

// One block per row: chunk totals -> exclusive prefix, in place.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
scan_chunk_vals_kernel(typename Op::T* __restrict__ chunk_vals, int nchunks) {
  using T = typename Op::T;
  __shared__ T warp_vals[kThreads / 32];
  __shared__ T step_total;
  __shared__ T excl[kThreads];
  T* s = chunk_vals + static_cast<int64_t>(blockIdx.x) * nchunks;
  T carry = Op::identity();
  for (int base = 0; base < nchunks; base += kThreads) {
    const int i = base + threadIdx.x;
    const T v = i < nchunks ? s[i] : Op::identity();
    const T incl = block_scan<Op>(v, warp_vals);
    excl[threadIdx.x] = incl;
    if (threadIdx.x == kThreads - 1) step_total = incl;
    __syncthreads();
    if (i < nchunks) {
      s[i] = threadIdx.x == 0 ? carry
                              : Op::combine(carry, excl[threadIdx.x - 1]);
    }
    carry = Op::combine(carry, step_total);
    __syncthreads();
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
scan_add_offsets_kernel(typename Op::T* __restrict__ out,
                        const typename Op::T* __restrict__ chunk_vals,
                        int64_t len, int nchunks) {
  using T = typename Op::T;
  const int64_t row = blockIdx.y;
  const int64_t c = blockIdx.x;
  if (c == 0) return;
  const T off = chunk_vals[row * nchunks + c];
  T* orow = out + row * len;
  const int64_t first = c * kChunk + static_cast<int64_t>(threadIdx.x) * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t pos = first + i;
    if (pos < len) orow[pos] = Op::combine(off, orow[pos]);
  }
}

template <typename Op>
int scan_rows(const void* x, void* out, void* chunk_vals, int rows,
              int64_t len, void* stream) {
  using T = typename Op::T;
  if (rows <= 0 || len <= 0) return 0;
  const int nchunks = static_cast<int>((len + kChunk - 1) / kChunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nchunks, rows);
  scan_chunks_kernel<Op><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<T*>(chunk_vals), len, nchunks);
  int err = brush_last_error();
  if (err != 0 || nchunks == 1) return err;
  scan_chunk_vals_kernel<Op><<<rows, kThreads, 0, st>>>(
      static_cast<T*>(chunk_vals), nchunks);
  err = brush_last_error();
  if (err != 0) return err;
  scan_add_offsets_kernel<Op><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(out), static_cast<const T*>(chunk_vals), len, nchunks);
  return brush_last_error();
}

}  // namespace

BRUSH_EXPORT int brush_scan_block_items() { return kChunk; }

// x, out: [rows, len] contiguous, 4-byte elements. chunk_vals: scratch of
// rows * ceil(len / kChunk) elements of the same type.
BRUSH_EXPORT int brush_scan_rows_i32(const void* x, void* out,
                                     void* chunk_vals, int rows, int64_t len,
                                     void* stream) {
  return scan_rows<SumU32>(x, out, chunk_vals, rows, len, stream);
}

BRUSH_EXPORT int brush_scan_rows_f32(const void* x, void* out,
                                     void* chunk_vals, int rows, int64_t len,
                                     void* stream) {
  return scan_rows<SumF32>(x, out, chunk_vals, rows, len, stream);
}

BRUSH_EXPORT int brush_scan_rows_max_i32(const void* x, void* out,
                                         void* chunk_vals, int rows,
                                         int64_t len, void* stream) {
  return scan_rows<MaxI32>(x, out, chunk_vals, rows, len, stream);
}

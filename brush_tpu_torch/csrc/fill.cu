// Segmented forward fill along each row of a row-major [rows, len] matrix
// of 32-bit words: lane j takes the words of the nearest valid lane k <= j,
// and zeros where no valid lane precedes it.
//
// Replaces brush_tpu/ops/scan_pallas.py:111 `_fill_kernel`, reached through
// `fill_rows`. The TPU kernel runs the select-combine
// ((vl, xl), (vr, xr)) -> (vl | vr, vr ? xr : xl) as a roll ladder inside
// each 8192-lane block and carries the last lane to the next grid step, so
// all `rows` words ride through every step of the scan (a gather there
// costs tens of nanoseconds an index). On Hopper a gather is cheap, so the
// scan shrinks to one int32 per lane: the index of the last valid lane at
// or before j is the running max of (valid[j] ? j : -1). Two small kernels
// here bracket the max scan of csrc/scan.cu (`brush_scan_rows_max_i32`):
//   1. `fill_mark_kernel` writes the marked index row;
//   2. (the scan turns it into the last-valid-lane row;)
//   3. `fill_gather_kernel` writes out[r, j] = x[r, last[j]], or 0 where
//      last[j] < 0.
// Words move as raw bits (uint32), so rows holding bit patterns (NaN
// payloads, bitcast keys) pass unchanged. Offsets are 64-bit.
// Bound on the H100: bytes -- rows * len * 4 + 4 * len read,
// rows * len * 4 written; the two index rows add 16 bytes a lane.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fill_mark_kernel(const int32_t* __restrict__ valid, int64_t len,
                 int32_t* __restrict__ marked) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= len) return;
  marked[j] = valid[j] > 0 ? static_cast<int32_t>(j) : -1;
}

__global__ void __launch_bounds__(kThreads)
fill_gather_kernel(const uint32_t* __restrict__ x,
                   const int32_t* __restrict__ last, int rows, int64_t len,
                   uint32_t* __restrict__ out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= len) return;
  const int32_t k = last[j];
  for (int r = 0; r < rows; ++r) {
    const int64_t row = static_cast<int64_t>(r) * len;
    out[row + j] = k >= 0 ? x[row + k] : 0u;
  }
}

inline int64_t blocks_for(int64_t len) {
  return (len + kThreads - 1) / kThreads;
}

}  // namespace

// valid: [len] int32 (> 0 marks a valid lane). marked: [len] int32 out.
BRUSH_EXPORT int brush_fill_mark(const void* valid, int64_t len, void* marked,
                                 void* stream) {
  if (len <= 0) return 0;
  if (len > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fill_mark_kernel<<<static_cast<unsigned>(blocks_for(len)), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(valid), len, static_cast<int32_t*>(marked));
  return brush_last_error();
}

// x, out: [rows, len] words, contiguous. last: [len] int32, the index of
// the last valid lane at or before each lane, or -1.
BRUSH_EXPORT int brush_fill_gather(const void* x, const void* last, int rows,
                                   int64_t len, void* out, void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  if (len > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fill_gather_kernel<<<static_cast<unsigned>(blocks_for(len)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(last), rows,
      len, static_cast<uint32_t*>(out));
  return brush_last_error();
}

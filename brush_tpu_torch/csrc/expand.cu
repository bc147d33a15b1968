// Segmented broadcast: spread column g of a [rows, n] table over the slot
// run [starts[g], starts[g] + counts[g]) of a row-major [rows, cap] output;
// slots that no run covers are zero, runs crossing `cap` are cut there and
// runs that start past `cap` write nothing.
//
// Replaces brush_tpu/ops/expand_pallas.py:49 `_expand_kernel`, reached
// through `expand_segments`. The TPU kernel avoids gathers (tens of
// nanoseconds an index there): it walks owner windows per slot block and
// selects with a one-hot matrix product, carrying values as three bf16
// limbs and starts as 12-bit limbs so the product stays exact. On Hopper a
// gather is cheap and the monotone starts row stays in L2, so here one
// thread owns one output slot: a binary search over `starts` finds the last
// g with starts[g] <= slot (zero-count owners share their successor's start
// and precede it, so "last" lands on the owner that has slots), and a loop
// over the rows copies that column. Stores are coalesced along the slot
// axis; neighbouring slots mostly share an owner, so the loads hit in
// cache. Words move as raw bits (uint32) and no float arithmetic touches
// them, so the output is bit-exact. Slot and flat offsets are 64-bit:
// rows * cap passes 2^31 long before cap does.
// Bound on the H100: bytes -- rows * n * 4 + 8 * n read,
// rows * cap * 4 written.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
expand_segments_kernel(const uint32_t* __restrict__ table,
                       int64_t table_stride, int rows,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ counts, int n, int64_t cap,
                       uint32_t* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  // lo = number of owners whose start is <= s; the owner is lo - 1.
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(starts[mid]) <= s) lo = mid + 1; else hi = mid;
  }
  const int g = lo - 1;
  const bool covered =
      g >= 0 && s < static_cast<int64_t>(starts[g]) + counts[g];
  for (int r = 0; r < rows; ++r) {
    out[static_cast<int64_t>(r) * cap + s] =
        covered ? table[static_cast<int64_t>(r) * table_stride + g] : 0u;
  }
}

}  // namespace

// table: [rows, >= n] 32-bit words, row r at table + r * table_stride.
// starts (non-decreasing), counts: [n] int32. out: [rows, cap] words,
// contiguous.
BRUSH_EXPORT int brush_expand_segments(const void* table, int64_t table_stride,
                                       int rows, const void* starts,
                                       const void* counts, int n, int64_t cap,
                                       void* out, void* stream) {
  if (rows <= 0 || cap <= 0) return 0;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (cap + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  expand_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), table_stride, rows,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      n, cap, static_cast<uint32_t*>(out));
  return brush_last_error();
}

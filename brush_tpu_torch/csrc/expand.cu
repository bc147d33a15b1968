// Segmented broadcast: spread column g of a [rows, n] table over the slot
// run [starts[g], starts[g] + counts[g]) of a row-major [rows, cap] output;
// slots that no run covers are zero, runs crossing `cap` are cut there and
// runs that start past `cap` write nothing. The owner of slot s is the last
// g with starts[g] <= s (so zero-count owners, which share their
// successor's start and precede it, own nothing, and where runs overlap
// the later one wins); s is covered while s < starts[g] + counts[g].
//
// Replaces brush_tpu/ops/expand_pallas.py:49 `_expand_kernel`, reached
// through `expand_segments`. The TPU kernel avoids gathers (tens of
// nanoseconds an index there): it walks owner windows per slot block and
// selects with a one-hot matrix product, carrying values as three bf16
// limbs and starts as 12-bit limbs so the product stays exact. On Hopper a
// gather is cheap, but a binary search per slot over the whole `starts`
// row is twenty dependent L2 reads a slot. Load-balanced search instead:
//   * One block per tile of kTileSlots consecutive slots. Two warps find
//     the owners of the tile's first and last slot with a 32-way search of
//     `starts` (32 probes a round, four rounds for a million owners), so
//     the tile's owners are the range [g_lo, g_hi].
//   * The block stages `starts` and the cut run ends of that range in
//     shared memory. Each thread takes kGroups groups of 4 consecutive
//     slots (a warp's group covers 128 contiguous slots), searches shared
//     memory for the owner of a group's first slot and walks forward,
//     searching again only where the next owner's start has been passed.
//   * A range longer than the shared-memory window (long runs of
//     zero-count owners) is walked in windows of kWindow owners: a slot
//     takes its owner from the window whose starts bracket it. Global
//     memory is never searched per slot.
//   * Each thread writes its 4 slots of each row as one 16-byte store where
//     r * cap keeps them aligned, as 4-byte stores where it does not.
// Words move as raw bits (uint32) and no float arithmetic touches them, so
// the output is bit-exact. Flat offsets are 64-bit: rows * cap passes 2^31
// long before cap does.
// Bound on the H100: bytes -- rows * n * 4 + 8 * n read,
// rows * cap * 4 written.
#include <climits>

#include "common.cuh"

namespace {

// Tile shape, window and occupancy, as tuned on the H100 (PERF.md,
// section 6): 128 threads of two 4-slot groups, a 1,024-owner window and
// 32 registers (16 blocks an SM) read 0.14 ms at [2, 29.0M] where 256
// threads of four groups (64 registers, 4 blocks an SM) read 0.18: the
// block's two warp searches are latency, and only more blocks an SM hide
// it.
constexpr int kThreads = 128;
constexpr int kMinBlocks = 16;                      // blocks an SM
constexpr int kGroups = 2;                          // 4-slot groups a thread
constexpr int kWindow = 1024;                       // owners in shared memory
static_assert(kThreads >= 64 && kThreads % 32 == 0,
              "two warps search the tile's first and last owner");
constexpr int kGroupStride = kThreads * 4;          // slots between them
constexpr int kTileSlots = kGroupStride * kGroups;  // slots a block
constexpr unsigned kFull = 0xffffffffu;

// Number of owners g < n with starts[g] <= s, by one whole warp: each round
// probes 32 evenly spaced owners of the open interval and keeps the gap
// between the last probe at or before s and the first past it.
__device__ int warp_upper_bound(const int32_t* __restrict__ starts, int n,
                                int s, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t span = hi - lo;
    const int p = lo + static_cast<int>((lane + 1) * span / 33);
    const int c = __popc(__ballot_sync(kFull, starts[p] <= s));
    const int base = lo;
    if (c > 0) lo = base + static_cast<int>(c * span / 33) + 1;
    if (c < 32) hi = base + static_cast<int>((c + 1) * span / 33);
  }
  const int p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && starts[p] <= s));
}

// First index in [lo, hi) of the shared window whose start is past s.
__device__ __forceinline__ int window_upper_bound(const int32_t* w_start,
                                                  int lo, int hi, int s) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (w_start[mid] <= s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
expand_segments_kernel(const uint32_t* __restrict__ table,
                       int64_t table_stride, int rows,
                       const int32_t* __restrict__ starts,
                       const int32_t* __restrict__ counts, int n, int cap,
                       bool out_aligned, uint32_t* __restrict__ out) {
  __shared__ int32_t w_start[kWindow];
  __shared__ int32_t w_end[kWindow];
  __shared__ int bounds[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kTileSlots;
  const int tile_last = static_cast<int>(
      min(static_cast<int64_t>(tile) + kTileSlots, static_cast<int64_t>(cap)) -
      1);
  if (warp < 2) {
    const int ub = warp_upper_bound(starts, n, warp == 0 ? tile : tile_last,
                                    lane);
    if (lane == 0) bounds[warp] = ub - 1;
  }
  __syncthreads();
  // Owners of the tile's slots: [g_lo, g_hi] (g_hi < 0: no slot has one).
  const int g_lo = max(bounds[0], 0);
  const int g_hi = bounds[1];

  // owner[j][i]: the owner covering slot i of group j, or -1.
  int owner[kGroups][4];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) owner[j][i] = -1;
  }
  for (int wb = g_lo; wb <= g_hi; wb += kWindow) {
    const int size = min(kWindow, g_hi + 1 - wb);
    if (wb != g_lo) __syncthreads();  // the last window's searches are done
    for (int i = threadIdx.x; i < size; i += kThreads) {
      const int32_t start = starts[wb + i];
      w_start[i] = start;
      w_end[i] = static_cast<int32_t>(
          min(static_cast<int64_t>(start) + counts[wb + i],
              static_cast<int64_t>(cap)));
    }
    // Slots at or past the next window's first start belong to it.
    const int next = wb + size <= g_hi ? starts[wb + size] : INT_MAX;
    __syncthreads();
    const int first = w_start[0];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int64_t s0 =
          static_cast<int64_t>(tile) + j * kGroupStride + threadIdx.x * 4;
      int idx = -1;  // window index of the first start past the last slot
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (s0 + i > tile_last) break;
        const int s = static_cast<int>(s0 + i);
        if (s < first || s >= next) continue;
        if (idx < 0) {
          idx = window_upper_bound(w_start, 0, size, s);
        } else {
          // Walk forward over a few starts; search past a longer stretch.
          for (int steps = 0; idx < size && w_start[idx] <= s; ++idx) {
            if (++steps > 4) {
              idx = window_upper_bound(w_start, idx, size, s);
              break;
            }
          }
        }
        if (s < w_end[idx - 1]) owner[j][i] = wb + idx - 1;
      }
    }
  }

  for (int r = 0; r < rows; ++r) {
    const uint32_t* trow = table + static_cast<int64_t>(r) * table_stride;
    uint32_t* orow = out + static_cast<int64_t>(r) * cap;
    const bool row_vec =
        out_aligned && ((static_cast<int64_t>(r) * cap) & 3) == 0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int64_t s0 =
          static_cast<int64_t>(tile) + j * kGroupStride + threadIdx.x * 4;
      if (s0 > tile_last) continue;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int g = owner[j][i];
        w[i] = g < 0 ? 0u
                     : (i > 0 && g == owner[j][i - 1] ? w[i - 1] : trow[g]);
      }
      if (row_vec && s0 + 3 <= tile_last) {
        *reinterpret_cast<uint4*>(orow + s0) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (s0 + i <= tile_last) orow[s0 + i] = w[i];
        }
      }
    }
  }
}

}  // namespace

// table: [rows, >= n] 32-bit words, row r at table + r * table_stride.
// starts (non-decreasing), counts: [n] int32. out: [rows, cap] words,
// contiguous; cap < 2^31.
BRUSH_EXPORT int brush_expand_segments(const void* table, int64_t table_stride,
                                       int rows, const void* starts,
                                       const void* counts, int n, int64_t cap,
                                       void* out, void* stream) {
  if (rows <= 0 || cap <= 0) return 0;
  if (n < 0 || cap > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (cap + kTileSlots - 1) / kTileSlots;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  expand_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), table_stride, rows,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      n, static_cast<int>(cap), out_aligned, static_cast<uint32_t*>(out));
  return brush_last_error();
}

// Owner searches of a non-decreasing `starts` row, shared by the segment
// expansion (csrc/expand.cu) and the emission's remainder (csrc/emit.cu):
// the owner of slot s is the last g with starts[g] <= s. A block finds the
// owners of its first and last slot in global memory with one warp each,
// then its threads search the owners between them in shared memory.
#pragma once

#include "common.cuh"

namespace owner_search {

// Number of owners g < n with starts[g] <= s, by one whole warp: each round
// probes 32 evenly spaced owners of the open interval and keeps the gap
// between the last probe at or before s and the first past it (four rounds
// for a million owners).
inline __device__ int warp_upper_bound(const int32_t* __restrict__ starts,
                                   int n, int s, int lane) {
  constexpr unsigned kFull = 0xffffffffu;
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

}  // namespace owner_search

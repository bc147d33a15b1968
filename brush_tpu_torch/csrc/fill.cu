// Segmented forward fill along each row of a row-major [rows, len] matrix
// of 32-bit words: lane j takes the words of the nearest valid lane k <= j,
// and zeros where no valid lane precedes it.
//
// Replaces brush_tpu/ops/scan_pallas.py:111 `_fill_kernel`, reached through
// `fill_rows`. The TPU kernel runs the select-combine
// ((vl, xl), (vr, xr)) -> (vl | vr, vr ? xr : xl) as a roll ladder inside
// each 8192-lane block and carries the last lane to the next grid step, so
// all `rows` words ride through every step of the scan. Here the scan
// carries one index a lane, the last valid lane at or before it (the
// running max of valid ? j : -1), and every row reads its words from that
// index. One single-pass launch with decoupled look-back, the machinery of
// the row scan (csrc/lookback.cuh):
//   * A block takes the next tile of kTile lanes from the counter, loads
//     its `valid` lanes (16-byte loads where `valid` is aligned), and scans
//     valid ? j : -1 with max across the tile and, through the look-back,
//     the tiles before it: every lane then holds its source lane, in the
//     tile or before it (the same lane for all such lanes), or -1.
//   * Row by row, the block stages the tile's words of the row in shared
//     memory (the first row's loads are issued before the look-back) and
//     each lane takes its word from there, from x[r, prefix] (one word a
//     row a tile), or 0. Loads and stores of the rows are coalesced 4-byte
//     accesses, whatever the row's alignment (16-byte stores from the
//     scan's layout read 0.2970 against 0.2549 ms at [2, 29.0M] on the
//     H100, PERF.md section 6), and the next row's loads are in flight
//     while a row is written.
// Words move as raw bits (uint32), so rows holding bit patterns (NaN
// payloads, bitcast keys) pass unchanged. Offsets are 64-bit; len < 2^31.
// The counter and the status words (one 8-byte word a tile) are the
// caller's scratch, cleared by a cudaMemsetAsync in the same C call: one
// memset and one launch a call.
// Bound on the H100: bytes -- 4 * len (valid) + rows * len * 4 read,
// rows * len * 4 written, which is what this kernel moves.
#include "lookback.cuh"

namespace {

using lookback::MaxI32;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;                  // blocks an SM
constexpr int kVecs = 4;                       // 4-lane vectors a thread
constexpr int kWarpLanes = 32 * 4 * kVecs;     // lanes a warp scans
constexpr int kTile = kThreads * 4 * kVecs;    // lanes a block fills
constexpr int kWords = kTile / kThreads;       // words a thread moves a row

// The tile's words of row `xr` into w: thread t takes tile lanes
// t + kThreads * m, so a warp's m-th load reads 128 contiguous bytes.
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ xr,
                                         int64_t tile0, int64_t len,
                                         uint32_t (&w)[kWords]) {
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    const int64_t q = tile0 + threadIdx.x + kThreads * m;
    w[m] = q < len ? xr[q] : 0u;
  }
}

// kVec: `valid` is 16-byte aligned, so a thread's 4-lane vectors are read
// as 16-byte loads.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fill_rows_kernel(const uint32_t* __restrict__ x,
                 const int32_t* __restrict__ valid, int rows, int64_t len,
                 uint32_t* __restrict__ out,
                 unsigned long long* __restrict__ scratch) {
  __shared__ uint32_t s_words[kTile];  // the tile's words of a row
  // Each lane's source lane, or -1 (written as 16-byte vectors).
  __shared__ __align__(16) int32_t s_src[kTile];
  const int t = static_cast<int>(lookback::claim_tile(scratch));
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch) + 1;
  const int64_t tile0 = static_cast<int64_t>(t) * kTile;
  // Tile lane of this thread's vector 0; vector k is 128 k lanes on.
  const int local0 = (threadIdx.x >> 5) * kWarpLanes + (threadIdx.x & 31) * 4;

  int32_t v[kVecs][4];  // valid ? lane : -1, then each lane's source lane
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t pos = tile0 + local0 + 128 * k;
    if (kVec && pos + 3 < len) {
      const int4 u = *reinterpret_cast<const int4*>(valid + pos);
      const int32_t p = static_cast<int32_t>(pos);
      v[k][0] = u.x > 0 ? p : -1;
      v[k][1] = u.y > 0 ? p + 1 : -1;
      v[k][2] = u.z > 0 ? p + 2 : -1;
      v[k][3] = u.w > 0 ? p + 3 : -1;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t q = pos + j;
        v[k][j] = q < len && valid[q] > 0 ? static_cast<int32_t>(q) : -1;
      }
    }
  }
  uint32_t w[kWords];
  load_row(x, tile0, len, w);
  lookback::scan_tile<MaxI32, kThreads, kVecs>(v, status, t);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    *reinterpret_cast<int4*>(s_src + local0 + 128 * k) =
        make_int4(v[k][0], v[k][1], v[k][2], v[k][3]);
  }

  for (int r = 0; r < rows; ++r) {
    const uint32_t* xr = x + static_cast<int64_t>(r) * len;
    uint32_t* orow = out + static_cast<int64_t>(r) * len;
#pragma unroll
    for (int m = 0; m < kWords; ++m) s_words[threadIdx.x + kThreads * m] = w[m];
    __syncthreads();
    if (r + 1 < rows) load_row(xr + len, tile0, len, w);
#pragma unroll
    for (int m = 0; m < kWords; ++m) {
      const int local = threadIdx.x + kThreads * m;
      const int64_t q = tile0 + local;
      if (q >= len) break;
      const int32_t src = s_src[local];
      orow[q] = src >= tile0 ? s_words[src - tile0]
                             : (src >= 0 ? xr[src] : 0u);
    }
    __syncthreads();  // the row's words are read before the next row's land
  }
}

inline int64_t tiles_for(int64_t len) { return (len + kTile - 1) / kTile; }

}  // namespace

// Lanes a tile covers; the scratch holds one 8-byte status word a tile,
// ceil(len / tile) of them, plus the tile counter.
BRUSH_EXPORT int brush_fill_tile_items() { return kTile; }

// x, out: [rows, len] 32-bit words, contiguous. valid: [len] int32 (> 0
// marks a valid lane). scratch: scratch_words 8-byte words, at least
// ceil(len / tile) + 1; the call clears what it uses.
BRUSH_EXPORT int brush_fill_rows(const void* x, const void* valid, int rows,
                                 int64_t len, void* out, void* scratch,
                                 int64_t scratch_words, void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  const int64_t tiles = tiles_for(len);
  if (len > 0x7fffffffLL || scratch_words < tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(uint64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xp = static_cast<const uint32_t*>(x);
  const auto* vp = static_cast<const int32_t*>(valid);
  auto* op = static_cast<uint32_t*>(out);
  auto* sp = static_cast<unsigned long long*>(scratch);
  const unsigned grid = static_cast<unsigned>(tiles);
  if ((reinterpret_cast<uintptr_t>(valid) & 15) == 0) {
    fill_rows_kernel<true><<<grid, kThreads, 0, st>>>(xp, vp, rows, len, op,
                                                       sp);
  } else {
    fill_rows_kernel<false><<<grid, kThreads, 0, st>>>(xp, vp, rows, len, op,
                                                        sp);
  }
  return brush_last_error();
}

// Exact tile counts: per splat, the exact-hit mask over its first 32
// bbox-local tiles and its exact emission count.
//
// Replaces no TPU kernel. The reference package computes the counts in jnp
// over an [N, 32] grid of (splat, bbox-local tile) pairs
// (brush_tpu/ops/tiling.py `exact_tile_counts`), which XLA fuses into one
// pass; run as PyTorch operations the same grid is about 110 elementwise
// passes, most of them over broadcast [N, 1] columns. Reached through
// `tile_counts` (ops/tile_counts_cuda.py), which `exact_tile_counts`
// (ops/tiling.py) calls for CUDA tensors.
//
// Inputs, row g of each (contiguous): mean2d [N, 2] f32, conic [N, 3] f32
// (c00, c01, c11), power_threshold [N] f32 (ln(255 * opac), formed by the
// wrapper with the plain version's own operations), tile_min and tile_max
// [N, 2] int32, bbox_count [N] int32 (tiles in the clamped bbox).
// Outputs: mask [N] int64 holding the u32 whose bit j says bbox-local tile
// j passes the exact test (j < min(bbox_count, 32)), and
// count [N] int32 = popcount(mask) + max(bbox_count - 32, 0).
//
// Bound on the H100: bytes. A splat's row is read once and two words are
// written, against the grid's [N, 32] temporaries. One thread takes one
// splat: it reads its bbox count first, so a dead or culled splat (count 0:
// half the rows of a training capacity) leaves after one load, and a live
// one runs the exact test only on the min(count, 32) tiles the mask keeps
// (the plain version tests all 32 and masks the rest; the bits are the
// same).
//
// The test repeats `will_contribute` (ops/tile_counts_cuda.py) operation for
// operation in float32, with round-to-nearest intrinsics so that nvcc
// contracts nothing into an FMA, so mask and count equal the plain
// version's bit for bit. Where the plain version selects a value that
// does not depend on an operand (a tile the mean lies in; tx where the mean
// lies in the tile's rows), that operand is not computed.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanBits = 32;    // B_SCAN: exact-tested bbox-local tiles
constexpr float kTile = 32.0f;   // TILE_WIDTH in pixels

// torch.clamp(v, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp_unit(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// One term of the projection of the mean onto the tile's nearest edge:
// ((d * ca) * diff_x + (d * cb) * diff_y) / den, with den = (d * cd) * d
// replaced by 1 where it is 0, clamped to [0, 1].
__device__ __forceinline__ float edge_t(float d, float ca, float cb, float cd,
                                        float diff_x, float diff_y) {
  const float den = __fmul_rn(__fmul_rn(d, cd), d);
  const float num = __fadd_rn(__fmul_rn(__fmul_rn(d, ca), diff_x),
                              __fmul_rn(__fmul_rn(d, cb), diff_y));
  return clamp_unit(__fdiv_rn(num, den != 0.0f ? den : 1.0f));
}

// ops/tile_counts_cuda.py `will_contribute` for one tile.
__device__ __forceinline__ bool will_contribute(int tile_x, int tile_y,
                                                float mx, float my,
                                                float c00, float c01,
                                                float c11, float threshold) {
  const float min_x = __fmul_rn(__int2float_rn(tile_x), kTile);
  const float min_y = __fmul_rn(__int2float_rn(tile_y), kTile);
  const float max_x = __fadd_rn(min_x, kTile);
  const float max_y = __fadd_rn(min_y, kTile);
  const bool x_left = mx < min_x;
  const bool in_x = !(x_left || mx > max_x);
  const bool y_above = my < min_y;
  const bool in_y = !(y_above || my > max_y);
  if (in_x && in_y) return true;
  const float corner_x = x_left ? min_x : max_x;
  const float corner_y = y_above ? min_y : max_y;
  const float dxf = x_left ? kTile : -kTile;
  const float dyf = y_above ? kTile : -kTile;
  const float diff_x = __fsub_rn(mx, corner_x);
  const float diff_y = __fsub_rn(my, corner_y);
  const float tx = in_y ? 0.0f : edge_t(dxf, c00, c01, c00, diff_x, diff_y);
  const float ty = in_x ? 0.0f : edge_t(dyf, c01, c11, c11, diff_x, diff_y);
  const float ddx = __fsub_rn(__fadd_rn(corner_x, __fmul_rn(tx, dxf)), mx);
  const float ddy = __fsub_rn(__fadd_rn(corner_y, __fmul_rn(ty, dyf)), my);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(c00, ddx), ddx),
                               __fmul_rn(__fmul_rn(c11, ddy), ddy));
  const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                __fmul_rn(__fmul_rn(c01, ddx), ddy));
  return sigma <= threshold;
}

__global__ void __launch_bounds__(kThreads)
tile_hits_kernel(const float* __restrict__ mean2d,
                 const float* __restrict__ conic,
                 const float* __restrict__ threshold,
                 const int* __restrict__ tile_min,
                 const int* __restrict__ tile_max,
                 const int* __restrict__ bbox_count, int n,
                 int64_t* __restrict__ mask_out,
                 int* __restrict__ count_out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n) return;
  const int count = bbox_count[g];
  const int tested = min(count, kScanBits);
  uint32_t mask = 0u;
  if (tested > 0) {
    const float mx = mean2d[2 * g], my = mean2d[2 * g + 1];
    const float c00 = conic[3 * g], c01 = conic[3 * g + 1];
    const float c11 = conic[3 * g + 2];
    const float thr = threshold[g];
    const int tmin_x = tile_min[2 * g], tmin_y = tile_min[2 * g + 1];
    const int bb_w = max(tile_max[2 * g] - tmin_x, 1);
    // Local tile j is (j % bb_w, j / bb_w), walked row by row.
    int lx = 0, ly = 0;
    for (int j = 0; j < tested; ++j) {
      if (will_contribute(tmin_x + lx, tmin_y + ly, mx, my, c00, c01, c11,
                          thr)) {
        mask |= 1u << j;
      }
      if (++lx == bb_w) {
        lx = 0;
        ++ly;
      }
    }
  }
  mask_out[g] = static_cast<int64_t>(mask);
  count_out[g] = __popc(mask) + max(count - kScanBits, 0);
}

}  // namespace

// All pointers are device pointers to contiguous arrays (layouts above).
BRUSH_EXPORT int brush_tile_counts(const void* mean2d, const void* conic,
                                   const void* threshold,
                                   const void* tile_min,
                                   const void* tile_max,
                                   const void* bbox_count, int64_t n,
                                   void* mask_out, void* count_out,
                                   void* stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  tile_hits_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mean2d), static_cast<const float*>(conic),
      static_cast<const float*>(threshold),
      static_cast<const int*>(tile_min), static_cast<const int*>(tile_max),
      static_cast<const int*>(bbox_count), static_cast<int>(n),
      static_cast<int64_t*>(mask_out), static_cast<int*>(count_out));
  return brush_last_error();
}

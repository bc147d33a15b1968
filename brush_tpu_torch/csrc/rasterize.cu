// Forward tile rasterizers: front-to-back blend of each 32x32 tile's
// depth-sorted slots, in two variants of one kernel.
//
//  * diet (forward only): [T, 4, 1024] (rgb + T*bg, 1 - T) from the 8-row
//    diet SoA. Replaces brush_tpu/ops/rasterize_pallas.py:152 `_fwd_kernel`
//    with fwd_only=True, reached through `rasterize_forward_pallas`.
//  * training: [T, 8, 1024] from nine f32 rows of the 16-row SoA: rows 0..3
//    as above, row 4 the final transmittance, row 5 `useful_len` (one past
//    the last slot any pixel blended, minus the tile's start; the backward
//    kernel replays no further), rows 6, 7 zero. Replaces the same
//    `_fwd_kernel` with fwd_only=False. Pixel centres are absolute where the
//    diet variant is tile-relative.
//
// One thread block per tile, 256 threads, 4 pixels per thread (pixel
// p = tid + 256*k, row-major in the tile). The block stages a batch of 256
// slots in shared memory (the diet variant decodes its f16 pairs with
// __half2float on the raw 16 bits, bit-exact like the JAX package's
// _f16_to_f32), then every thread blends its pixels over the batch in
// order. The TPU kernel's log-space MXU prefix product, DMA windows with a
// lane roll and 4-tiles-per-step grid have no counterpart: transmittance
// is the plain sequential product T *= (1 - alpha), so a pixel near the
// T <= 1e-4 or alpha >= 1/255 gates may land on the other side of them
// than on the TPU. The block ends early once every pixel of the tile is
// done (__syncthreads_count).
//
// The arithmetic uses explicit round-to-nearest intrinsics (no FMA
// contraction), in the operation order of the plain PyTorch version, so
// the two agree to the last bit wherever expf does.
//
// Bound on the H100: operations, about 20 f32 operations and one exp per
// (pixel, slot) pair the blend evaluates; the bytes are 24 (diet) or 36
// (training) per slot in a tile range plus 16 or 32 KB of output per tile.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kTileWidth = 32;
constexpr int kTilePix = kTileWidth * kTileWidth;
constexpr int kThreads = 256;
constexpr int kPix = kTilePix / kThreads;  // pixels per thread
constexpr int kBatch = kThreads;           // slots staged per batch

__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
rasterize_fwd_kernel(const uint32_t* __restrict__ soa, int64_t stride,
                     const int32_t* __restrict__ ranges,
                     const float* __restrict__ bg, float* __restrict__ out,
                     int tile_bw) {
  __shared__ int s_useful;
  __shared__ float s_x[kBatch], s_y[kBatch], s_c00[kBatch], s_c01[kBatch],
      s_c11[kBatch], s_o[kBatch], s_r[kBatch], s_g[kBatch], s_b[kBatch];

  const int t = blockIdx.x;
  const int start = ranges[2 * t];
  const int end = ranges[2 * t + 1];
  const float alpha_min = static_cast<float>(1.0 / 255.0);
  const float alpha_cap = 0.999f;
  const float t_eps = 1.0e-4f;

  // Tile origin in pixels: the training SoA holds absolute centres.
  const int ox = kTrain ? (t % tile_bw) * kTileWidth : 0;
  const int oy = kTrain ? (t / tile_bw) * kTileWidth : 0;
  if (kTrain) {
    if (threadIdx.x == 0) s_useful = 0;
    __syncthreads();  // an empty tile reaches the atomicMax with no barrier
  }

  float px[kPix], py[kPix], tr[kPix], cr[kPix], cg[kPix], cb[kPix];
  bool done[kPix];
  int useful = 0;  // one past the last slot this thread blended, from start
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(ox + p % kTileWidth) + 0.5f;
    py[k] = static_cast<float>(oy + p / kTileWidth) + 0.5f;
    tr[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    done[k] = false;
  }

  for (int base = start; base < end; base += kBatch) {
    const int i = base + threadIdx.x;
    if (kTrain) {
      if (i < end) {
        s_x[threadIdx.x] = __uint_as_float(soa[i]);
        s_y[threadIdx.x] = __uint_as_float(soa[stride + i]);
        s_c00[threadIdx.x] = __uint_as_float(soa[2 * stride + i]);
        s_c01[threadIdx.x] = __uint_as_float(soa[3 * stride + i]);
        s_c11[threadIdx.x] = __uint_as_float(soa[4 * stride + i]);
        s_o[threadIdx.x] = __uint_as_float(soa[5 * stride + i]);
        s_r[threadIdx.x] = __uint_as_float(soa[6 * stride + i]);
        s_g[threadIdx.x] = __uint_as_float(soa[7 * stride + i]);
        s_b[threadIdx.x] = __uint_as_float(soa[8 * stride + i]);
      }
    } else if (i < end) {
      const uint32_t w2 = soa[2 * stride + i];
      const uint32_t w3 = soa[3 * stride + i];
      const uint32_t w4 = soa[4 * stride + i];
      const uint32_t w5 = soa[5 * stride + i];
      s_x[threadIdx.x] = __uint_as_float(soa[i]);
      s_y[threadIdx.x] = __uint_as_float(soa[stride + i]);
      s_c00[threadIdx.x] = f16_lo(w2);
      s_c01[threadIdx.x] = f16_hi(w2);
      s_c11[threadIdx.x] = f16_lo(w3);
      s_o[threadIdx.x] = f16_hi(w3);
      s_r[threadIdx.x] = f16_lo(w4);
      s_g[threadIdx.x] = f16_hi(w4);
      s_b[threadIdx.x] = f16_lo(w5);
    }
    __syncthreads();
    const int nb = min(kBatch, end - base);
    for (int jj = 0; jj < nb; ++jj) {
      const float mx = s_x[jj], my = s_y[jj];
      const float c00 = s_c00[jj], c01 = s_c01[jj], c11 = s_c11[jj];
      const float o = s_o[jj];
      // max(rgb, 0) that keeps a NaN, as torch.clamp_min does
      const float r = s_r[jj] < 0.0f ? 0.0f : s_r[jj];
      const float g = s_g[jj] < 0.0f ? 0.0f : s_g[jj];
      const float b = s_b[jj] < 0.0f ? 0.0f : s_b[jj];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        const float dx = __fsub_rn(px[k], mx);
        const float dy = __fsub_rn(py[k], my);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(c00, dx), dx),
                                     __fmul_rn(__fmul_rn(c11, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(c01, dx), dy));
        const float v = __fmul_rn(o, expf(-sigma));
        const float alpha = v > alpha_cap ? alpha_cap : v;  // NaN stays NaN
        if (!(sigma >= 0.0f && alpha >= alpha_min)) continue;
        const float next_t = __fmul_rn(tr[k], __fsub_rn(1.0f, alpha));
        if (next_t <= t_eps) {
          done[k] = true;  // this splat is not blended; the pixel is final
          continue;
        }
        const float w = __fmul_rn(alpha, tr[k]);
        cr[k] = __fadd_rn(cr[k], __fmul_rn(w, r));
        cg[k] = __fadd_rn(cg[k], __fmul_rn(w, g));
        cb[k] = __fadd_rn(cb[k], __fmul_rn(w, b));
        tr[k] = next_t;
        if (kTrain) useful = base + jj + 1 - start;
      }
    }
    int all_done = 1;
#pragma unroll
    for (int k = 0; k < kPix; ++k) all_done &= done[k] ? 1 : 0;
    // Also the barrier before the next batch overwrites shared memory.
    if (__syncthreads_count(all_done) == kThreads) break;
  }

  float useful_len = 0.0f;
  if (kTrain) {
    // Block-wide max of the last blended slot: warps first, then shared.
    const int warp_max = __reduce_max_sync(0xffffffffu, useful);
    if ((threadIdx.x & 31) == 0) atomicMax(&s_useful, warp_max);
    __syncthreads();
    useful_len = static_cast<float>(s_useful);
  }

  constexpr int kRows = kTrain ? 8 : 4;
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  float* o_tile = out + static_cast<int64_t>(t) * kRows * kTilePix;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    o_tile[p] = __fadd_rn(cr[k], __fmul_rn(tr[k], bg_r));
    o_tile[kTilePix + p] = __fadd_rn(cg[k], __fmul_rn(tr[k], bg_g));
    o_tile[2 * kTilePix + p] = __fadd_rn(cb[k], __fmul_rn(tr[k], bg_b));
    o_tile[3 * kTilePix + p] = __fsub_rn(1.0f, tr[k]);
    if (kTrain) {
      o_tile[4 * kTilePix + p] = tr[k];
      o_tile[5 * kTilePix + p] = useful_len;
      o_tile[6 * kTilePix + p] = 0.0f;
      o_tile[7 * kTilePix + p] = 0.0f;
    }
  }
}

}  // namespace

// soa: [>= 6, stride] 32-bit words (diet layout: rows 0,1 tile-relative f32
// x, y; rows 2..5 f16 pairs (c00,c01) (c11,opac) (r,g) (b,0)).
// ranges: [n_tiles, 2] int32 raw [start, end). bg: [3] f32 on the device.
// out: [n_tiles, 4, 1024] f32.
BRUSH_EXPORT int brush_rasterize_fwd_diet(const void* soa, int64_t stride,
                                          const void* ranges, const void* bg,
                                          void* out, int n_tiles,
                                          void* stream) {
  if (n_tiles <= 0) return 0;
  rasterize_fwd_kernel<false><<<n_tiles, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(soa), stride,
      static_cast<const int32_t*>(ranges), static_cast<const float*>(bg),
      static_cast<float*>(out), 1);
  return brush_last_error();
}

// soa: [>= 9, stride] f32 (training layout: rows 0,1 absolute x, y; 2..4
// conic; 5 opacity; 6..8 rgb). ranges, bg as above. tile_bw: tiles per image
// row. out: [n_tiles, 8, 1024] f32.
BRUSH_EXPORT int brush_rasterize_fwd_train(const void* soa, int64_t stride,
                                           const void* ranges, const void* bg,
                                           void* out, int n_tiles,
                                           int tile_bw, void* stream) {
  if (n_tiles <= 0) return 0;
  rasterize_fwd_kernel<true><<<n_tiles, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(soa), stride,
      static_cast<const int32_t*>(ranges), static_cast<const float*>(bg),
      static_cast<float*>(out), tile_bw);
  return brush_last_error();
}

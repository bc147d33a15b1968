// Forward tile rasterizers: front-to-back blend of each 32x32 tile's
// depth-sorted slots, in two variants of one kernel.
//
//  * diet (forward only): [T, 4, 1024] (rgb + T*bg, 1 - T) from the 8-row
//    diet SoA. Replaces brush_tpu/ops/rasterize_pallas.py:152 `_fwd_kernel`
//    with fwd_only=True, reached through `rasterize_forward_pallas`.
//  * training: [T, 8, 1024] from nine f32 rows of the 16-row SoA: rows 0..3
//    as above, row 4 the final transmittance, row 5 `useful_len` (one past
//    the last slot any pixel of the tile blended, minus the tile's start,
//    in all 1024 lanes), rows 6, 7 zero; and each 8x4-pixel part's own
//    useful length, [T, 32] int32, from which the backward kernel replays
//    no further. Replaces the same `_fwd_kernel` with fwd_only=False.
//    Pixel centres are absolute where the diet variant is tile-relative.
//
// What bounds it on the H100: operations, about 27 f32 operations and one
// exp per (pixel, slot) pair evaluated before the pixel is done; the bytes
// (24 or 36 per slot in a tile range, 16 or 32 KB of output a tile) are
// far below. What held the first design (one block per tile, 4 pixels a
// thread) back was not the operations but their spread: a block walked its
// whole tile serially and ended early only when all 1024 pixels were done,
// so on a trained scene the few tiles whose useful range reached 1,892
// slots set the time (clipping ranges to 256 slots halved it), and done
// pixels sat in warps that kept evaluating.
//
// Design. The unit of work is one part of a tile: an 8x4 block of 32
// pixels, one a lane of one warp. A persistent grid (as many blocks as fit
// on the card) takes parts from an atomic counter, warp by warp, over the
// tiles in tile order. Longest span first read no faster, with the sort
// that forms the order or without it (the training variant, medians of 3
// turns, tile order against longest first with and without the sort:
// 0.43512 against 0.46835 and 0.43790 ms at the train cell, 0.51622
// against 0.52351 and 0.49203 at loop step 9, 0.52604 against 0.53040 and
// 0.50075 at loop step 23; the sort alone is 4 kernels and 3 copies,
// 0.0248 ms; NVIDIA H100 80GB HBM3, 700 W). A warp stages its
// next 32 slots itself in its own corner of shared memory (a lane loads one slot; the diet variant decodes its
// f16 pairs there with __half2float on the raw 16 bits, bit-exact like the
// JAX package's _f16_to_f32), so warps never wait on each other: a warp
// leaves its part as soon as its 32 pixels are done or the range ends, and
// takes the next. A warp runs until its last pixel is done, so its pixels
// should finish together: an 8x4 block's do more often than a 32x1 row's
// (0.475 ms at the train cell against 0.540 for rows; two or four rows a
// warp, 0.52 ms, lost at loop step 9, 0.76 and 1.01 against 0.67, where a
// warp's serial walk of a long range sets the tail; NVIDIA H100 80GB HBM3,
// 700 W). Where sigma > 5.6 and opac <= 1 the alpha gate must fail, so the
// exp is skipped (the same decision, not an approximation).
// The training variant's row 5 needs the tile's maximum over its 32 parts:
// each warp stores its part's length, and the warp that finishes a tile's
// last part (a per-tile atomic count) writes the maximum to all 1024
// lanes. The counter and the per-tile counts are cleared by one memset in
// the same C call.
//
// The per-pixel arithmetic is unchanged: explicit round-to-nearest
// intrinsics (no FMA contraction) in the operation order of the plain
// PyTorch version, so the two agree to the last bit wherever expf does,
// and the backward kernel's replay repeats it operation for operation.
// The sequential product T *= (1 - alpha) stands for the TPU's log-space
// MXU prefix product, so a pixel near the T <= 1e-4 or alpha >= 1/255
// gates may land on the other side of them than on the TPU.
#include <cuda_fp16.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTileWidth = 32;
constexpr int kTilePix = kTileWidth * kTileWidth;
constexpr int kParts = 32;                // 8x4-pixel parts of a tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// exp(-5.6) = 0.0037 is 6 % below the 1/255 alpha gate, far more than
// expf's rounding.
constexpr float kFarSigma = 5.6f;

// Pixel (row-major in the tile) of lane `lane` in part `q`: part q covers
// x in [8 (q % 4), +8), y in [4 (q / 4), +4); the lane is pixel
// (lane % 8, lane / 8) of it.
__device__ __forceinline__ int part_pixel(int q, int lane) {
  return ((q >> 2) * 4 + (lane >> 3)) * kTileWidth + (q & 3) * 8 + (lane & 7);
}

__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}
// max(v, 0) that keeps a NaN, as torch.clamp_min does.
__device__ __forceinline__ float clamp0(float v) { return v < 0.0f ? 0.0f : v; }

template <bool kTrain>
__global__ void __launch_bounds__(kThreads)
rasterize_fwd_kernel(const uint32_t* __restrict__ soa, int64_t stride,
                     const int32_t* __restrict__ ranges,
                     const float* __restrict__ bg, float* __restrict__ out,
                     int32_t* __restrict__ part_useful,
                     int32_t* __restrict__ scratch, int n_tiles,
                     int tile_bw) {
  // A warp's staged slots: (x, y, c00, c01), (c11, opac, r, g), (b, -, -, -)
  // with r, g, b already max(., 0).
  __shared__ float4 s_slot[kWarps][32][3];
  constexpr int kOutRows = kTrain ? 8 : 4;
  const float alpha_min = static_cast<float>(1.0 / 255.0);
  const float alpha_cap = 0.999f;
  const float t_eps = 1.0e-4f;
  const int lane = threadIdx.x & 31;
  float4(*mine)[3] = s_slot[threadIdx.x >> 5];
  int32_t* counter = scratch;
  int32_t* parts_done = scratch + 1;  // [n_tiles], training only
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  const int n_items = n_tiles * kParts;

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= n_items) break;
    const int t = item / kParts;
    const int q = item % kParts;
    const int p = part_pixel(q, lane);
    const int start = ranges[2 * t];
    const int end = ranges[2 * t + 1];
    // Tile origin in pixels: the training SoA holds absolute centres.
    const int ox = kTrain ? (t % tile_bw) * kTileWidth : 0;
    const int oy = kTrain ? (t / tile_bw) * kTileWidth : 0;
    const float px = static_cast<float>(ox + p % kTileWidth) + 0.5f;
    const float py = static_cast<float>(oy + p / kTileWidth) + 0.5f;
    float tr = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    bool done = false;
    int useful = 0;  // one past the last slot this pixel blended, from start

    for (int base = start; base < end; base += 32) {
      const int i = base + lane;
      if (i < end) {
        float4 a, b, c;
        if (kTrain) {
          a = make_float4(__uint_as_float(soa[i]),
                          __uint_as_float(soa[stride + i]),
                          __uint_as_float(soa[2 * stride + i]),
                          __uint_as_float(soa[3 * stride + i]));
          b = make_float4(__uint_as_float(soa[4 * stride + i]),
                          __uint_as_float(soa[5 * stride + i]),
                          clamp0(__uint_as_float(soa[6 * stride + i])),
                          clamp0(__uint_as_float(soa[7 * stride + i])));
          c = make_float4(clamp0(__uint_as_float(soa[8 * stride + i])), 0.0f,
                          0.0f, 0.0f);
        } else {
          const uint32_t w2 = soa[2 * stride + i];
          const uint32_t w3 = soa[3 * stride + i];
          const uint32_t w4 = soa[4 * stride + i];
          const uint32_t w5 = soa[5 * stride + i];
          a = make_float4(__uint_as_float(soa[i]),
                          __uint_as_float(soa[stride + i]), f16_lo(w2),
                          f16_hi(w2));
          b = make_float4(f16_lo(w3), f16_hi(w3), clamp0(f16_lo(w4)),
                          clamp0(f16_hi(w4)));
          c = make_float4(clamp0(f16_lo(w5)), 0.0f, 0.0f, 0.0f);
        }
        mine[lane][0] = a;
        mine[lane][1] = b;
        mine[lane][2] = c;
      }
      __syncwarp();
      const int nb = min(32, end - base);
      for (int jj = 0; jj < nb; ++jj) {
        const float4 a = mine[jj][0];
        const float4 b = mine[jj][1];
        const float bl = mine[jj][2].x;
        if (done) continue;
        const float dx = __fsub_rn(px, a.x);
        const float dy = __fsub_rn(py, a.y);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a.z, dx), dx),
                                     __fmul_rn(__fmul_rn(b.x, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(a.w, dx), dy));
        // Far from the splat the gate fails without the exp: wherever
        // opac <= 1, alpha <= exp(-sigma) < exp(-5.6) < 1/255.
        if (sigma > kFarSigma && b.y <= 1.0f) continue;
        const float v = __fmul_rn(b.y, expf(-sigma));
        const float alpha = v > alpha_cap ? alpha_cap : v;  // NaN stays NaN
        if (!(sigma >= 0.0f && alpha >= alpha_min)) continue;
        const float next_t = __fmul_rn(tr, __fsub_rn(1.0f, alpha));
        if (next_t <= t_eps) {
          done = true;  // this splat is not blended; the pixel is final
          continue;
        }
        const float w = __fmul_rn(alpha, tr);
        cr = __fadd_rn(cr, __fmul_rn(w, b.z));
        cg = __fadd_rn(cg, __fmul_rn(w, b.w));
        cb = __fadd_rn(cb, __fmul_rn(w, bl));
        tr = next_t;
        if (kTrain) useful = base + jj + 1 - start;
      }
      // Also orders this batch's reads before the next batch's stores.
      if (__all_sync(kFull, done)) break;
    }

    float* o_tile = out + static_cast<int64_t>(t) * kOutRows * kTilePix;
    o_tile[p] = __fadd_rn(cr, __fmul_rn(tr, bg_r));
    o_tile[kTilePix + p] = __fadd_rn(cg, __fmul_rn(tr, bg_g));
    o_tile[2 * kTilePix + p] = __fadd_rn(cb, __fmul_rn(tr, bg_b));
    o_tile[3 * kTilePix + p] = __fsub_rn(1.0f, tr);
    if (kTrain) {
      o_tile[4 * kTilePix + p] = tr;
      o_tile[6 * kTilePix + p] = 0.0f;
      o_tile[7 * kTilePix + p] = 0.0f;
      const int part_len = __reduce_max_sync(kFull, useful);
      int finished = 0;
      if (lane == 0) {
        part_useful[t * kParts + q] = part_len;
        __threadfence();  // the length is visible before the count moves
        finished = atomicAdd(&parts_done[t], 1);
      }
      finished = __shfl_sync(kFull, finished, 0);
      if (finished == kParts - 1) {
        // The tile's last part: every part's length is stored. Read them
        // from L2 (another SM's stores are not in this SM's L1).
        __threadfence();
        const int tile_len = __reduce_max_sync(
            kFull, __ldcg(&part_useful[t * kParts + lane]));
        const float len_f = static_cast<float>(tile_len);
        for (int r = 0; r < kTilePix / 32; ++r) {
          o_tile[5 * kTilePix + r * 32 + lane] = len_f;
        }
      }
    }
  }
}

template <bool kTrain>
int grid_size() {
  // One persistent grid: as many blocks as fit on the card at once.
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rasterize_fwd_kernel<kTrain>, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return blocks;
}

template <bool kTrain>
int launch(const void* soa, int64_t stride, const void* ranges,
           const void* bg, void* out, void* part_useful, void* scratch,
           int n_tiles, int tile_bw, void* stream) {
  if (n_tiles <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t words = kTrain ? 1 + static_cast<size_t>(n_tiles) : 1;
  cudaMemsetAsync(scratch, 0, words * sizeof(int32_t), s);
  const int items = n_tiles * kParts;
  const int grid =
      std::min(grid_size<kTrain>(), (items + kWarps - 1) / kWarps);
  rasterize_fwd_kernel<kTrain><<<grid, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(soa), stride,
      static_cast<const int32_t*>(ranges), static_cast<const float*>(bg),
      static_cast<float*>(out),
      static_cast<int32_t*>(part_useful), static_cast<int32_t*>(scratch),
      n_tiles, tile_bw);
  return brush_last_error();
}

}  // namespace

// soa: [>= 6, stride] 32-bit words (diet layout: rows 0,1 tile-relative f32
// x, y; rows 2..5 f16 pairs (c00,c01) (c11,opac) (r,g) (b,0)).
// ranges: [n_tiles, 2] int32 raw [start, end). bg: [3] f32.
// out: [n_tiles, 4, 1024] f32. scratch: 1 int32 (cleared here).
BRUSH_EXPORT int brush_rasterize_fwd_diet(const void* soa, int64_t stride,
                                          const void* ranges,
                                          const void* bg, void* out,
                                          void* scratch, int n_tiles,
                                          void* stream) {
  return launch<false>(soa, stride, ranges, bg, out, nullptr, scratch,
                       n_tiles, 1, stream);
}

// soa: [>= 9, stride] f32 (training layout: rows 0,1 absolute x, y; 2..4
// conic; 5 opacity; 6..8 rgb). ranges, bg as above. tile_bw: tiles
// per image row. out: [n_tiles, 8, 1024] f32. part_useful: [n_tiles, 32]
// int32, every entry written. scratch: 1 + n_tiles int32 (cleared here).
BRUSH_EXPORT int brush_rasterize_fwd_train(const void* soa, int64_t stride,
                                           const void* ranges,
                                           const void* bg, void* out,
                                           void* part_useful, void* scratch,
                                           int n_tiles, int tile_bw,
                                           void* stream) {
  return launch<true>(soa, stride, ranges, bg, out, part_useful, scratch,
                      n_tiles, tile_bw, stream);
}

// Rasterizer backward: per-slot gradients of each 32x32 tile's blend.
//
// Replaces brush_tpu/ops/rasterize_pallas.py:431 `_bwd_kernel`, reached
// through `rasterize_backward_pallas`. Inputs: the f32 training SoA, the
// raw tile ranges, the forward's saved tiles [T, 8, 1024] (rgb + T*bg,
// alpha, final T, useful_len), the image cotangent in tile layout
// [T, 4, 1024] and the background. Output: [11, stride] f32, one column per
// sorted slot: 0,1 v_xy; 2..4 v_conic; 5 v_opac; 6..8 v_rgb; 9 the refine
// weight sum_p |v_xy * (W, H)| / max(final alpha_p, 1e-5); 10 sum_p w.
//
// One thread block per tile, 256 threads, 4 pixels per thread (pixel
// p = tid + 256*k, as in the forward kernel). Each pixel first forms, from
// the saved tile and the cotangent, T_final * f_t with
// f_t = v_rgb . bg - v_alpha_out, the remaining colour term
// r_rem = sum_c (rgb_c - T_final * bg_c) * v_rgb_c and 1 / max(alpha, 1e-5).
// The block then REPLAYS the forward over the tile's first `useful_len`
// slots only, in batches of 64 staged in shared memory, with the forward
// kernel's own round-to-nearest arithmetic, so every pixel blends exactly
// the slots it blended there. For a blended (pixel, slot):
//   v_w     = max(rgb, 0) . v_rgb
//   r_after = r_rem - w * v_w
//   v_alpha = T * v_w - (r_after + T_final * f_t) / (1 - alpha)
// and, only where opac * gauss <= 0.999 (a capped alpha has no gradient):
//   v_sigma = -opac * gauss * v_alpha
//   v_xy    = -v_sigma * (c00 dx + c01 dy, c01 dx + c11 dy)
//   v_conic = (v_sigma dx^2 / 2, v_sigma dx dy, v_sigma dy^2 / 2)
//   v_opac  = gauss * v_alpha
// These live inside the branch a blended pair takes, so a slot with an
// infinite conic (its alpha is NaN or 0 and fails the gate) never reaches a
// product: there is no 0 * inf.
//
// The TPU kernel wrote chunk-indexed gradient blocks and reduced them per
// splat with a sort by gid, an f32 prefix sum and boundary differences,
// because a TPU has no atomics. Here each slot belongs to exactly one tile,
// so the block reduces a slot's 11 sums over its 1024 pixels itself (warp
// shuffles, then one partial per warp in shared memory, added in warp
// order) and stores them once: the stores are race-free and the result is
// the same from run to run. A warp none of whose pixels blended the slot
// skips its reduction. Slots past a tile's useful range, and slots in no
// tile range, are never written: the wrapper hands in a zeroed buffer. The
// per-splat sum over slots is an index_add_ in the wrapper.
//
// Bound on the H100: operations. About 21 f32 operations (one exp) to
// replay a (pixel, slot) pair and about 54 more where it was blended; the
// bytes are 36 per replayed slot, 48 KB of tiles per tile and 44 per slot
// written.
#include "common.cuh"

namespace {

constexpr int kTileWidth = 32;
constexpr int kTilePix = kTileWidth * kTileWidth;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = kTilePix / kThreads;  // pixels per thread
constexpr int kBatch = 64;                 // slots staged per batch
constexpr int kAttrs = 9;                  // SoA rows read
constexpr int kGrads = 11;                 // gradient rows written
constexpr int kFwdRows = 8;                // rows of a saved forward tile
constexpr int kVRows = 4;                  // rows of a cotangent tile

__global__ void __launch_bounds__(kThreads)
rasterize_bwd_kernel(const float* __restrict__ soa, int64_t stride,
                     const int32_t* __restrict__ ranges,
                     const float* __restrict__ tiles,
                     const float* __restrict__ v_tiles,
                     const float* __restrict__ bg, float* __restrict__ grads,
                     int tile_bw, float img_w, float img_h) {
  __shared__ float s_attr[kAttrs][kBatch];
  __shared__ float s_part[kBatch * kWarps * kGrads];

  const int t = blockIdx.x;
  const float* f_tile = tiles + static_cast<int64_t>(t) * kFwdRows * kTilePix;
  const float* v_tile = v_tiles + static_cast<int64_t>(t) * kVRows * kTilePix;
  const int start = ranges[2 * t];
  // The forward wrote useful_len to every lane of row 5, exact in f32.
  const int end = min(start + static_cast<int>(f_tile[5 * kTilePix]),
                      ranges[2 * t + 1]);
  if (end <= start) return;  // the same for every thread of the block

  const float alpha_min = static_cast<float>(1.0 / 255.0);
  const float alpha_cap = 0.999f;
  const float t_eps = 1.0e-4f;
  const float sat_cutoff = 0.999f;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < kBatch * kWarps * kGrads; i += kThreads) {
    s_part[i] = 0.0f;
  }

  // All four pixels of a thread share their column.
  const float px = static_cast<float>((t % tile_bw) * kTileWidth + lane) + 0.5f;
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  float py[kPix], tr[kPix], r_rem[kPix], vr[kPix], vg[kPix], vb[kPix],
      tf_ft[kPix], inv_fa[kPix];
  bool done[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    py[k] = static_cast<float>((t / tile_bw) * kTileWidth + p / kTileWidth)
            + 0.5f;
    const float t_fin = f_tile[4 * kTilePix + p];
    const float final_a = f_tile[3 * kTilePix + p];
    vr[k] = v_tile[p];
    vg[k] = v_tile[kTilePix + p];
    vb[k] = v_tile[2 * kTilePix + p];
    const float v_a = v_tile[3 * kTilePix + p];
    const float f_t = vr[k] * bg_r + vg[k] * bg_g + vb[k] * bg_b - v_a;
    tf_ft[k] = t_fin * f_t;
    r_rem[k] = (f_tile[p] - t_fin * bg_r) * vr[k]
               + (f_tile[kTilePix + p] - t_fin * bg_g) * vg[k]
               + (f_tile[2 * kTilePix + p] - t_fin * bg_b) * vb[k];
    inv_fa[k] = 1.0f / fmaxf(final_a, 1.0e-5f);
    tr[k] = 1.0f;
    done[k] = false;
  }

  for (int base = start; base < end; base += kBatch) {
    const int nb = min(kBatch, end - base);
    for (int i = threadIdx.x; i < kAttrs * kBatch; i += kThreads) {
      const int row = i / kBatch, j = i % kBatch;
      if (j < nb) s_attr[row][j] = soa[row * stride + base + j];
    }
    __syncthreads();  // also orders the zeroing of s_part before its use

    for (int jj = 0; jj < nb; ++jj) {
      const float mx = s_attr[0][jj], my = s_attr[1][jj];
      const float c00 = s_attr[2][jj], c01 = s_attr[3][jj],
                  c11 = s_attr[4][jj];
      const float o = s_attr[5][jj];
      const float r = s_attr[6][jj] < 0.0f ? 0.0f : s_attr[6][jj];
      const float g = s_attr[7][jj] < 0.0f ? 0.0f : s_attr[7][jj];
      const float b = s_attr[8][jj] < 0.0f ? 0.0f : s_attr[8][jj];
      float acc[kGrads];
#pragma unroll
      for (int q = 0; q < kGrads; ++q) acc[q] = 0.0f;
      bool any = false;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        // The forward kernel's arithmetic, operation for operation.
        const float dx = __fsub_rn(px, mx);
        const float dy = __fsub_rn(py[k], my);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(c00, dx), dx),
                                     __fmul_rn(__fmul_rn(c11, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(c01, dx), dy));
        const float gauss = expf(-sigma);
        const float og = __fmul_rn(o, gauss);
        const float alpha = og > alpha_cap ? alpha_cap : og;
        if (!(sigma >= 0.0f && alpha >= alpha_min)) continue;
        const float next_t = __fmul_rn(tr[k], __fsub_rn(1.0f, alpha));
        if (next_t <= t_eps) {
          done[k] = true;
          continue;
        }
        const float w = __fmul_rn(alpha, tr[k]);

        const float v_w = r * vr[k] + g * vg[k] + b * vb[k];
        const float r_after = r_rem[k] - w * v_w;
        const float v_alpha =
            tr[k] * v_w - (r_after + tf_ft[k]) / (1.0f - alpha);
        acc[6] += w * vr[k];
        acc[7] += w * vg[k];
        acc[8] += w * vb[k];
        acc[10] += w;
        if (og <= sat_cutoff) {
          const float v_sigma = -og * v_alpha;
          const float gx = -v_sigma * (c00 * dx + c01 * dy);
          const float gy = -v_sigma * (c01 * dx + c11 * dy);
          acc[0] += gx;
          acc[1] += gy;
          acc[2] += 0.5f * v_sigma * dx * dx;
          acc[3] += v_sigma * dx * dy;
          acc[4] += 0.5f * v_sigma * dy * dy;
          acc[5] += gauss * v_alpha;
          const float sx = gx * img_w, sy = gy * img_h;
          acc[9] += sqrtf(sx * sx + sy * sy) * inv_fa[k];
        }
        tr[k] = next_t;
        r_rem[k] = r_after;
        any = true;
      }
      if (__any_sync(full, any)) {
#pragma unroll
        for (int q = 0; q < kGrads; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc[q] += __shfl_xor_sync(full, acc[q], off);
          }
        }
        if (lane == 0) {
          float* dst = s_part + (jj * kWarps + warp) * kGrads;
#pragma unroll
          for (int q = 0; q < kGrads; ++q) dst[q] = acc[q];
        }
      }
    }
    __syncthreads();

    // One (row, slot) sum per thread: the warps' partials in warp order,
    // the colour rows gated by raw rgb > 0 (the blend uses max(rgb, 0)).
    for (int i = threadIdx.x; i < kGrads * nb; i += kThreads) {
      const int q = i / nb, j = i % nb;
      float* src = s_part + j * kWarps * kGrads + q;
      float sum = 0.0f;
#pragma unroll
      for (int wv = 0; wv < kWarps; ++wv) {
        sum += src[wv * kGrads];
        src[wv * kGrads] = 0.0f;  // ready for the next batch
      }
      if (q >= 6 && q <= 8 && !(s_attr[q][j] > 0.0f)) sum = 0.0f;
      grads[q * stride + base + j] = sum;
    }
    __syncthreads();  // before the next batch overwrites s_attr
  }
}

}  // namespace

// soa: [>= 9, stride] f32 training SoA. ranges: [n_tiles, 2] int32.
// tiles: [n_tiles, 8, 1024] f32 from the training forward. v_tiles:
// [n_tiles, 4, 1024] f32 cotangent of (rgb, alpha) in tile layout. bg: [3].
// grads: [11, stride] f32, zeroed by the caller.
BRUSH_EXPORT int brush_rasterize_bwd(const void* soa, int64_t stride,
                                     const void* ranges, const void* tiles,
                                     const void* v_tiles, const void* bg,
                                     void* grads, int n_tiles, int tile_bw,
                                     int img_w, int img_h, void* stream) {
  if (n_tiles <= 0) return 0;
  rasterize_bwd_kernel<<<n_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soa), stride,
      static_cast<const int32_t*>(ranges), static_cast<const float*>(tiles),
      static_cast<const float*>(v_tiles), static_cast<const float*>(bg),
      static_cast<float*>(grads), tile_bw, static_cast<float>(img_w),
      static_cast<float>(img_h));
  return brush_last_error();
}

// Rasterizer backward: per-splat gradients of the tiles' blend.
//
// Replaces brush_tpu/ops/rasterize_pallas.py:431 `_bwd_kernel` together
// with the per-splat reduce the TPU function does after it
// (`_reduce_grads_sorted` :814, inside `_rasterize_pallas_bwd` :924).
// Inputs: the f32 training SoA, the raw tile ranges, the training
// forward's schedule (its tile order and each tile row's useful length,
// [T, 32]), each sorted slot's splat id (`gid_from_isect`, int32 [S]), the
// forward's saved tiles [T, 8, 1024] (rgb + T*bg, alpha, final T), the
// image cotangent in tile layout [T, 4, 1024] and the background. Output:
// [n, 12] f32, one row of 11 sums per splat (and one pad word): 0,1 v_xy;
// 2..4 v_conic; 5 v_opac; 6..8 v_rgb; 9 the refine weight
// sum_p |v_xy * (W, H)| / max(final alpha_p, 1e-5); 10 sum_p w.
//
// Each pixel first forms, from the saved tile and the cotangent,
// T_final * f_t with f_t = v_rgb . bg - v_alpha_out, the remaining colour
// term r_rem = sum_c (rgb_c - T_final * bg_c) * v_rgb_c and
// 1 / max(alpha, 1e-5). It then REPLAYS the forward over its row's useful
// slots with the forward kernel's own round-to-nearest arithmetic, so it
// blends exactly the slots it blended there. For a blended (pixel, slot):
//   v_w     = max(rgb, 0) . v_rgb
//   r_after = r_rem - w * v_w
//   v_alpha = T * v_w - (r_after + T_final * f_t) / (1 - alpha)
// and, only where opac * gauss <= 0.999 (a capped alpha has no gradient):
//   v_sigma = -opac * gauss * v_alpha
//   v_xy    = -v_sigma * (c00 dx + c01 dy, c01 dx + c11 dy)
//   v_conic = (v_sigma dx^2 / 2, v_sigma dx dy, v_sigma dy^2 / 2)
//   v_opac  = gauss * v_alpha
// These live inside the branch a blended pair takes, so a slot with an
// infinite or NaN conic (its alpha is NaN or 0 and fails the gate) never
// reaches a product: there is no 0 * inf. The colour rows count only
// where the raw colour is > 0 (the blend uses max(rgb, 0)).
//
// What bounds it on the H100: operations, about 21 f32 operations (one
// exp) to replay a (pixel, slot) pair up to its part's useful length and
// about 54 more where it was blended; the bytes (40 per replayed slot, 48 KB of tiles a tile, 44 per
// splat written) are far below. The first design (one block per tile,
// 4 pixels a thread, a cross-warp reduce in shared memory with two
// barriers every 64 slots, one column per slot into an [11, S] buffer
// that a memset cleared and an index_add_ then summed per splat) spent
// three times the kernel's own time in that index_add_, and its longest
// tiles set its time like the forward's.
//
// Design. The forward's work split, two parts to a warp: a work item is two
// vertically stacked 8x4 parts of a tile (an 8x8 block, two pixels a lane),
// items taken from an atomic counter by a persistent grid, tiles in the
// forward's order (descending span), each item replaying only up to the
// longer of its two parts' useful lengths and leaving as soon as its pixels
// are done. (At the train cell and loop step 9: one part a warp 1.41 / 1.51
// ms, two 1.16 / 1.49, four 1.19 / 1.67; rows of 32 pixels instead of 8x4
// parts, two a warp, 1.37 / 1.77; NVIDIA H100 80GB HBM3, 700 W.) A warp
// stages 32 slots at a time in its own corner of shared memory; there are no
// block barriers. For a slot that some pixel of the warp blended, each lane
// adds its two pixels' 11 values, the warp sums them over its 32 lanes with
// a transposing butterfly (16 shuffles: at each step a lane keeps half of
// its values and trades the other half, so the last step leaves each pair of
// lanes with one value's total) and 11 lanes then add the totals into the
// splat's row with one atomicAdd each, skipping a total that is exactly 0 (a
// NaN is added, and spreads as it did through index_add_). Rows of 12 words
// (a slot's 11 adds into one 96-byte span) keep a splat's adds together; an
// [11, n] layout would spread them over 11 lines. The adds are f64: a splat
// in every tile of a 1080p frame takes one add a warp of every tile (65K
// with one row a warp), and f32 sums in atomic order then strayed past 1e-5
// of the row's largest entry (2e-5 on v_opac, where the terms cancel to
// 1/156 of their magnitudes), against 7e-7 for f32 index_add_ of per-slot
// columns. A second launch rounds the f64 sums to the [n, 12] f32 result.
// The sums still add in the order the atomics arrive, which depends on
// timing: two runs may differ by that rounding. One memset in the same C
// call clears the f64 sums and the work counter.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kTileWidth = 32;
constexpr int kTilePix = kTileWidth * kTileWidth;
constexpr int kParts = 32;                // 8x4-pixel parts of a tile
constexpr int kPix = 2;                   // pixels a lane: parts an item
constexpr int kItemsPerTile = kParts / kPix;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGrads = 11;                // gradient rows per splat
constexpr int kGradStride = 12;           // words per splat in the output
constexpr int kFwdRows = 8;               // rows of a saved forward tile
constexpr int kVRows = 4;                 // rows of a cotangent tile
constexpr unsigned kFull = 0xffffffffu;

// Pixel (row-major in the tile) of lane `lane` in part `q`: part q covers
// x in [8 (q % 4), +8), y in [4 (q / 4), +4); the lane is pixel
// (lane % 8, lane / 8) of it. A work item takes kPix parts stacked
// vertically: parts q0, q0 + 4, ... with q0 = part_of_item below.
__device__ __forceinline__ int part_pixel(int q, int lane) {
  return ((q >> 2) * 4 + (lane >> 3)) * kTileWidth + (q & 3) * 8 + (lane & 7);
}
__device__ __forceinline__ int part_of_item(int j) {
  return (j / 4) * (4 * kPix) + (j % 4);
}

// One butterfly step over lanes `2 * kHalf` apart: a lane keeps the upper
// or lower half of its first 2 * kHalf values (by that lane bit), sends
// the other half across and adds what it receives.
template <int kHalf>
__device__ __forceinline__ void trade_half(float (&v)[16], int lane) {
  const bool up = lane & (2 * kHalf);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// Sum 16 values over the warp's 32 lanes. Returns, in lanes 2k and 2k+1,
// the total of value k.
__device__ __forceinline__ float warp_sum16(float (&v)[16], int lane) {
  trade_half<8>(v, lane);
  trade_half<4>(v, lane);
  trade_half<2>(v, lane);
  trade_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

__global__ void __launch_bounds__(kThreads)
rasterize_bwd_kernel(const float* __restrict__ soa, int64_t stride,
                     const int32_t* __restrict__ ranges,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ part_useful,
                     const int32_t* __restrict__ gid, int n_slots,
                     const float* __restrict__ tiles,
                     const float* __restrict__ v_tiles,
                     const float* __restrict__ bg, double* __restrict__ acc64,
                     int32_t* __restrict__ counter, int n_tiles, int tile_bw,
                     float img_w, float img_h) {
  // A warp's staged slots: (x, y, c00, c01), (c11, opac, r, g), (b, gid)
  // with the raw colour (the gate of rows 6..8 needs its sign).
  __shared__ float4 s_slot[kWarps][32][3];
  const float alpha_min = static_cast<float>(1.0 / 255.0);
  const float alpha_cap = 0.999f;
  const float t_eps = 1.0e-4f;
  const float sat_cutoff = 0.999f;
  const int lane = threadIdx.x & 31;
  const int slot_of_lane = (lane >> 1) & 15;  // the total warp_sum16 leaves
  float4(*mine)[3] = s_slot[threadIdx.x >> 5];
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  const int n_items = n_tiles * kItemsPerTile;

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= n_items) break;
    const int t = order[item / kItemsPerTile];
    const int q0 = part_of_item(item % kItemsPerTile);
    const int start = ranges[2 * t];
    int useful = 0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      useful = max(useful, part_useful[t * kParts + q0 + 4 * k]);
    }
    // Slots past the id table carry no splat (the plain version drops
    // them); the blend up to there is the same either way.
    const int end = min(min(start + useful, ranges[2 * t + 1]), n_slots);
    if (end <= start) continue;  // the same for every lane

    const float* f_tile = tiles + static_cast<int64_t>(t) * kFwdRows * kTilePix;
    const float* v_tile = v_tiles + static_cast<int64_t>(t) * kVRows * kTilePix;
    const float px = static_cast<float>((t % tile_bw) * kTileWidth
                                        + part_pixel(q0, lane) % kTileWidth)
                     + 0.5f;
    float py[kPix], tr[kPix], r_rem[kPix], vr[kPix], vg[kPix], vb[kPix],
        tf_ft[kPix], inv_fa[kPix];
    bool done[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = part_pixel(q0 + 4 * k, lane);
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

    for (int base = start; base < end; base += 32) {
      const int i = base + lane;
      if (i < end) {
        mine[lane][0] = make_float4(soa[i], soa[stride + i],
                                    soa[2 * stride + i], soa[3 * stride + i]);
        mine[lane][1] = make_float4(soa[4 * stride + i], soa[5 * stride + i],
                                    soa[6 * stride + i], soa[7 * stride + i]);
        mine[lane][2] = make_float4(soa[8 * stride + i],
                                    __int_as_float(gid[i]), 0.0f, 0.0f);
      }
      __syncwarp();
      const int nb = min(32, end - base);
      for (int jj = 0; jj < nb; ++jj) {
        const float4 a = mine[jj][0];
        const float4 b = mine[jj][1];
        const float4 c = mine[jj][2];
        const float mx = a.x, my = a.y, c00 = a.z, c01 = a.w;
        const float c11 = b.x, o = b.y;
        const float r = b.z < 0.0f ? 0.0f : b.z;
        const float g = b.w < 0.0f ? 0.0f : b.w;
        const float bl = c.x < 0.0f ? 0.0f : c.x;
        float acc[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] = 0.0f;
        bool blended = false;
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
          const float v_w = r * vr[k] + g * vg[k] + bl * vb[k];
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
          blended = true;
        }
        if (__any_sync(kFull, blended)) {
          float total = warp_sum16(acc, lane);
          // The colour rows count where the raw colour is > 0.
          const float raw = slot_of_lane == 6 ? b.z
                            : slot_of_lane == 7 ? b.w : c.x;
          if (slot_of_lane >= 6 && slot_of_lane <= 8 && !(raw > 0.0f)) {
            total = 0.0f;
          }
          if ((lane & 1) == 0 && slot_of_lane < kGrads && total != 0.0f) {
            const int64_t splat = __float_as_int(c.y);
            atomicAdd(acc64 + splat * kGradStride + slot_of_lane,
                      static_cast<double>(total));
          }
        }
      }
      // Also orders this batch's reads before the next batch's stores.
      bool all_done = true;
#pragma unroll
      for (int k = 0; k < kPix; ++k) all_done = all_done && done[k];
      if (__all_sync(kFull, all_done)) break;
    }
  }
}

// The f64 sums rounded to f32, two words a thread.
__global__ void __launch_bounds__(kThreads)
round_sums_kernel(const double2* __restrict__ acc64, float2* __restrict__ out,
                  int64_t pairs) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < pairs; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const double2 v = acc64[i];
    out[i] = make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
}

struct Grid {
  int sms = 0;
  int bwd_blocks = 0;  // the persistent grid: as many as fit at once
};

const Grid& grid() {
  static Grid g;
  if (g.sms == 0) {
    int dev = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rasterize_bwd_kernel, kThreads, 0);
    g.bwd_blocks = g.sms * (per_sm > 0 ? per_sm : 1);
  }
  return g;
}

}  // namespace

// soa: [>= 9, stride] f32 training SoA. ranges: [n_tiles, 2] int32.
// order: [n_tiles] int32 tile permutation; part_useful: [n_tiles, 32] int32
// (both from the training forward). gid: [n_slots] int32 splat id of each
// sorted slot, each < n. tiles: [n_tiles, 8, 1024] f32 from the training
// forward. v_tiles: [n_tiles, 4, 1024] f32 cotangent of (rgb, alpha) in
// tile layout. bg: [3]. scratch: n * 12 + 2 f64 words, the sums and then
// the work counter, cleared here. grads: [n, 12] f32, written whole.
BRUSH_EXPORT int brush_rasterize_bwd(const void* soa, int64_t stride,
                                     const void* ranges, const void* order,
                                     const void* part_useful, const void* gid,
                                     int n_slots, const void* tiles,
                                     const void* v_tiles, const void* bg,
                                     void* scratch, void* grads, int64_t n,
                                     int n_tiles, int tile_bw, int img_w,
                                     int img_h, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t words = n * kGradStride;
  double* acc64 = static_cast<double*>(scratch);
  cudaMemsetAsync(acc64, 0, (words + 2) * sizeof(double), s);
  const Grid& g = grid();
  if (n_tiles > 0) {
    const int items = n_tiles * kItemsPerTile;
    rasterize_bwd_kernel<<<std::min(g.bwd_blocks,
                                    (items + kWarps - 1) / kWarps),
                           kThreads, 0, s>>>(
        static_cast<const float*>(soa), stride,
        static_cast<const int32_t*>(ranges),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(part_useful),
        static_cast<const int32_t*>(gid), n_slots,
        static_cast<const float*>(tiles), static_cast<const float*>(v_tiles),
        static_cast<const float*>(bg), acc64,
        reinterpret_cast<int32_t*>(acc64 + words), n_tiles, tile_bw,
        static_cast<float>(img_w), static_cast<float>(img_h));
  }
  const int64_t pairs = words / 2;  // kGradStride is even
  if (pairs > 0) {
    const int64_t blocks = std::min<int64_t>((pairs + kThreads - 1) / kThreads,
                                             static_cast<int64_t>(g.sms) * 16);
    round_sums_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
        reinterpret_cast<const double2*>(acc64), static_cast<float2*>(grads),
        pairs);
  }
  return brush_last_error();
}

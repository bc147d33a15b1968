// Splat projection, forward: every `ProjectedSplats` field of a view
// through a pinhole or a KB4 fisheye lens, one thread a splat.
//
// Replaces no TPU kernel. The reference package projects in jnp
// (brush_tpu/ops/projection.py `project_splats`), which XLA fuses into a
// few passes; the port's PyTorch version of it (ops/projection.py) runs
// about 650 elementwise passes over the splat rows. Reached through
// `project_forward` (ops/project_cuda.py), which `project` calls for CUDA
// tensors and a Pinhole or KannalaBrandt4 lens. The lens is a template
// parameter (`proj::Pinhole`, `proj::Kb4`, project.cuh) and its
// coefficients kernel arguments; the two instantiations share everything
// but the lens's near gate, position and Jacobian.
//
// Inputs, row g of each (contiguous float32): means [N, 3], log_scales
// [N, 3], quats [N, 4] (w, x, y, z), sh [N, K, 3] (the first
// (deg + 1)^2 coefficients are used; k3 = 3K floats a row), raw_opacities
// [N]; the view: viewmat [3, 4], pinhole [fx, fy, cx, cy], clamp limits
// [4], cam_pos [3]. Outputs (contiguous): visible [N] bool, depth [N],
// mean2d [N, 2], conic [N, 3], color [N, 3], opac [N], power_threshold
// [N], tile_min and tile_max [N, 2] int32, num_tiles_bbox [N] int32,
// max_radius [N], flags [N] uint8 (bit 0 visible, bit 1 + c colour channel
// c's SH sum on the raw coefficients was finite).
//
// Bound on the H100: bytes. A row is read once (236 bytes of a live splat
// at degree 3) and 70 bytes are written. The SH rows of a warp's 32
// splats are copied into shared memory with loads of 32 consecutive floats
// (`proj::stage_rows`), and each lane reads its own row from there.
//
// The plain version evaluates every gate on the raw row (pass 1), then
// the math on a sanitised row (pass 2): a culled splat becomes the unit
// splat in front of the camera. For a visible splat the two passes see the
// same numbers, so the kernel runs the math once on the raw row, and again
// on the unit splat where a gate fails. A splat whose sigmoid(opacity) is
// under 1/255 fails the opacity gate whatever its shape (the mip
// compensation is at most 1), so it skips the first run. Every float32
// operation repeats the plain version's in its order, with round-to-
// nearest intrinsics so that nvcc contracts nothing into an FMA; a Python
// constant is the float32 of its double, a division of a tensor by a
// Python number is the product with its float32 reciprocal (as PyTorch's
// CUDA kernels divide), `1.0 / x` is the reciprocal, the pinhole
// Jacobian's entries are the float32 products `jacfwd` forms, and KB4's
// are its float32 closed form (`kb4_jacobian`). A sum over a
// row's four or three entries (the quaternion's and the view direction's
// squared norms, `torch.sum` in the plain version) adds them in the order
// PyTorch's CUDA reduction does, (a + c) + (b + d) and (a + c) + b (read on
// the card with PyTorch 2.11; its CPU reduction adds otherwise); only the
// SH sum over k (colour) may add in another order than PyTorch's. So
// through either lens every field but the colour is the plain version's
// bit for bit (`compare_forward`).
#include "project.cuh"

namespace {

using namespace proj;

// What one run of the math gives (ProjectedSplats less the colour).
struct Out {
  bool ok;
  float depth, u, v, k0, k1, k2, opac, pt, max_radius;
  int tmin_x, tmin_y, tmax_x, tmax_y, tiles;
};

// ops/projection.py `_project_math` on one row, without the colour.
template <bool MIP, class Lens>
__device__ __forceinline__ Out project_math(const float* m, const float* ls,
                                            const float* q, float ro,
                                            const Cam& c, const LensArgs& l,
                                            int img_w, int img_h) {
  Out o;
  float mc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mc[i] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(m[0], c.r[i][0]),
                            __fmul_rn(m[1], c.r[i][1])),
                  __fmul_rn(m[2], c.r[i][2])),
        c.t[i]);
  }
  const float z = mc[2];
  bool ok = finite(mc[0]) && finite(mc[1]) && finite(z) &&
            z <= F(1.0e10) &&
            (Lens::kFisheye
                 ? in_render_field(mc[0], mc[1], z, render_field(l))
                 : z >= F(0.01));
  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[k] = expf(ls[k]);
    ok = ok && finite(s[k]);
  }
  // torch.sum over the row, in its CUDA reduction's order (a+c)+(b+d).
  const float qn2 =
      __fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[2], q[2])),
                __fadd_rn(__fmul_rn(q[1], q[1]), __fmul_rn(q[3], q[3])));
  ok = ok && qn2 >= F(1.0e-6) && finite(qn2) && finite(ro);
  const float qnorm = __fsqrt_rn(clamp_min(qn2, F(1e-32)));
  const float qw = __fdiv_rn(q[0], qnorm), qx = __fdiv_rn(q[1], qnorm);
  const float qy = __fdiv_rn(q[2], qnorm), qz = __fdiv_rn(q[3], qnorm);
  const float xx = __fmul_rn(qx, qx), yy = __fmul_rn(qy, qy);
  const float zz = __fmul_rn(qz, qz);
  const float xy = __fmul_rn(qx, qy), xz = __fmul_rn(qx, qz);
  const float yz = __fmul_rn(qy, qz);
  const float wx = __fmul_rn(qw, qx), wy = __fmul_rn(qw, qy);
  const float wz = __fmul_rn(qw, qz);
  const float rq[3][3] = {
      {__fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(yy, zz))),
       __fmul_rn(2.0f, __fsub_rn(xy, wz)), __fmul_rn(2.0f, __fadd_rn(xz, wy))},
      {__fmul_rn(2.0f, __fadd_rn(xy, wz)),
       __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, zz))),
       __fmul_rn(2.0f, __fsub_rn(yz, wx))},
      {__fmul_rn(2.0f, __fsub_rn(xz, wy)), __fmul_rn(2.0f, __fadd_rn(yz, wx)),
       __fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(xx, yy)))}};
  float ns[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ns[i][k] = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(c.r[i][0], rq[0][k]),
                              __fmul_rn(c.r[i][1], rq[1][k])),
                    __fmul_rn(c.r[i][2], rq[2][k])),
          s[k]);
    }
  }
  // The Jacobian at the clamp-adjusted point (ops/camera_proj.py).
  const float xn = clamp(__fdiv_rn(mc[0], z), c.lim[0], c.lim[1]);
  const float yn = clamp(__fdiv_rn(mc[1], z), c.lim[2], c.lim[3]);
  float j[2][3];
  Lens::jacobian(c, l, __fmul_rn(xn, z), __fmul_rn(yn, z), z, j);
  Lens::project(c, l, mc[0], mc[1], z, o.u, o.v);
  float vv[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      vv[a][k] = __fadd_rn(__fadd_rn(__fmul_rn(j[a][0], ns[0][k]),
                                     __fmul_rn(j[a][1], ns[1][k])),
                           __fmul_rn(j[a][2], ns[2][k]));
    }
  }
  float c00 = __fadd_rn(__fadd_rn(__fmul_rn(vv[0][0], vv[0][0]),
                                  __fmul_rn(vv[0][1], vv[0][1])),
                        __fmul_rn(vv[0][2], vv[0][2]));
  float c01 = __fadd_rn(__fadd_rn(__fmul_rn(vv[0][0], vv[1][0]),
                                  __fmul_rn(vv[0][1], vv[1][1])),
                        __fmul_rn(vv[0][2], vv[1][2]));
  float c11 = __fadd_rn(__fadd_rn(__fmul_rn(vv[1][0], vv[1][0]),
                                  __fmul_rn(vv[1][1], vv[1][1])),
                        __fmul_rn(vv[1][2], vv[1][2]));
  const float max_abs =
      nan_max(nan_max(fabsf(c00), fabsf(c11)), fabsf(c01));
  const float sd =
      max_abs > F(1.0e18)
          ? __fmul_rn(__frcp_rn(clamp_min(max_abs, F(1e-30))), F(1.0e18))
          : 1.0f;
  c00 = __fmul_rn(c00, sd);
  c01 = __fmul_rn(c01, sd);
  c11 = __fmul_rn(c11, sd);
  const float blur = MIP ? F(0.1) : F(0.3);
  const float b00 = __fadd_rn(c00, blur), b11 = __fadd_rn(c11, blur);
  const float sig =
      __frcp_rn(__fadd_rn(1.0f, expf(-ro)));
  float opac = sig;
  if (MIP) {
    const float det_raw = clamp_min(
        __fsub_rn(__fmul_rn(c00, c11), __fmul_rn(c01, c01)), 0.0f);
    const float det_blur =
        __fsub_rn(__fmul_rn(b00, b11), __fmul_rn(c01, c01));
    opac = __fmul_rn(sig, __fsqrt_rn(__fdiv_rn(det_raw, det_blur)));
  }
  ok = ok && finite(b00) && finite(b11) && finite(c01) &&
       opac >= F(1.0 / 255.0);
  const float det = __fsub_rn(__fmul_rn(b00, b11), __fmul_rn(c01, c01));
  const float inv_det = det > 0.0f ? __frcp_rn(det) : 0.0f;
  o.k0 = __fmul_rn(b11, inv_det);
  o.k1 = __fmul_rn(-c01, inv_det);
  o.k2 = __fmul_rn(b00, inv_det);
  o.opac = opac;
  o.pt = logf(__fmul_rn(clamp_min(opac, F(1e-30)), 255.0f));
  const float cdet = __fsub_rn(__fmul_rn(o.k0, o.k2), __fmul_rn(o.k1, o.k1));
  const bool degenerate = cdet <= 0.0f;
  const float cinv = degenerate ? 0.0f : __frcp_rn(cdet);
  const float two_pt = __fmul_rn(2.0f, o.pt);
  const float ex = __fsqrt_rn(
      clamp_min(__fmul_rn(__fmul_rn(two_pt, o.k2), cinv), 0.0f));
  const float ey = __fsqrt_rn(
      clamp_min(__fmul_rn(__fmul_rn(two_pt, o.k0), cinv), 0.0f));
  const float fw = static_cast<float>(img_w);
  const float fh = static_cast<float>(img_h);
  ok = ok && !degenerate && __fadd_rn(o.u, ex) > 0.0f &&
       __fsub_rn(o.u, ex) < fw && __fadd_rn(o.v, ey) > 0.0f &&
       __fsub_rn(o.v, ey) < fh;
  // Tile bbox: x / 32 is exact, as PyTorch's product with 1/32 is.
  const float tile_bw = static_cast<float>((img_w + 31) / 32);
  const float tile_bh = static_cast<float>((img_h + 31) / 32);
  const float ux = __fdiv_rn(o.u, kTile), vy = __fdiv_rn(o.v, kTile);
  const float ext_x = __fdiv_rn(ex, kTile), ext_y = __fdiv_rn(ey, kTile);
  // _to_i32: NaN -> 0, then truncation of a value clamped to the grid.
  auto to_i32 = [](float x) { return x != x ? 0 : __float2int_rz(x); };
  o.tmin_x = to_i32(clamp(__fsub_rn(ux, ext_x), 0.0f, tile_bw));
  o.tmin_y = to_i32(clamp(__fsub_rn(vy, ext_y), 0.0f, tile_bh));
  o.tmax_x = to_i32(
      clamp(__fadd_rn(__fadd_rn(ux, ext_x), 1.0f), 0.0f, tile_bw));
  o.tmax_y = to_i32(
      clamp(__fadd_rn(__fadd_rn(vy, ext_y), 1.0f), 0.0f, tile_bh));
  o.tiles = ok ? (o.tmax_x - o.tmin_x) * (o.tmax_y - o.tmin_y) : 0;
  // ex / img_w: PyTorch's CUDA division by a Python number.
  o.max_radius = ok ? nan_max(__fmul_rn(ex, __frcp_rn(fw)),
                              __fmul_rn(ey, __frcp_rn(fh)))
                    : 0.0f;
  o.depth = z;
  o.ok = ok;
  return o;
}

template <int DEG, bool MIP, class Lens>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ quats,
                   const float* __restrict__ sh, int64_t k3,
                   const float* __restrict__ raw_opac,
                   const float* __restrict__ viewmat,
                   const float* __restrict__ pinhole,
                   const float* __restrict__ clamp_lim,
                   const float* __restrict__ cam_pos, LensArgs lens, int n,
                   int img_w, int img_h, float unit_opacity,
                   bool* __restrict__ visible,
                   float* __restrict__ depth, float* __restrict__ mean2d,
                   float* __restrict__ conic, float* __restrict__ color,
                   float* __restrict__ opac, float* __restrict__ threshold,
                   int* __restrict__ tile_min, int* __restrict__ tile_max,
                   int* __restrict__ num_tiles, float* __restrict__ radius,
                   uint8_t* __restrict__ flags) {
  using R = ShRow<DEG>;
  constexpr int kCoeffs = (DEG + 1) * (DEG + 1);
  __shared__ float rows_s[kWarps * R::kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row0 = g - lane;
  if (row0 >= n) return;  // the whole warp is past the end
  float* my_rows = rows_s + warp * R::kWarpFloats;
  stage_rows<DEG>(sh, k3, row0, n, my_rows, lane);
  if (g >= n) return;
  const Cam c = load_cam(viewmat, pinhole, clamp_lim, cam_pos);

  const float m[3] = {means[3 * g], means[3 * g + 1], means[3 * g + 2]};
  const float ro = raw_opac[g];
  // Colour on the raw row: finite exactly where pass 1 found it finite
  // (a non-finite coefficient makes its channel's sum non-finite), and
  // then the visible splat's colour (its coefficients are its own).
  float vd[3];
  view_dir(m, c, vd);
  float b[kCoeffs];
  sh_basis<DEG>(vd[0], vd[1], vd[2], b);
  const float* my = my_rows + lane * R::kStride;
  float col[3];
  int cf = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = __fmul_rn(b[0], my[ch]);
#pragma unroll
    for (int k = 1; k < kCoeffs; ++k) {
      acc = __fadd_rn(acc, __fmul_rn(b[k], my[3 * k + ch]));
    }
    col[ch] = __fadd_rn(acc, 0.5f);
    if (finite(col[ch])) cf |= 2 << ch;
  }

  const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-ro)));
  Out o;
  o.ok = false;
  if (sig >= F(1.0 / 255.0)) {
    const float ls[3] = {log_scales[3 * g], log_scales[3 * g + 1],
                         log_scales[3 * g + 2]};
    const float q[4] = {quats[4 * g], quats[4 * g + 1], quats[4 * g + 2],
                        quats[4 * g + 3]};
    o = project_math<MIP, Lens>(m, ls, q, ro, c, lens, img_w, img_h);
  }
  if (!o.ok) {
    // The unit splat in front of the camera, colour 0.5 where finite.
    const float um[3] = {c.pos[0], c.pos[1], __fadd_rn(c.pos[2], 1.0f)};
    const float uls[3] = {0.0f, 0.0f, 0.0f};
    const float uq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
    o = project_math<MIP, Lens>(um, uls, uq, unit_opacity, c, lens, img_w,
                                img_h);
    o.ok = false;
    o.tiles = 0;
    o.max_radius = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) col[ch] = 0.5f;
  }
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    color[3 * g + ch] =
        (cf & (2 << ch)) ? clamp(col[ch], F(-100.0), F(100.0)) : 0.0f;
  }
  visible[g] = o.ok;
  flags[g] = static_cast<uint8_t>(cf | (o.ok ? 1 : 0));
  depth[g] = o.depth;
  mean2d[2 * g] = o.u;
  mean2d[2 * g + 1] = o.v;
  conic[3 * g] = o.k0;
  conic[3 * g + 1] = o.k1;
  conic[3 * g + 2] = o.k2;
  opac[g] = o.opac;
  threshold[g] = o.pt;
  tile_min[2 * g] = o.tmin_x;
  tile_min[2 * g + 1] = o.tmin_y;
  tile_max[2 * g] = o.tmax_x;
  tile_max[2 * g + 1] = o.tmax_y;
  num_tiles[g] = o.tiles;
  radius[g] = o.max_radius;
}

template <int DEG, bool MIP, class Lens>
int launch(const void* means, const void* log_scales, const void* quats,
           const void* sh, int64_t k3, const void* raw_opac,
           const void* viewmat, const void* pinhole, const void* clamp_lim,
           const void* cam_pos, const LensArgs& lens, int n, int img_w,
           int img_h, void* const* out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  project_fwd_kernel<DEG, MIP, Lens><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(means), static_cast<const float*>(log_scales),
      static_cast<const float*>(quats), static_cast<const float*>(sh), k3,
      static_cast<const float*>(raw_opac), static_cast<const float*>(viewmat),
      static_cast<const float*>(pinhole),
      static_cast<const float*>(clamp_lim),
      static_cast<const float*>(cam_pos), lens, n, img_w, img_h,
      // The unit splat's raw opacity, -10, as an argument: nvcc would fold
      // expf(10.0f) of a literal, and not as the device's expf rounds it.
      -10.0f, static_cast<bool*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]),
      static_cast<float*>(out[4]), static_cast<float*>(out[5]),
      static_cast<float*>(out[6]), static_cast<int*>(out[7]),
      static_cast<int*>(out[8]), static_cast<int*>(out[9]),
      static_cast<float*>(out[10]), static_cast<uint8_t*>(out[11]));
  return brush_last_error();
}

template <bool MIP, class Lens>
int by_degree(int deg, const void* means, const void* log_scales,
              const void* quats, const void* sh, int64_t k3,
              const void* raw_opac, const void* viewmat, const void* pinhole,
              const void* clamp_lim, const void* cam_pos,
              const LensArgs& lens, int n, int img_w, int img_h,
              void* const* out, cudaStream_t stream) {
#define PROJ_ARGS                                                          \
  means, log_scales, quats, sh, k3, raw_opac, viewmat, pinhole, clamp_lim, \
      cam_pos, lens, n, img_w, img_h, out, stream
  switch (deg) {
    case 0: return launch<0, MIP, Lens>(PROJ_ARGS);
    case 1: return launch<1, MIP, Lens>(PROJ_ARGS);
    case 2: return launch<2, MIP, Lens>(PROJ_ARGS);
    case 3: return launch<3, MIP, Lens>(PROJ_ARGS);
    case 4: return launch<4, MIP, Lens>(PROJ_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROJ_ARGS
}

template <class Lens>
int by_mip(int mip, int deg, const void* means, const void* log_scales,
           const void* quats, const void* sh, int64_t k3,
           const void* raw_opac, const void* viewmat, const void* pinhole,
           const void* clamp_lim, const void* cam_pos, const LensArgs& lens,
           int n, int img_w, int img_h, void* const* out,
           cudaStream_t stream) {
  return mip ? by_degree<true, Lens>(deg, means, log_scales, quats, sh, k3,
                                     raw_opac, viewmat, pinhole, clamp_lim,
                                     cam_pos, lens, n, img_w, img_h, out,
                                     stream)
             : by_degree<false, Lens>(deg, means, log_scales, quats, sh, k3,
                                      raw_opac, viewmat, pinhole, clamp_lim,
                                      cam_pos, lens, n, img_w, img_h, out,
                                      stream);
}

}  // namespace

// All pointers are device pointers to contiguous arrays (layouts above);
// k = K, the coefficients a row holds (k >= (sh_degree + 1)^2). lens: 0
// the pinhole, 1 KB4 with k1-k4 and the cull's half field half_fov, or
// the device float at half_fov_at where that is not null.
BRUSH_EXPORT int brush_project_fwd(
    const void* means, const void* log_scales, const void* quats,
    const void* sh, int64_t k, const void* raw_opac, const void* viewmat,
    const void* pinhole, const void* clamp_lim, const void* cam_pos,
    int64_t n, int img_w, int img_h, int sh_degree, int mip, int lens,
    double k1, double k2, double k3, double k4, float half_fov,
    const void* half_fov_at, void* visible,
    void* depth, void* mean2d, void* conic, void* color, void* opac,
    void* threshold, void* tile_min, void* tile_max, void* num_tiles,
    void* radius, void* flags, void* stream) {
  if (n < 0 || n > INT_MAX - proj::kThreads || img_w <= 0 || img_h <= 0 ||
      sh_degree < 0 || sh_degree > 4 ||
      k < (sh_degree + 1) * (sh_degree + 1) || lens < 0 || lens > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  void* const out[12] = {visible, depth, mean2d, conic, color, opac,
                         threshold, tile_min, tile_max, num_tiles, radius,
                         flags};
  const auto s = static_cast<cudaStream_t>(stream);
  const proj::LensArgs l = proj::lens_args(
      k1, k2, k3, k4, half_fov, static_cast<const float*>(half_fov_at));
  return lens == 1
             ? by_mip<proj::Kb4>(mip, sh_degree, means, log_scales, quats, sh,
                                 3 * k, raw_opac, viewmat, pinhole, clamp_lim,
                                 cam_pos, l, static_cast<int>(n), img_w,
                                 img_h, out, s)
             : by_mip<proj::Pinhole>(mip, sh_degree, means, log_scales,
                                     quats, sh, 3 * k, raw_opac, viewmat,
                                     pinhole, clamp_lim, cam_pos, l,
                                     static_cast<int>(n), img_w, img_h, out,
                                     s);
}

// What the projection's forward (project.cu) and backward (project_bwd.cu)
// kernels share: the camera, the constants of ops/projection.py as PyTorch
// rounds them, the SH basis of ops/sh.py, and the staging of a warp's SH
// rows through shared memory.
#pragma once

#include <climits>

#include "common.cuh"

namespace proj {

// Python floats reach PyTorch's float32 operations rounded from their
// double value: so here (F(0.3) is not always 0.3f).
#define F(x) static_cast<float>(x)

constexpr int kThreads = 128;          // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr float kTile = 32.0f;         // TILE_WIDTH

// Floats a splat's SH row holds at `deg` (num_sh_coeffs * 3), and the
// shared-memory stride of a staged row: odd, so a warp's lanes reading
// their own rows hit 32 different banks.
template <int DEG>
struct ShRow {
  static constexpr int kUsed = (DEG + 1) * (DEG + 1) * 3;
  static constexpr int kStride = kUsed | 1;
  static constexpr int kWarpFloats = 32 * kStride;
};

// The per-view uniforms (ops/projection.py CameraInputs), read by every
// thread from device memory.
struct Cam {
  float r[3][3], t[3];
  float fx, fy, cx, cy;
  float lim[4];
  float pos[3];
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ viewmat,
                                        const float* __restrict__ pinhole,
                                        const float* __restrict__ clamp,
                                        const float* __restrict__ cam_pos) {
  Cam c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.r[i][j] = __ldg(viewmat + 4 * i + j);
    c.t[i] = __ldg(viewmat + 4 * i + 3);
    c.pos[i] = __ldg(cam_pos + i);
  }
  c.fx = __ldg(pinhole);
  c.fy = __ldg(pinhole + 1);
  c.cx = __ldg(pinhole + 2);
  c.cy = __ldg(pinhole + 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) c.lim[i] = __ldg(clamp + i);
  return c;
}

// The lens's coefficients, kernel arguments (every dataset has its own),
// and the fisheye cull's half render field. `k` holds KB4's k1-k4, `d1`
// the products 3 k1, 5 k2, 7 k3, 9 k4 of d' and `d2` 6 k1, 20 k2, 42 k3,
// 72 k4 of d'': each the float32 of a Python double, since the plain
// version multiplies the coefficients as Python floats and PyTorch rounds
// such a scalar to float32 (`lens_args` forms them on the host). The
// field is `half_fov`, or where `half_fov_at` is set the float32 it points
// to on the device (a captured step's views write theirs into its
// camera). A pinhole reads none of them; the backward, not the field.
struct LensArgs {
  float k[4], d1[4], d2[4];
  float half_fov;
  const float* half_fov_at;
};

inline LensArgs lens_args(double k1, double k2, double k3, double k4,
                          float half_fov, const float* half_fov_at) {
  return LensArgs{{F(k1), F(k2), F(k3), F(k4)},
                  {F(3.0 * k1), F(5.0 * k2), F(7.0 * k3), F(9.0 * k4)},
                  {F(6.0 * k1), F(20.0 * k2), F(42.0 * k3), F(72.0 * k4)},
                  half_fov,
                  half_fov_at};
}

__device__ __forceinline__ float render_field(const LensArgs& l) {
  return l.half_fov_at != nullptr ? __ldg(l.half_fov_at) : l.half_fov;
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// The lenses, a template parameter of both kernels (ops/camera_proj.py).
// Each gives `project`, the pixel position of a camera-space point, and
// `jacobian`, the 2x3 Jacobian of that position, which the kernels take
// at the clamp-adjusted point (xn z, yn z, z); both in the plain version's
// float32 operations and order, with round-to-nearest intrinsics, so that
// they are its values bit for bit. `kFisheye` picks the near gate: the
// near plane, or the render field's half angle. KB4 adds `jacobian_vjp`
// for the backward; the pinhole backward keeps its own fused closed form
// (project_bwd.cu).

__device__ __forceinline__ float radius2(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// The pinhole. The position is x / z through the float32 reciprocal, as
// `1.0 / z` is; the Jacobian's entries are the float32 products `jacfwd`
// forms.
struct Pinhole {
  static constexpr bool kFisheye = false;

  __device__ __forceinline__ static void project(const Cam& c,
                                                 const LensArgs&, float x,
                                                 float y, float z, float& u,
                                                 float& v) {
    const float iz = __frcp_rn(z);
    u = __fadd_rn(__fmul_rn(__fmul_rn(c.fx, x), iz), c.cx);
    v = __fadd_rn(__fmul_rn(__fmul_rn(c.fy, y), iz), c.cy);
  }

  __device__ __forceinline__ static void jacobian(const Cam& c,
                                                  const LensArgs&, float xc,
                                                  float yc, float z,
                                                  float (&j)[2][3]) {
    const float iz = __frcp_rn(z);
    const float niz2 = -__fmul_rn(iz, iz);
    j[0][0] = __fmul_rn(c.fx, iz);
    j[0][1] = 0.0f;
    j[0][2] = __fmul_rn(__fmul_rn(c.fx, xc), niz2);
    j[1][0] = 0.0f;
    j[1][1] = __fmul_rn(c.fy, iz);
    j[1][2] = __fmul_rn(__fmul_rn(c.fy, yc), niz2);
  }
};

// Kannala-Brandt with four coefficients (COLMAP's OPENCV_FISHEYE). A
// point at r = sqrt(x^2 + y^2) off the axis and theta = atan2(r, z) lands
// at (fx d x / r + cx, fy d y / r + cy), d = theta (1 + t2 (k1 + t2 (k2 +
// t2 (k3 + t2 k4)))), t2 = theta^2; where r^2 < 1e-12 at the pinhole's.
//
// `project` is ops/camera_proj.py `_project_kb4` (`1.0 / r` as the
// reciprocal). `jacobian` is its `kb4_jacobian`, the closed form that
// portbench/reference/lens.py `kb4_jacobian` writes out: with rho2 = r^2 +
// z^2, d' = 1 + t2 (3 k1 + t2 (5 k2 + t2 (7 k3 + 9 k4 t2))), s = d / r,
// p = d' z / rho2, c = (p - s) / r^2 and dz = -d' / rho2,
//
//   J = [[fx (s + c x^2), fx c x y, fx x dz],
//        [fy c x y, fy (s + c y^2), fy y dz]],
//
// and near the axis the pinhole's [[fx / z, 0, -fx x / z^2], [0, fy / z,
// -fy y / z^2]].
//
// `jacobian_vjp` (`kb4_jacobian_vjp`, held to the backward's rule, not bit
// for bit) carries a cotangent G of J back to the point: the gradient of
// L = sum G_ai J_ai. With A = fx G00, B = fx G01, C = fx G02, D = fy G10,
// E = fy G11, F = fy G12, L = s (A + E) + c Q + dz P, where Q = A x^2 +
// (B + D) x y + E y^2 and P = C x + F y. s, c and dz depend on (r, z)
// alone; from theta_r = z / rho2, theta_z = -r / rho2 and d'' = theta (6
// k1 + t2 (20 k2 + t2 (42 k3 + 72 k4 t2))):
//
//   s_r = c r,  s_z = dz,
//   eta = (d'' z / r - 2 d') / rho2^2,  c_z = -eta,
//   c_r / r = (z eta - 3 c) / r^2,  dz_r / r = -eta,
//   dz_z = (d'' r + 2 z d') / rho2^2,
//
// so with Wr = (A + E) c + Q (z eta - 3 c) / r^2 - P eta (the r-derivative
// of L through s, c, dz, over r),
//
//   dL/dx = Wr x + c (2 A x + (B + D) y) + dz C,
//   dL/dy = Wr y + c ((B + D) x + 2 E y) + dz F,
//   dL/dz = (A + E) dz - Q eta + P (d'' r + 2 z d') / rho2^2;
//
// near the axis, of the pinhole's J: (-C / z^2, -F / z^2,
// -(A + E) / z^2 + 2 (C x + F y) / z^3). Every branch computes only its
// own terms, so the one not taken cannot make a row non-finite. Near the
// axis (r under ~1e-3 z) p - s cancels: c's error there is a rounding of
// 1 / z over r^2, which J multiplies back by x^2, and which the VJP
// leaves at about 2^-24 z / r of the row's gradient.
struct Kb4 {
  static constexpr bool kFisheye = true;

  __device__ __forceinline__ static bool axis(float r2) {
    return r2 < F(1e-12);
  }

  // a0 + t2 (a1 + t2 (a2 + t2 a3)).
  __device__ __forceinline__ static float horner(float t2,
                                                 const float (&a)[4]) {
    float p = __fadd_rn(__fmul_rn(t2, a[3]), a[2]);
    p = __fadd_rn(__fmul_rn(t2, p), a[1]);
    return __fadd_rn(__fmul_rn(t2, p), a[0]);
  }

  // d(theta).
  __device__ __forceinline__ static float distort(const LensArgs& l,
                                                  float theta, float t2) {
    return __fmul_rn(theta, __fadd_rn(__fmul_rn(t2, horner(t2, l.k)), 1.0f));
  }

  __device__ __forceinline__ static void project(const Cam& c,
                                                 const LensArgs& l, float x,
                                                 float y, float z, float& u,
                                                 float& v) {
    const float r2 = radius2(x, y);
    if (axis(r2)) {
      Pinhole::project(c, l, x, y, z, u, v);
      return;
    }
    const float r = __fsqrt_rn(r2);
    const float theta = atan2f(r, z);
    const float d = distort(l, theta, __fmul_rn(theta, theta));
    const float ir = __frcp_rn(r);
    u = __fadd_rn(__fmul_rn(c.fx, __fmul_rn(__fmul_rn(d, x), ir)), c.cx);
    v = __fadd_rn(__fmul_rn(c.fy, __fmul_rn(__fmul_rn(d, y), ir)), c.cy);
  }

  // The terms of the closed forms at an off-axis point (`_kb4_terms`).
  struct Terms {
    float r, r2, rho2, d1, d2, s, c, dz;
  };

  __device__ __forceinline__ static Terms terms(const LensArgs& l, float r2,
                                                float z) {
    Terms t;
    t.r2 = r2;
    t.r = __fsqrt_rn(r2);
    const float theta = atan2f(t.r, z);
    const float t2 = __fmul_rn(theta, theta);
    const float d = distort(l, theta, t2);
    t.d1 = __fadd_rn(__fmul_rn(t2, horner(t2, l.d1)), 1.0f);
    t.d2 = __fmul_rn(theta, horner(t2, l.d2));
    t.rho2 = __fadd_rn(r2, __fmul_rn(z, z));
    t.s = __fdiv_rn(d, t.r);
    t.c = __fdiv_rn(
        __fsub_rn(__fdiv_rn(__fmul_rn(t.d1, z), t.rho2), t.s), r2);
    t.dz = __fdiv_rn(-t.d1, t.rho2);
    return t;
  }

  __device__ __forceinline__ static void jacobian(const Cam& c,
                                                  const LensArgs& l, float x,
                                                  float y, float z,
                                                  float (&j)[2][3]) {
    const float r2 = radius2(x, y);
    if (axis(r2)) {
      Pinhole::jacobian(c, l, x, y, z, j);
      return;
    }
    const Terms t = terms(l, r2, z);
    const float cx = __fmul_rn(t.c, x);
    const float cxy = __fmul_rn(cx, y);
    j[0][0] = __fmul_rn(c.fx, __fadd_rn(t.s, __fmul_rn(cx, x)));
    j[0][1] = __fmul_rn(c.fx, cxy);
    j[0][2] = __fmul_rn(__fmul_rn(c.fx, x), t.dz);
    j[1][0] = __fmul_rn(c.fy, cxy);
    j[1][1] =
        __fmul_rn(c.fy, __fadd_rn(t.s, __fmul_rn(__fmul_rn(t.c, y), y)));
    j[1][2] = __fmul_rn(__fmul_rn(c.fy, y), t.dz);
  }

  __device__ __forceinline__ static void jacobian_vjp(const Cam& c,
                                                      const LensArgs& l,
                                                      float x, float y,
                                                      float z,
                                                      const float (&gj)[2][3],
                                                      float (&g)[3]) {
    const float a = c.fx * gj[0][0], b = c.fx * gj[0][1];
    const float cc = c.fx * gj[0][2], d = c.fy * gj[1][0];
    const float e = c.fy * gj[1][1], f = c.fy * gj[1][2];
    const float r2 = radius2(x, y);
    if (axis(r2)) {
      const float iz = 1.0f / z;
      const float iz2 = iz * iz;
      g[0] = -cc * iz2;
      g[1] = -f * iz2;
      g[2] = -(a + e) * iz2 + 2.0f * (cc * x + f * y) * iz2 * iz;
      return;
    }
    const Terms t = terms(l, r2, z);
    const float bd = b + d;
    const float q = a * x * x + bd * x * y + e * y * y;
    const float p = cc * x + f * y;
    const float irho4 = 1.0f / (t.rho2 * t.rho2);
    const float eta = (t.d2 * z / t.r - 2.0f * t.d1) * irho4;
    const float wr = (a + e) * t.c + q * (z * eta - 3.0f * t.c) / r2 - p * eta;
    g[0] = wr * x + t.c * (2.0f * a * x + bd * y) + t.dz * cc;
    g[1] = wr * y + t.c * (bd * x + 2.0f * e * y) + t.dz * f;
    g[2] = (a + e) * t.dz - q * eta +
           p * (t.d2 * t.r + 2.0f * z * t.d1) * irho4;
  }
};

// The fisheye cull (ops/projection.py): theta = atan2(sqrt(x^2 + y^2), z)
// within the render field's half angle, in the plain version's float32
// operations.
__device__ __forceinline__ bool in_render_field(float x, float y, float z,
                                                float half_fov) {
  return atan2f(__fsqrt_rn(radius2(x, y)), z) <= half_fov;
}

// torch.clamp_min / torch.maximum / torch.clamp: NaN propagates.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// ops/sh.py sh_basis, each operation rounded as PyTorch rounds it.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = F(0.2820948);
  if (DEG >= 1) {
    const float f0a = F(0.4886025);
    b[1] = __fmul_rn(-f0a, y);
    b[2] = __fmul_rn(f0a, z);
    b[3] = __fmul_rn(-f0a, x);
  }
  if (DEG >= 2) {
    const float z2 = __fmul_rn(z, z);
    const float f0b = __fmul_rn(F(-1.0925485), z);
    const float f1a = F(0.54627424);
    const float fc1 = __fsub_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    const float fs1 = __fmul_rn(__fmul_rn(2.0f, x), y);
    b[4] = __fmul_rn(f1a, fs1);
    b[5] = __fmul_rn(f0b, y);
    b[6] = __fsub_rn(__fmul_rn(F(0.9461747), z2), F(0.31539157));
    b[7] = __fmul_rn(f0b, x);
    b[8] = __fmul_rn(f1a, fc1);
    if (DEG >= 3) {
      const float f0c = __fadd_rn(__fmul_rn(F(-2.285229), z2), F(0.4570458));
      const float f1b = __fmul_rn(F(1.4453057), z);
      const float f2a = F(-0.5900436);
      const float fc2 = __fsub_rn(__fmul_rn(x, fc1), __fmul_rn(y, fs1));
      const float fs2 = __fadd_rn(__fmul_rn(x, fs1), __fmul_rn(y, fc1));
      b[9] = __fmul_rn(f2a, fs2);
      b[10] = __fmul_rn(f1b, fs1);
      b[11] = __fmul_rn(f0c, y);
      b[12] = __fmul_rn(z, __fsub_rn(__fmul_rn(F(1.8658817), z2),
                                     F(1.119529)));
      b[13] = __fmul_rn(f0c, x);
      b[14] = __fmul_rn(f1b, fc1);
      b[15] = __fmul_rn(f2a, fc2);
      if (DEG >= 4) {
        const float p6 = b[6], p12 = b[12];
        const float f0d = __fmul_rn(
            z, __fadd_rn(__fmul_rn(F(-4.683326), z2), F(2.0071396)));
        const float f1c = __fsub_rn(__fmul_rn(F(3.3116114), z2),
                                    F(0.47308735));
        const float f2b = __fmul_rn(F(-1.7701308), z);
        const float f3a = F(0.62583575);
        const float fc3 = __fsub_rn(__fmul_rn(x, fc2), __fmul_rn(y, fs2));
        const float fs3 = __fadd_rn(__fmul_rn(x, fs2), __fmul_rn(y, fc2));
        b[16] = __fmul_rn(f3a, fs3);
        b[17] = __fmul_rn(f2b, fs2);
        b[18] = __fmul_rn(f1c, fs1);
        b[19] = __fmul_rn(f0d, y);
        b[20] = __fsub_rn(__fmul_rn(__fmul_rn(F(1.9843135), z), p12),
                          __fmul_rn(F(1.0062306), p6));
        b[21] = __fmul_rn(f0d, x);
        b[22] = __fmul_rn(f1c, fc1);
        b[23] = __fmul_rn(f2b, fc2);
        b[24] = __fmul_rn(f3a, fc3);
      }
    }
  }
}

// The unit view direction from the camera to `m`, as ops/projection.py
// forms it: (m - cam_pos) / norm, by 1 where the norm is <= 1e-12; the
// squared norm's terms added as PyTorch's CUDA reduction adds three,
// (x + z) + y.
__device__ __forceinline__ void view_dir(const float* m, const Cam& c,
                                         float* vd) {
  const float vx = __fsub_rn(m[0], c.pos[0]);
  const float vy = __fsub_rn(m[1], c.pos[1]);
  const float vz = __fsub_rn(m[2], c.pos[2]);
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vz, vz)), __fmul_rn(vy, vy)));
  const float den = norm > F(1e-12) ? norm : 1.0f;
  vd[0] = __fdiv_rn(vx, den);
  vd[1] = __fdiv_rn(vy, den);
  vd[2] = __fdiv_rn(vz, den);
}

// Copy the used SH floats of the warp's rows [row0, row0 + 32) into the
// warp's shared rows (stride ShRow::kStride), with loads that coalesce:
// where the rows hold exactly the used floats the warp's span is one
// contiguous run, read 32 consecutive floats an instruction; otherwise
// row by row.
template <int DEG>
__device__ __forceinline__ void stage_rows(const float* __restrict__ sh,
                                           int64_t k3, int64_t row0, int n,
                                           float* warp_rows, int lane) {
  using R = ShRow<DEG>;
  const int rows = n - row0 < 32 ? static_cast<int>(n - row0) : 32;
  if (k3 == R::kUsed) {
    const float* src = sh + row0 * k3;
    const int total = rows * R::kUsed;
    for (int i = lane; i < total; i += 32) {
      const int r = i / R::kUsed;
      warp_rows[r * R::kStride + (i - r * R::kUsed)] = __ldg(src + i);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const float* src = sh + (row0 + r) * k3;
      for (int c = lane; c < R::kUsed; c += 32) {
        warp_rows[r * R::kStride + c] = __ldg(src + c);
      }
    }
  }
  __syncwarp();
}

// The reverse of stage_rows for the backward's SH gradients: the warp's
// shared rows out to [row0, row0 + 32) of `out`, zeros in the k3 - used
// floats past the degree's coefficients.
template <int DEG>
__device__ __forceinline__ void unstage_rows(const float* warp_rows,
                                             int64_t k3, int64_t row0, int n,
                                             float* __restrict__ out,
                                             int lane) {
  using R = ShRow<DEG>;
  __syncwarp();
  const int rows = n - row0 < 32 ? static_cast<int>(n - row0) : 32;
  if (k3 == R::kUsed) {
    float* dst = out + row0 * k3;
    const int total = rows * R::kUsed;
    for (int i = lane; i < total; i += 32) {
      const int r = i / R::kUsed;
      dst[i] = warp_rows[r * R::kStride + (i - r * R::kUsed)];
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      float* dst = out + (row0 + r) * k3;
      for (int c = lane; c < k3; c += 32) {
        dst[c] = c < R::kUsed ? warp_rows[r * R::kStride + c] : 0.0f;
      }
    }
  }
}

}  // namespace proj

// Splat projection, backward: the gradients of the five splat arrays of a
// view through a pinhole or a KB4 fisheye lens from those of mean2d,
// conic, color and opac, one thread a splat.
//
// Replaces no TPU kernel (the JAX package differentiates its jnp
// projection through XLA; the port's PyTorch projection runs about 550
// elementwise passes under autograd). Reached through `project_backward`
// (ops/project_cuda.py), the backward of its `_Project` Function. The
// closed forms are `project_backward_plain`'s, line for line: that
// PyTorch version is this kernel's specification, held to autograd of
// `project_splats` in the CPU tests. The lens is the forward's template
// parameter (project.cuh): KB4's Jacobian takes its full 2x3 form, and
// its cotangent goes back to the point through `Kb4::jacobian_vjp`, the
// Jacobian's second derivatives.
//
// Inputs: the forward's five row arrays and view (project.cu), flags [N]
// uint8 (bit 0 visible, bit 1 + c colour channel c finite), and the
// cotangents v_mean2d [N, 2], v_conic [N, 3], v_color [N, 3], v_opac [N],
// each with its own row stride in floats (the rasterizer's backward hands
// them over as strided views of one [N, 12] array). Outputs (contiguous):
// g_means [N, 3], g_log_scales [N, 3], g_quats [N, 4], g_sh [N, K, 3]
// (zero past the degree's coefficients), g_raw_opacities [N].
//
// Bound on the H100: bytes. A visible splat's row and cotangents are read
// once (272 bytes at degree 3); every row's gradients are written (236
// bytes). Nothing of the forward is stored: the thread recomputes the
// forward's intermediates in registers, which costs fewer bytes than
// reading some thirty saved [N] arrays. A culled splat reads its flags and
// writes zeros. The SH rows and their gradients go through shared memory
// a warp at a time, as in the forward, so the loads and stores coalesce.
#include "project.cuh"

namespace {

using namespace proj;

// Gradient of sum_k w[k] * sh_basis(x, y, z)[k] w.r.t. (x, y, z): reverse
// mode through the basis's own intermediates (ops/project_cuda.py
// `_sh_basis_vjp`).
template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z,
                                             const float* w, float* g) {
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (DEG >= 1) {
    const float f0a = F(0.4886025);
    ay -= f0a * w[1];
    az += f0a * w[2];
    ax -= f0a * w[3];
  }
  if (DEG >= 2) {
    const float z2 = z * z;
    const float f0b = F(-1.0925485) * z;
    const float f1a = F(0.54627424);
    const float fc1 = x * x - y * y;
    const float fs1 = 2.0f * x * y;
    float a_fs1 = f1a * w[4];
    const float a_f0b = y * w[5] + x * w[7];
    ay += f0b * w[5];
    ax += f0b * w[7];
    float a_z2 = F(0.9461747) * w[6];
    float a_fc1 = f1a * w[8];
    if (DEG >= 3) {
      const float f0c = F(-2.285229) * z2 + F(0.4570458);
      const float f1b = F(1.4453057) * z;
      const float f2a = F(-0.5900436);
      const float fc2 = x * fc1 - y * fs1;
      const float fs2 = x * fs1 + y * fc1;
      float a_fs2 = f2a * w[9];
      const float a_f1b = fs1 * w[10] + fc1 * w[14];
      a_fs1 += f1b * w[10];
      const float a_f0c = y * w[11] + x * w[13];
      ay += f0c * w[11];
      ax += f0c * w[13];
      az += (F(1.8658817) * z2 - F(1.119529)) * w[12];
      a_z2 += F(1.8658817) * z * w[12];
      a_fc1 += f1b * w[14];
      float a_fc2 = f2a * w[15];
      if (DEG >= 4) {
        const float p12 = z * (F(1.8658817) * z2 - F(1.119529));
        const float f0d = z * (F(-4.683326) * z2 + F(2.0071396));
        const float f1c = F(3.3116114) * z2 - F(0.47308735);
        const float f2b = F(-1.7701308) * z;
        const float f3a = F(0.62583575);
        const float a_fs3 = f3a * w[16];
        const float a_f2b = fs2 * w[17] + fc2 * w[23];
        a_fs2 += f2b * w[17];
        const float a_f1c = fs1 * w[18] + fc1 * w[22];
        a_fs1 += f1c * w[18];
        const float a_f0d = y * w[19] + x * w[21];
        ay += f0d * w[19];
        ax += f0d * w[21];
        az += F(1.9843135) * p12 * w[20];
        const float a_p12 = F(1.9843135) * z * w[20];
        a_z2 -= F(1.0062306 * 0.9461747) * w[20];
        a_fc1 += f1c * w[22];
        a_fc2 += f2b * w[23];
        const float a_fc3 = f3a * w[24];
        az += (F(1.8658817) * z2 - F(1.119529)) * a_p12;
        a_z2 += F(1.8658817) * z * a_p12;
        ax += fc2 * a_fc3 + fs2 * a_fs3;
        ay += -fs2 * a_fc3 + fc2 * a_fs3;
        a_fc2 += x * a_fc3 + y * a_fs3;
        a_fs2 += -y * a_fc3 + x * a_fs3;
        az += (F(-4.683326) * z2 + F(2.0071396)) * a_f0d -
              F(1.7701308) * a_f2b;
        a_z2 += F(-4.683326) * z * a_f0d + F(3.3116114) * a_f1c;
      }
      ax += fc1 * a_fc2 + fs1 * a_fs2;
      ay += -fs1 * a_fc2 + fc1 * a_fs2;
      a_fc1 += x * a_fc2 + y * a_fs2;
      a_fs1 += -y * a_fc2 + x * a_fs2;
      a_z2 -= F(2.285229) * a_f0c;
      az += F(1.4453057) * a_f1b;
    }
    ax += 2.0f * x * a_fc1 + 2.0f * y * a_fs1;
    ay += -2.0f * y * a_fc1 + 2.0f * x * a_fs1;
    az += F(-1.0925485) * a_f0b + 2.0f * z * a_z2;
  }
  g[0] = ax;
  g[1] = ay;
  g[2] = az;
}

// sign(x) as torch.sign gives it (0 at 0).
__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

struct Grads {
  float m[3], ls[3], q[4], ro;
};

// The gradients of one visible splat; `rows` is its staged SH row, on
// return its SH gradients.
template <int DEG, bool MIP, class Lens>
__device__ __forceinline__ Grads splat_grads(const float* m, const float* ls,
                                             const float* q, float ro,
                                             int flags, const Cam& c,
                                             const LensArgs& l,
                                             const float* gk, const float* gu,
                                             const float* gcol, float gop,
                                             float* rows) {
  constexpr int kCoeffs = (DEG + 1) * (DEG + 1);
  Grads out;
  // --- the forward's intermediates ---
  float mc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mc[i] = m[0] * c.r[i][0] + m[1] * c.r[i][1] + m[2] * c.r[i][2] + c.t[i];
  }
  const float z = mc[2];
  const float iz = 1.0f / z;
  const float rx = mc[0] / z, ry = mc[1] / z;
  const bool in_x = rx >= c.lim[0] && rx <= c.lim[1];
  const bool in_y = ry >= c.lim[2] && ry <= c.lim[3];
  const float xn = clamp(rx, c.lim[0], c.lim[1]);
  const float yn = clamp(ry, c.lim[2], c.lim[3]);
  const float xc = xn * z, yc = yn * z;
  const float niz2 = -(iz * iz);
  float j[2][3];
  if constexpr (Lens::kFisheye) {
    Lens::jacobian(c, l, xc, yc, z, j);
  } else {
    j[0][0] = c.fx * iz;
    j[0][1] = 0.0f;
    j[0][2] = c.fx * xc * niz2;
    j[1][0] = 0.0f;
    j[1][1] = c.fy * iz;
    j[1][2] = c.fy * yc * niz2;
  }

  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = expf(ls[k]);
  const float qn2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const float qnorm = sqrtf(fmaxf(qn2, F(1e-32)));
  const float qw = q[0] / qnorm, qx = q[1] / qnorm, qy = q[2] / qnorm,
              qz = q[3] / qnorm;
  const float rq[3][3] = {
      {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qw * qz),
       2.0f * (qx * qz + qw * qy)},
      {2.0f * (qx * qy + qw * qz), 1.0f - 2.0f * (qx * qx + qz * qz),
       2.0f * (qy * qz - qw * qx)},
      {2.0f * (qx * qz - qw * qy), 2.0f * (qy * qz + qw * qx),
       1.0f - 2.0f * (qx * qx + qy * qy)}};
  float mm[3][3], ns[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mm[i][k] = c.r[i][0] * rq[0][k] + c.r[i][1] * rq[1][k] +
                 c.r[i][2] * rq[2][k];
      ns[i][k] = mm[i][k] * s[k];
    }
  }
  float v0[3], v1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if constexpr (Lens::kFisheye) {
      v0[k] = j[0][0] * ns[0][k] + j[0][1] * ns[1][k] + j[0][2] * ns[2][k];
      v1[k] = j[1][0] * ns[0][k] + j[1][1] * ns[1][k] + j[1][2] * ns[2][k];
    } else {
      v0[k] = j[0][0] * ns[0][k] + j[0][2] * ns[2][k];
      v1[k] = j[1][1] * ns[1][k] + j[1][2] * ns[2][k];
    }
  }
  const float c00 = v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2];
  const float c01 = v0[0] * v1[0] + v0[1] * v1[1] + v0[2] * v1[2];
  const float c11 = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2];
  const float a00 = fabsf(c00), a01 = fabsf(c01), a11 = fabsf(c11);
  const float m1 = fmaxf(a00, a11);
  const float max_abs = fmaxf(m1, a01);
  const bool clamped = max_abs > F(1.0e18);
  const float sd = clamped ? F(1.0e18) / max_abs : 1.0f;
  const float d00 = c00 * sd, d01 = c01 * sd, d11 = c11 * sd;
  const float blur = MIP ? F(0.1) : F(0.3);
  const float b00 = d00 + blur, b11 = d11 + blur;
  const float det = b00 * b11 - d01 * d01;
  const float inv_det = 1.0f / det;
  const float e = expf(-ro);
  const float sig = 1.0f / (1.0f + e);

  // --- conic and opacity ---
  const float g_inv = gk[0] * b11 - gk[1] * d01 + gk[2] * b00;
  const float g_det = -g_inv * inv_det * inv_det;
  float g_b00 = gk[2] * inv_det + g_det * b11;
  float g_b11 = gk[0] * inv_det + g_det * b00;
  float g_d01 = -gk[1] * inv_det - 2.0f * g_det * d01;
  float g_sig = gop, g_d00, g_d11;
  if (MIP) {
    const float det_raw_u = d00 * d11 - d01 * d01;
    const float det_raw = fmaxf(det_raw_u, 0.0f);
    const float det_blur = det;
    const float fc = sqrtf(det_raw / det_blur);
    g_sig = gop * fc;
    const float g_ratio = gop * sig / (2.0f * fc);
    const float g_dr = det_raw_u >= 0.0f ? g_ratio / det_blur : 0.0f;
    const float g_db = -g_ratio * det_raw / (det_blur * det_blur);
    g_b00 += g_db * b11;
    g_b11 += g_db * b00;
    g_d01 -= 2.0f * (g_db + g_dr) * d01;
    g_d00 = g_b00 + g_dr * d11;
    g_d11 = g_b11 + g_dr * d00;
  } else {
    g_d00 = g_b00;
    g_d11 = g_b11;
  }
  out.ro = g_sig * sig * sig * e;

  // --- the entry clamp (torch.maximum splits a tie evenly) ---
  float g_c00 = g_d00 * sd, g_c01 = g_d01 * sd, g_c11 = g_d11 * sd;
  if (clamped) {
    const float g_max = -(g_d00 * c00 + g_d01 * c01 + g_d11 * c11) * sd /
                        max_abs;
    const float h1 = m1 == a01 ? 0.5f : 1.0f;
    const float g_m1 = m1 >= a01 ? g_max * h1 : 0.0f;
    const float g_a01 = a01 >= m1 ? g_max * h1 : 0.0f;
    const float h0 = a00 == a11 ? 0.5f : 1.0f;
    const float g_a00 = a00 >= a11 ? g_m1 * h0 : 0.0f;
    const float g_a11 = a11 >= a00 ? g_m1 * h0 : 0.0f;
    g_c00 += g_a00 * sgn(c00);
    g_c01 += g_a01 * sgn(c01);
    g_c11 += g_a11 * sgn(c11);
  }

  // --- v = J ns, ns = (R Rq) diag(s) ---
  float g_v0[3], g_v1[3];
  float gj[2][3] = {};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_v0[k] = 2.0f * g_c00 * v0[k] + g_c01 * v1[k];
    g_v1[k] = 2.0f * g_c11 * v1[k] + g_c01 * v0[k];
    gj[0][0] += g_v0[k] * ns[0][k];
    gj[0][2] += g_v0[k] * ns[2][k];
    gj[1][1] += g_v1[k] * ns[1][k];
    gj[1][2] += g_v1[k] * ns[2][k];
    if constexpr (Lens::kFisheye) {
      gj[0][1] += g_v0[k] * ns[1][k];
      gj[1][0] += g_v1[k] * ns[0][k];
    }
  }
  float g_rq[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float g_ns[3];
    if constexpr (Lens::kFisheye) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        g_ns[i] = g_v0[k] * j[0][i] + g_v1[k] * j[1][i];
      }
    } else {
      g_ns[0] = g_v0[k] * j[0][0];
      g_ns[1] = g_v1[k] * j[1][1];
      g_ns[2] = g_v0[k] * j[0][2] + g_v1[k] * j[1][2];
    }
    out.ls[k] = (g_ns[0] * mm[0][k] + g_ns[1] * mm[1][k] +
                 g_ns[2] * mm[2][k]) * s[k];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_rq[j][k] = (c.r[0][j] * g_ns[0] + c.r[1][j] * g_ns[1] +
                    c.r[2][j] * g_ns[2]) * s[k];
    }
  }
  const float gq[4] = {
      2.0f * (-qz * g_rq[0][1] + qy * g_rq[0][2] + qz * g_rq[1][0] -
              qx * g_rq[1][2] - qy * g_rq[2][0] + qx * g_rq[2][1]),
      2.0f * (qy * g_rq[0][1] + qz * g_rq[0][2] + qy * g_rq[1][0] -
              2.0f * qx * g_rq[1][1] - qw * g_rq[1][2] + qz * g_rq[2][0] +
              qw * g_rq[2][1] - 2.0f * qx * g_rq[2][2]),
      2.0f * (-2.0f * qy * g_rq[0][0] + qx * g_rq[0][1] + qw * g_rq[0][2] +
              qx * g_rq[1][0] + qz * g_rq[1][2] - qw * g_rq[2][0] +
              qz * g_rq[2][1] - 2.0f * qy * g_rq[2][2]),
      2.0f * (-2.0f * qz * g_rq[0][0] - qw * g_rq[0][1] + qx * g_rq[0][2] +
              qw * g_rq[1][0] - 2.0f * qz * g_rq[1][1] + qy * g_rq[1][2] +
              qx * g_rq[2][0] + qy * g_rq[2][1])};
  const float qdot = qw * gq[0] + qx * gq[1] + qy * gq[2] + qz * gq[3];
  const float qn[4] = {qw, qx, qy, qz};
#pragma unroll
  for (int i = 0; i < 4; ++i) out.q[i] = (gq[i] - qn[i] * qdot) / qnorm;

  // --- the Jacobian at the clamped point, mean2d at the point ---
  float g_mc[3];
  if constexpr (Lens::kFisheye) {
    // J's cotangent to the clamped point, mean2d's through the Jacobian
    // at the point itself, and the clamp (x / z, its limits, times z).
    float g_pc[3], jm[2][3];
    Lens::jacobian_vjp(c, l, xc, yc, z, gj, g_pc);
    Lens::jacobian(c, l, mc[0], mc[1], z, jm);
    const float g_rx = in_x ? g_pc[0] * z : 0.0f;
    const float g_ry = in_y ? g_pc[1] * z : 0.0f;
    g_mc[0] = gu[0] * jm[0][0] + gu[1] * jm[1][0] + g_rx / z;
    g_mc[1] = gu[0] * jm[0][1] + gu[1] * jm[1][1] + g_ry / z;
    g_mc[2] = gu[0] * jm[0][2] + gu[1] * jm[1][2] + g_pc[2] +
              g_pc[0] * xn + g_pc[1] * yn -
              (g_rx * mc[0] + g_ry * mc[1]) / (z * z);
  } else {
    const float g_iz = gj[0][0] * c.fx + gj[1][1] * c.fy -
                       2.0f * iz * (gj[0][2] * c.fx * xc +
                                    gj[1][2] * c.fy * yc) +
                       gu[0] * c.fx * mc[0] + gu[1] * c.fy * mc[1];
    const float g_xc = gj[0][2] * c.fx * niz2, g_yc = gj[1][2] * c.fy * niz2;
    const float g_rx = in_x ? g_xc * z : 0.0f;
    const float g_ry = in_y ? g_yc * z : 0.0f;
    g_mc[0] = gu[0] * c.fx * iz + g_rx / z;
    g_mc[1] = gu[1] * c.fy * iz + g_ry / z;
    g_mc[2] = g_xc * xn + g_yc * yn - g_iz * iz * iz -
              (g_rx * mc[0] + g_ry * mc[1]) / (z * z);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out.m[j] = c.r[0][j] * g_mc[0] + c.r[1][j] * g_mc[1] +
               c.r[2][j] * g_mc[2];
  }

  // --- colour: SH along the view direction, +0.5, the clamp ---
  const float vr[3] = {m[0] - c.pos[0], m[1] - c.pos[1], m[2] - c.pos[2]};
  const float nrm = sqrtf(vr[0] * vr[0] + vr[1] * vr[1] + vr[2] * vr[2]);
  const bool big = nrm > F(1e-12);
  const float den = big ? nrm : 1.0f;
  const float vd[3] = {vr[0] / den, vr[1] / den, vr[2] / den};
  float b[kCoeffs];
  sh_basis<DEG>(vd[0], vd[1], vd[2], b);
  float g_raw[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g_raw[ch] = 0.0f;
    if (flags & (2 << ch)) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kCoeffs; ++k) acc += b[k] * rows[3 * k + ch];
      const float raw = acc + 0.5f;
      if (raw >= F(-100.0) && raw <= F(100.0)) g_raw[ch] = gcol[ch];
    }
  }
  float w[kCoeffs];
#pragma unroll
  for (int k = 0; k < kCoeffs; ++k) {
    float wk = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      // A masked channel's coefficients may be non-finite: skip them.
      if (g_raw[ch] != 0.0f) wk += rows[3 * k + ch] * g_raw[ch];
      rows[3 * k + ch] = b[k] * g_raw[ch];
    }
    w[k] = wk;
  }
  float g_vd[3];
  sh_basis_vjp<DEG>(vd[0], vd[1], vd[2], w, g_vd);
  const float vdot = vd[0] * g_vd[0] + vd[1] * g_vd[1] + vd[2] * g_vd[2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out.m[j] += big ? (g_vd[j] - vd[j] * vdot) / den : g_vd[j];
  }
  return out;
}

template <int DEG, bool MIP, class Lens>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ means,
                   const float* __restrict__ log_scales,
                   const float* __restrict__ quats,
                   const float* __restrict__ sh, int64_t k3,
                   const float* __restrict__ raw_opac,
                   const float* __restrict__ viewmat,
                   const float* __restrict__ pinhole,
                   const float* __restrict__ clamp_lim,
                   const float* __restrict__ cam_pos, LensArgs lens,
                   const uint8_t* __restrict__ flags,
                   const float* __restrict__ v_mean2d, int64_t ld_mean2d,
                   const float* __restrict__ v_conic, int64_t ld_conic,
                   const float* __restrict__ v_color, int64_t ld_color,
                   const float* __restrict__ v_opac, int64_t ld_opac, int n,
                   float* __restrict__ g_means, float* __restrict__ g_ls,
                   float* __restrict__ g_quats, float* __restrict__ g_sh,
                   float* __restrict__ g_opac) {
  using R = ShRow<DEG>;
  __shared__ float rows_s[kWarps * R::kWarpFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row0 = g - lane;
  if (row0 >= n) return;  // the whole warp is past the end
  float* my_rows = rows_s + warp * R::kWarpFloats;
  // Only a warp with a visible splat reads the SH rows; every lane stays
  // to the warp's store of the SH gradients.
  const int fl = g < n ? flags[g] : 0;
  const bool live = fl & 1;
  const bool any_live = __any_sync(0xffffffffu, live);
  if (any_live) stage_rows<DEG>(sh, k3, row0, n, my_rows, lane);
  float* my = my_rows + lane * R::kStride;
  Grads gr = {};
  if (live) {
    const Cam c = load_cam(viewmat, pinhole, clamp_lim, cam_pos);
    const float m[3] = {means[3 * g], means[3 * g + 1], means[3 * g + 2]};
    const float ls[3] = {log_scales[3 * g], log_scales[3 * g + 1],
                         log_scales[3 * g + 2]};
    const float q[4] = {quats[4 * g], quats[4 * g + 1], quats[4 * g + 2],
                        quats[4 * g + 3]};
    const float gk[3] = {v_conic[g * ld_conic], v_conic[g * ld_conic + 1],
                         v_conic[g * ld_conic + 2]};
    const float gu[2] = {v_mean2d[g * ld_mean2d],
                         v_mean2d[g * ld_mean2d + 1]};
    const float gcol[3] = {v_color[g * ld_color], v_color[g * ld_color + 1],
                           v_color[g * ld_color + 2]};
    gr = splat_grads<DEG, MIP, Lens>(m, ls, q, raw_opac[g], fl, c, lens, gk,
                                     gu, gcol, v_opac[g * ld_opac], my);
  } else {
#pragma unroll
    for (int i = 0; i < R::kUsed; ++i) my[i] = 0.0f;
  }
  unstage_rows<DEG>(my_rows, k3, row0, n, g_sh, lane);
  if (g >= n) return;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g_means[3 * g + j] = gr.m[j];
    g_ls[3 * g + j] = gr.ls[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) g_quats[4 * g + j] = gr.q[j];
  g_opac[g] = gr.ro;
}

struct Args {
  const void *means, *log_scales, *quats, *sh;
  int64_t k3;
  const void *raw_opac, *viewmat, *pinhole, *clamp_lim, *cam_pos;
  LensArgs lens;
  const void* flags;
  const void* cot[4];
  int64_t ld[4];
  int n;
  void* out[5];
  cudaStream_t stream;
};

template <int DEG, bool MIP, class Lens>
int launch(const Args& a) {
  const unsigned blocks =
      static_cast<unsigned>((a.n + kThreads - 1) / kThreads);
  project_bwd_kernel<DEG, MIP, Lens><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.means),
      static_cast<const float*>(a.log_scales),
      static_cast<const float*>(a.quats), static_cast<const float*>(a.sh),
      a.k3, static_cast<const float*>(a.raw_opac),
      static_cast<const float*>(a.viewmat),
      static_cast<const float*>(a.pinhole),
      static_cast<const float*>(a.clamp_lim),
      static_cast<const float*>(a.cam_pos), a.lens,
      static_cast<const uint8_t*>(a.flags),
      static_cast<const float*>(a.cot[0]), a.ld[0],
      static_cast<const float*>(a.cot[1]), a.ld[1],
      static_cast<const float*>(a.cot[2]), a.ld[2],
      static_cast<const float*>(a.cot[3]), a.ld[3], a.n,
      static_cast<float*>(a.out[0]), static_cast<float*>(a.out[1]),
      static_cast<float*>(a.out[2]), static_cast<float*>(a.out[3]),
      static_cast<float*>(a.out[4]));
  return brush_last_error();
}

template <bool MIP, class Lens>
int by_degree(int deg, const Args& a) {
  switch (deg) {
    case 0: return launch<0, MIP, Lens>(a);
    case 1: return launch<1, MIP, Lens>(a);
    case 2: return launch<2, MIP, Lens>(a);
    case 3: return launch<3, MIP, Lens>(a);
    case 4: return launch<4, MIP, Lens>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Lens>
int by_mip(int mip, int deg, const Args& a) {
  return mip ? by_degree<true, Lens>(deg, a) : by_degree<false, Lens>(deg, a);
}

}  // namespace

// All pointers are device pointers (layouts above); k = K, the
// coefficients a row holds; ld_* are the cotangents' row strides in floats;
// lens and k1-k4 as for brush_project_fwd.
BRUSH_EXPORT int brush_project_bwd(
    const void* means, const void* log_scales, const void* quats,
    const void* sh, int64_t k, const void* raw_opac, const void* viewmat,
    const void* pinhole, const void* clamp_lim, const void* cam_pos,
    const void* flags, const void* v_mean2d, int64_t ld_mean2d,
    const void* v_conic, int64_t ld_conic, const void* v_color,
    int64_t ld_color, const void* v_opac, int64_t ld_opac, int64_t n,
    int sh_degree, int mip, int lens, double k1, double k2, double k3,
    double k4,
    void* g_means, void* g_log_scales,
    void* g_quats, void* g_sh, void* g_opac, void* stream) {
  if (n < 0 || n > INT_MAX - proj::kThreads || sh_degree < 0 ||
      sh_degree > 4 || k < (sh_degree + 1) * (sh_degree + 1) || lens < 0 ||
      lens > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Args a{means, log_scales, quats, sh, 3 * k, raw_opac, viewmat,
               pinhole, clamp_lim, cam_pos,
               proj::lens_args(k1, k2, k3, k4, 0.0f, nullptr), flags,
               {v_mean2d, v_conic, v_color, v_opac},
               {ld_mean2d, ld_conic, ld_color, ld_opac}, static_cast<int>(n),
               {g_means, g_log_scales, g_quats, g_sh, g_opac},
               static_cast<cudaStream_t>(stream)};
  return lens == 1 ? by_mip<proj::Kb4>(mip, sh_degree, a)
                   : by_mip<proj::Pinhole>(mip, sh_degree, a);
}

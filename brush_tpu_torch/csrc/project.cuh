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

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

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

// Shared helpers of the brush_tpu_torch kernels (C interface, ctypes-bound).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define BRUSH_EXPORT extern "C" __attribute__((visibility("default")))

// Every entry point returns the launch error of its kernels as an int.
static inline int brush_last_error() {
  return static_cast<int>(cudaGetLastError());
}

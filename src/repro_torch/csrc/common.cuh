// Shared helpers for the port's CUDA kernels.  Each kernel source is built
// into its own shared library with a plain C interface (see
// repro_torch/kernels/_build.py): launchers take raw device pointers and the
// caller's stream, allocate nothing, and return the cudaError_t of the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Element-type codes shared with the Python wrappers.
enum { REPRO_F32 = 0, REPRO_F16 = 1, REPRO_BF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Streaming multiprocessors of the current device (grid sizing).
static inline int repro_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

REPRO_EXPORT const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

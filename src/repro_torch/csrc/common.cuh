// Shared helpers of the repro_torch kernel libraries.
//
// Every library exports the C entry points of its kernels plus
// repro_error_string(); an entry point checks its arguments, launches on
// the caller's stream and returns cudaGetLastError() (0 on success).
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

extern "C" __attribute__((visibility("default")))
const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bring the library's runtime onto the tensor's device (a no-op when it
// is current already) and clear any stale error before a launch.
static inline cudaError_t repro_begin(int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaGetLastError();
  return cudaSuccess;
}

static inline int repro_ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

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

// Let `kernel` take `smem` bytes of dynamic shared memory when that is
// above the 48 KB default.  The limit is a per-device attribute, so it is
// set on every such launch (a cheap host call), not once per process.
template <typename Kernel>
static inline cudaError_t repro_allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

static inline int repro_ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

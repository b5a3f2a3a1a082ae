// Shared helpers of the repro_torch kernel libraries.
//
// Every library exports the C entry points of its kernels plus
// repro_error_string(); an entry point checks its arguments, launches on
// the caller's stream and returns cudaGetLastError() (0 on success).
//
// Element types: a kernel over float operands is one template over T =
// float, __half or __nv_bfloat16, exported as <name>_f32, <name>_f16 and
// <name>_bf16.  Every variant computes in float32: an fp16 or bf16 value
// converts to float exactly on load, and a result rounds once, to nearest
// even, on store (__float2half_rn / __float2bfloat16_rn), as
// torch.Tensor.to does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// REPRO_FLOAT_TYPES(X) expands X(T, suffix) once per element type.
#define REPRO_FLOAT_TYPES(X) \
  X(float, f32)              \
  X(__half, f16)             \
  X(__nv_bfloat16, bf16)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A shared-memory pointer as the 32-bit address PTX takes.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Elements of T in 16 bytes: 4 floats, 8 halves.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
};

// 16 bytes of T at p (16-byte aligned) as Vec16<T>::N floats, and back
// (rounding each once).
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) f[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f) {
  uint4 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) e[i] = from_f32<T>(f[i]);
  *reinterpret_cast<uint4*>(p) = r;
}

// Two neighbouring outputs, one store (p aligned to two elements).
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T a, b;
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<Pair<T>*>(p) = Pair<T>{from_f32<T>(a), from_f32<T>(b)};
}

// Four neighbouring outputs, one store (p aligned to four elements).
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T x, y, z, w;
};

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  *reinterpret_cast<Quad<T>*>(p) = Quad<T>{from_f32<T>(v.x), from_f32<T>(v.y),
                                           from_f32<T>(v.z), from_f32<T>(v.w)};
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const Quad<T> q = *reinterpret_cast<const Quad<T>*>(p);
  return make_float4(to_f32(q.x), to_f32(q.y), to_f32(q.z), to_f32(q.w));
}

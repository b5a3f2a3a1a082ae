// d x d nearest-neighbour upsample of an NHWC grid (any element type):
//
//     out[n, ho, wo, c] = x[n, ho / d, wo / d, c]
//
// Replaces src/repro/kernels/mixed_res_pool/kernel.py:nn_upsample_kernel
// (_nn_upsample_kernel).  On the serving path it restores the LOW
// windows of a padded wave at beta = 0 (restore at input):
// (B * nL, 8, 8, 1024) -> (B * nL, 16, 16, 1024) at d = 2 for ViTDet-L.
//
// Bound on the H100: bytes.  It reads the input once and writes d^2 times
// as many bytes, with no arithmetic.  Design: one block per (output row,
// channel tile); each thread owns 4 consecutive channels (one 16-byte
// vector load and store, when C is a multiple of 4 and the pointers are
// aligned; one float otherwise) and walks the output row, so a warp's
// stores are contiguous and the d repeated reads of an input pixel hit
// the cache.  Pure copies: bit-exact by construction.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

// V elements a thread: one 16-byte vector (VEC) or one element
template <typename T, bool VEC>
__global__ void nn_upsample_kernel(const T* __restrict__ x,
                                   T* __restrict__ out, int H, int W, int C,
                                   int d) {
  constexpr int V = VEC ? Vec16<T>::N : 1;
  const int Ho = H * d, Wo = W * d;
  const long long orow = blockIdx.x;               // n * Ho + ho
  const long long n = orow / Ho;
  const int hi = static_cast<int>(orow % Ho) / d;
  const int c = (blockIdx.y * THREADS + threadIdx.x) * V;
  if (c >= C) return;
  const T* src = x + (n * H + hi) * static_cast<long long>(W) * C + c;
  T* dst = out + orow * static_cast<long long>(Wo) * C + c;
  for (int wo = 0; wo < Wo; ++wo) {
    const long long si = static_cast<long long>(wo / d) * C;
    const long long di = static_cast<long long>(wo) * C;
    if (VEC)
      *reinterpret_cast<uint4*>(dst + di) =
          *reinterpret_cast<const uint4*>(src + si);
    else
      dst[di] = src[si];
  }
}

template <typename T>
cudaError_t launch(const T* x, T* out, int N, int H, int W, int C, int d,
                   cudaStream_t s) {
  constexpr int V = Vec16<T>::N;
  if (d < 1 || N < 0 || H < 0 || W < 0 || C < 0) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(N) * H * d;
  if (rows == 0 || W == 0 || C == 0) return cudaSuccess;
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const dim3 grid(static_cast<unsigned>(rows),
                    repro_ceil_div(C / V, THREADS));
    nn_upsample_kernel<T, true><<<grid, THREADS, 0, s>>>(x, out, H, W, C, d);
  } else {
    const dim3 grid(static_cast<unsigned>(rows), repro_ceil_div(C, THREADS));
    nn_upsample_kernel<T, false><<<grid, THREADS, 0, s>>>(x, out, H, W, C, d);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) contiguous; out: (N, H*d, W*d, C), of one type.
#define REPRO_NN_UPSAMPLE_ENTRY(T, SUF)                                    \
  REPRO_EXPORT int nn_upsample_##SUF(const T* x, T* out, int N, int H,     \
                                     int W, int C, int d, int device,      \
                                     void* stream) {                       \
    cudaError_t e = repro_begin(device);                                   \
    if (e != cudaSuccess) return e;                                        \
    return launch<T>(x, out, N, H, W, C, d,                                \
                     static_cast<cudaStream_t>(stream));                   \
  }

REPRO_FLOAT_TYPES(REPRO_NN_UPSAMPLE_ENTRY)

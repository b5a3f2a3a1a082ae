// d x d mean pool of an NHWC float32 grid, float32 accumulation.
//
// Replaces src/repro/kernels/mixed_res_pool/kernel.py:avg_pool_kernel
// (_avg_pool_kernel).  On the serving path it pools the raw RGB frame,
// (B, 1024, 1024, 3) -> (B, 512, 512, 3) at d = 2, before the
// low-resolution patch embedding.
//
// Bound on the H100: bytes.  It reads the frame once and writes a
// quarter of it (16 MB per 1024x1024 sample at d = 2) and does one add
// per input element.  Design: one thread per output element, threads
// ordered (b, ho, wo, c) so a warp reads d runs of contiguous pixels of
// one input row and writes contiguous outputs; a grid-stride loop covers
// any size.  The d x d window is summed row by row and divided by d*d,
// as the plain version's mean does.
#include "common.cuh"

__global__ void avg_pool_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int B, int H, int W,
                                int C, int d) {
  const int Ho = H / d, Wo = W / d;
  const long long n = static_cast<long long>(B) * Ho * Wo * C;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < n; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % C);
    long long r = idx / C;
    const int wo = static_cast<int>(r % Wo);
    r /= Wo;
    const int ho = static_cast<int>(r % Ho);
    const long long b = r / Ho;
    const float* p =
        x + ((b * H + static_cast<long long>(ho) * d) * W +
             static_cast<long long>(wo) * d) * C + c;
    float s = 0.0f;
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < d; ++j)
        s += p[(static_cast<long long>(i) * W + j) * C];
    out[idx] = s / static_cast<float>(d * d);
  }
}

REPRO_EXPORT int avg_pool_f32(const float* x, float* out, int B, int H,
                              int W, int C, int d, int device,
                              void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (d < 1 || H % d || W % d) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(B) * (H / d) * (W / d) * C;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const int blocks = repro_ceil_div(n, threads) < 132 * 32
                         ? repro_ceil_div(n, threads) : 132 * 32;
  avg_pool_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, B, H, W, C, d);
  return cudaGetLastError();
}

// d x d mean pool of an NHWC float32 grid, float32 accumulation.
//
// Replaces src/repro/kernels/mixed_res_pool/kernel.py:avg_pool_kernel
// (_avg_pool_kernel).  On the serving path it pools the raw RGB frame,
// (B, 1024, 1024, 3) -> (B, 512, 512, 3) at d = 2, before the
// low-resolution patch embedding.
//
// Bound on the H100: bytes.  It reads the frame once and writes a
// quarter of it (31.5 MB for two 1024x1024 frames at d = 2, 9.4 us at
// 3.35 TB/s) and does one add per input element.  Design: one block per
// output row (b, ho), which reads its d input rows as contiguous runs of
// W * C floats (12 KB at 1024 x 3) with coalesced 16-byte cp.async copies
// into shared memory, all of them in flight at once, in chunks of P
// output pixels when a row does not fit in 48 KB.  Each output element
// sums its d x d window row by row, as the plain version's mean does, and
// divides by d * d; the outputs of the chunk go back to device memory as
// coalesced 16-byte stores.  Only the row base is 64-bit; an index is
// split into (pixel, channel) once per thread and chunk, then stepped
// without a division.  Where W * C, Wo * C or a base is not 16-byte
// aligned, the same copies and stores run 4 bytes at a time.
#include "common.cuh"
#include "tf32_mma.cuh"  // cp.async copies

namespace {

constexpr int kThreads = 256;
constexpr int kChunkFloats = 12 * 1024;   // 48 KB of shared memory

__global__ void __launch_bounds__(kThreads) avg_pool_kernel(
    const float* __restrict__ x, float* __restrict__ out, int H, int W,
    int C, int d, int P, int vec) {
  extern __shared__ float4 smem4[];
  const int Ho = H / d, Wo = W / d;
  const int row = blockIdx.x;                       // b * Ho + ho
  const int b = row / Ho, ho = row - b * Ho;
  const int WC = W * C, span = P * d * C;           // floats of a chunk row
  float* in_s = reinterpret_cast<float*>(smem4);    // d x span
  float* out_s = in_s + d * span;                   // P x C
  const float* xr = x + (static_cast<long long>(b) * H +
                         static_cast<long long>(ho) * d) * WC;
  float* orow = out + static_cast<long long>(row) * Wo * C;
  const int dp = kThreads / C, dc = kThreads % C;
  const float dd = static_cast<float>(d * d);

  for (int p0 = 0; p0 < Wo; p0 += P) {
    const int np = min(P, Wo - p0);
    const int n_in = np * d * C, n_out = np * C;
    const float* xc = xr + p0 * d * C;
    for (int i = 0; i < d; ++i) {
      if (vec) {
        for (int e = threadIdx.x; e < n_in / 4; e += kThreads)
          cp_async16_zfill(in_s + i * span + 4 * e, xc + i * WC + 4 * e,
                           true);
      } else {
        for (int e = threadIdx.x; e < n_in; e += kThreads)
          cp_async4_zfill(in_s + i * span + e, xc + i * WC + e, true);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    int p = threadIdx.x / C, c = threadIdx.x - (threadIdx.x / C) * C;
    for (int e = threadIdx.x; e < n_out; e += kThreads) {
      const float* s0 = in_s + p * d * C + c;
      float s = 0.0f;
      for (int i = 0; i < d; ++i)
        for (int j = 0; j < d; ++j) s += s0[i * span + j * C];
      out_s[e] = s / dd;
      p += dp;
      c += dc;
      if (c >= C) {
        c -= C;
        ++p;
      }
    }
    __syncthreads();
    float* oc = orow + p0 * C;
    if (vec) {
      for (int e = threadIdx.x; e < n_out / 4; e += kThreads)
        reinterpret_cast<float4*>(oc)[e] =
            reinterpret_cast<const float4*>(out_s)[e];
    } else {
      for (int e = threadIdx.x; e < n_out; e += kThreads) oc[e] = out_s[e];
    }
    __syncthreads();                  // before the next chunk's copies
  }
}

}  // namespace

REPRO_EXPORT int avg_pool_f32(const float* x, float* out, int B, int H,
                              int W, int C, int d, int device,
                              void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (d < 1 || C < 1 || H % d || W % d) return cudaErrorInvalidValue;
  const int Ho = H / d, Wo = W / d;
  if (static_cast<long long>(B) * Ho * Wo == 0) return cudaSuccess;
  if (static_cast<long long>(B) * Ho > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // 16-byte copies and stores need aligned bases and rows; a chunk of P
  // pixels (a multiple of 4) then starts on a 16-byte boundary too
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0 &&
                  (static_cast<long long>(W) * C) % 4 == 0 &&
                  (static_cast<long long>(Wo) * C) % 4 == 0;
  const long long per_pixel = static_cast<long long>(d) * d * C + C;
  long long P = kChunkFloats / per_pixel / 4 * 4;
  if (P < 4) P = 4;
  if (P > (Wo + 3) / 4 * 4) P = (Wo + 3) / 4 * 4;
  const size_t smem = static_cast<size_t>(P * per_pixel) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  e = repro_allow_smem(avg_pool_kernel, smem);
  if (e != cudaSuccess) return e;
  avg_pool_kernel<<<static_cast<int>(static_cast<long long>(B) * Ho),
                    kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, H, W, C, d, static_cast<int>(P), vec);
  return cudaGetLastError();
}

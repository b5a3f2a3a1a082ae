// d x d mean pool of an NHWC grid (float32, fp16 or bf16), float32
// accumulation.
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
//
// Element types (common.cuh): float32, fp16 and bf16, exported as
// avg_pool_{f32,f16,bf16}.  Shared memory holds the input in its own
// type (the copies move bytes, 16 at a time: 8 half elements, so a chunk
// is a multiple of 8 pixels); each output sums in float32 and rounds
// once, as the reference's mean in float32 cast back does.  Half rows
// that are not 16-byte aligned are copied an element at a time with
// plain loads (cp.async takes no 2-byte copies).
#include "common.cuh"
#include "tf32_mma.cuh"  // cp.async copies

namespace {

constexpr int kThreads = 256;
constexpr int kChunkBytes = 48 * 1024;   // shared memory of a chunk

template <typename T>
__global__ void __launch_bounds__(kThreads) avg_pool_kernel(
    const T* __restrict__ x, T* __restrict__ out, int H, int W, int C,
    int d, int P, int vec) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float4 smem4[];
  const int Ho = H / d, Wo = W / d;
  const int row = blockIdx.x;                       // b * Ho + ho
  const int b = row / Ho, ho = row - b * Ho;
  const int WC = W * C, span = P * d * C;           // elements of a chunk row
  T* in_s = reinterpret_cast<T*>(smem4);            // d x span
  T* out_s = in_s + d * span;                       // P x C
  const T* xr = x + (static_cast<long long>(b) * H +
                     static_cast<long long>(ho) * d) * WC;
  T* orow = out + static_cast<long long>(row) * Wo * C;
  const int dp = kThreads / C, dc = kThreads % C;
  const float dd = static_cast<float>(d * d);

  for (int p0 = 0; p0 < Wo; p0 += P) {
    const int np = min(P, Wo - p0);
    const int n_in = np * d * C, n_out = np * C;
    const T* xc = xr + p0 * d * C;
    for (int i = 0; i < d; ++i) {
      if (vec) {
        for (int e = threadIdx.x; e < n_in / V; e += kThreads)
          cp_async16_zfill(reinterpret_cast<float*>(in_s + i * span + V * e),
                           reinterpret_cast<const float*>(xc + i * WC + V * e),
                           true);
      } else if constexpr (sizeof(T) == 4) {
        for (int e = threadIdx.x; e < n_in; e += kThreads)
          cp_async4_zfill(reinterpret_cast<float*>(in_s + i * span + e),
                          reinterpret_cast<const float*>(xc + i * WC + e),
                          true);
      } else {
        for (int e = threadIdx.x; e < n_in; e += kThreads)
          in_s[i * span + e] = xc[i * WC + e];
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    int p = threadIdx.x / C, c = threadIdx.x - (threadIdx.x / C) * C;
    for (int e = threadIdx.x; e < n_out; e += kThreads) {
      const T* s0 = in_s + p * d * C + c;
      float s = 0.0f;
      for (int i = 0; i < d; ++i)
        for (int j = 0; j < d; ++j) s += to_f32(s0[i * span + j * C]);
      out_s[e] = from_f32<T>(s / dd);
      p += dp;
      c += dc;
      if (c >= C) {
        c -= C;
        ++p;
      }
    }
    __syncthreads();
    T* oc = orow + p0 * C;
    if (vec) {
      for (int e = threadIdx.x; e < n_out / V; e += kThreads)
        reinterpret_cast<uint4*>(oc)[e] =
            reinterpret_cast<const uint4*>(out_s)[e];
    } else {
      for (int e = threadIdx.x; e < n_out; e += kThreads) oc[e] = out_s[e];
    }
    __syncthreads();                  // before the next chunk's copies
  }
}

template <typename T>
cudaError_t launch(const T* x, T* out, int B, int H, int W, int C, int d,
                   cudaStream_t stream) {
  constexpr int V = Vec16<T>::N;
  if (d < 1 || C < 1 || H % d || W % d) return cudaErrorInvalidValue;
  const int Ho = H / d, Wo = W / d;
  if (static_cast<long long>(B) * Ho * Wo == 0) return cudaSuccess;
  if (static_cast<long long>(B) * Ho > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // 16-byte copies and stores need aligned bases and rows; a chunk of P
  // pixels (a multiple of V) then starts on a 16-byte boundary too
  const int vec = reinterpret_cast<size_t>(x) % 16 == 0 &&
                  reinterpret_cast<size_t>(out) % 16 == 0 &&
                  (static_cast<long long>(W) * C) % V == 0 &&
                  (static_cast<long long>(Wo) * C) % V == 0;
  const long long per_pixel = static_cast<long long>(d) * d * C + C;
  long long P = kChunkBytes / static_cast<long long>(sizeof(T)) / per_pixel /
                V * V;
  if (P < V) P = V;
  if (P > (Wo + V - 1) / V * V) P = (Wo + V - 1) / V * V;
  const size_t smem = static_cast<size_t>(P * per_pixel) * sizeof(T);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t e = repro_allow_smem(avg_pool_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  avg_pool_kernel<T><<<static_cast<int>(static_cast<long long>(B) * Ho),
                       kThreads, smem, stream>>>(
      x, out, H, W, C, d, static_cast<int>(P), vec);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_AVG_POOL_ENTRY(T, SUF)                                     \
  REPRO_EXPORT int avg_pool_##SUF(const T* x, T* out, int B, int H,      \
                                  int W, int C, int d, int device,       \
                                  void* stream) {                        \
    cudaError_t e = repro_begin(device);                                 \
    if (e != cudaSuccess) return e;                                      \
    return launch<T>(x, out, B, H, W, C, d,                              \
                     static_cast<cudaStream_t>(stream));                 \
  }

REPRO_FLOAT_TYPES(REPRO_AVG_POOL_ENTRY)

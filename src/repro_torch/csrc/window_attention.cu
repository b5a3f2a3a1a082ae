// Non-overlapping window attention over a window-blocked sequence.
//
// Replaces src/repro/kernels/window_attention/kernel.py:
// window_attention_kernel (_window_attend, and _window_kernel_flagged for
// the per-window valid flag).  q: (B, T, H, Dh), k/v: (B, T, KV, Dh),
// T = W * w2; every run of w2 tokens attends only to itself, softmax in
// float32, query head h reads kv head h / (H / KV).  Windows at or past
// win_valid[b] (the pad windows of a length-bucketed sequence) write
// zeros and skip the arithmetic.  At ViTDet-L width w2 = 64, Dh = 64,
// H = 16, T in {1536, 3072, 4096}.
//
// Bound on the H100: operations, ~4 * w2 * Dh flops per token and head
// (1.07 GFLOP per full-resolution layer) against 67 TFLOP/s of float32
// FMA; the bytes (q, k, v read once, out written once: 64 MB per
// full-resolution layer) take about as long at 3.35 TB/s.  Tensor cores
// in TF32 would lose the float32 parity, so this version uses FMA.
// Design: one block per (window, head); q, k and v of the window (48 KB
// at w2 = Dh = 64) and the w2 x w2 scores (16 KB) live in dynamic shared
// memory (above the 48 KB static limit, so the entry point opts in);
// rows of q and k are padded by one float so that threads walking
// different rows hit different banks.  Scores: one thread per (i, j);
// softmax: one warp per row; output: one thread per (i, d).
#include <math.h>

#include "common.cuh"

__global__ void window_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ win_valid,
    float* __restrict__ out, int W, int w2, int H, int KV, int Dh,
    long long sqb, long long sqt, long long skb, long long skt,
    long long svb, long long svt, float scale) {
  const int bw = blockIdx.x, h = blockIdx.y;
  const int b = bw / W, w = bw % W;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long t0 = static_cast<long long>(w) * w2;
  float* ob = out + (static_cast<long long>(b) * W * w2 + t0) * H * Dh +
              static_cast<long long>(h) * Dh;
  const long long sot = static_cast<long long>(H) * Dh;

  if (win_valid != nullptr && w >= win_valid[b]) {
    for (int idx = tid; idx < w2 * Dh; idx += nt)
      ob[(idx / Dh) * sot + idx % Dh] = 0.0f;
    return;
  }

  extern __shared__ float sm[];
  const int ld = Dh + 1, lds = w2 + 1;
  float* Qs = sm;                 // w2 x ld
  float* Ks = Qs + w2 * ld;       // w2 x ld
  float* Vs = Ks + w2 * ld;       // w2 x Dh
  float* Ss = Vs + w2 * Dh;       // w2 x lds

  const float* qb = q + b * sqb + t0 * sqt + static_cast<long long>(h) * Dh;
  const float* kb = k + b * skb + t0 * skt + static_cast<long long>(kvh) * Dh;
  const float* vb = v + b * svb + t0 * svt + static_cast<long long>(kvh) * Dh;
  for (int idx = tid; idx < w2 * Dh; idx += nt) {
    const int i = idx / Dh, d = idx % Dh;
    Qs[i * ld + d] = qb[i * sqt + d];
    Ks[i * ld + d] = kb[i * skt + d];
    Vs[i * Dh + d] = vb[i * svt + d];
  }
  __syncthreads();

  for (int idx = tid; idx < w2 * w2; idx += nt) {
    const int i = idx / w2, j = idx % w2;
    float s = 0.0f;
    for (int d = 0; d < Dh; ++d) s = fmaf(Qs[i * ld + d], Ks[j * ld + d], s);
    Ss[i * lds + j] = s * scale;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  for (int i = warp; i < w2; i += nwarps) {
    float* row = Ss + i * lds;
    float m = -INFINITY;
    for (int j = lane; j < w2; j += 32) m = fmaxf(m, row[j]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.0f;
    for (int j = lane; j < w2; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < w2; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = tid; idx < w2 * Dh; idx += nt) {
    const int i = idx / Dh, d = idx % Dh;
    float o = 0.0f;
    for (int j = 0; j < w2; ++j) o = fmaf(Ss[i * lds + j], Vs[j * Dh + d], o);
    ob[i * sot + d] = o;
  }
}

static size_t smem_bytes(int w2, int Dh) {
  return sizeof(float) * (static_cast<size_t>(w2) * (Dh + 1) * 2 +
                          static_cast<size_t>(w2) * Dh +
                          static_cast<size_t>(w2) * (w2 + 1));
}

REPRO_EXPORT long long window_attention_smem_bytes(int w2, int Dh) {
  return static_cast<long long>(smem_bytes(w2, Dh));
}

REPRO_EXPORT int window_attention_f32(
    const float* q, const float* k, const float* v, const int* win_valid,
    float* out, int B, int W, int w2, int H, int KV, int Dh, long long sqb,
    long long sqt, long long skb, long long skt, long long svb,
    long long svt, float scale, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  if (B == 0 || W == 0) return cudaSuccess;
  const size_t smem = smem_bytes(w2, Dh);
  e = repro_allow_smem(window_attention_kernel, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * W, H);
  window_attention_kernel<<<grid, 256, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, k, v, win_valid, out, W, w2, H, KV, Dh, sqb, sqt, skb, skt, svb,
      svt, scale);
  return cudaGetLastError();
}

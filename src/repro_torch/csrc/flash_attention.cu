// Flash attention: online-softmax attention over kv tiles, float32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
// flash_attention_kernel (_flash_kernel).  q: (B, T, H, Dh), k/v:
// (B, S, KV, Dh); query head h reads kv head h / (H / KV); optional
// causal mask (query t sees keys s <= t); a row that no key reaches
// writes 0.  On the serving path it runs the unmasked global blocks after
// the restoration point: (B, 4096, 16, 64), not causal.
//
// Bound on the H100: operations, 4 * T * S * Dh flops per head (68.7
// GFLOP per 4096-token sample at 16 heads) against 67 TFLOP/s of float32
// FMA.  TF32 tensor cores would break float32 parity with the reference,
// so this version stays on FMA.  Design: one block of 256 threads per
// (64-query tile, head, batch row); the TPU's sequential kv grid axis
// becomes a loop over 64-key tiles inside the block, with the running
// max, sum and output accumulator in registers.  Thread (ty, tx) of a
// 16 x 16 layout owns query rows 4*ty .. 4*ty+3, score columns tx + 16c
// and output columns tx + 16c: each shared-memory read of q or k feeds
// four FMAs, row statistics reduce over the 16 lanes of a half warp with
// shuffles, and probabilities pass through shared memory to the P @ V
// product.  Rows of q, k and P are padded by one float against bank
// conflicts; about 66 KB of dynamic shared memory at Dh = 64.
#include <math.h>

#include "common.cuh"

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int T, int S,
    int H, int KV, long long sqb, long long sqt, long long skb,
    long long skt, long long svb, long long svt, float scale, int causal) {
  constexpr int LD = DH + 1, LDP = kBK + 1, NC = DH / 16;
  extern __shared__ float sm[];
  float* Qs = sm;               // kBQ x LD
  float* Ks = Qs + kBQ * LD;    // kBK x LD
  float* Vs = Ks + kBK * LD;    // kBK x DH
  float* Ps = Vs + kBK * DH;    // kBQ x LDP

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qb = q + b * sqb + static_cast<long long>(h) * DH;
  const float* kb = k + b * skb + static_cast<long long>(kvh) * DH;
  const float* vb = v + b * svb + static_cast<long long>(kvh) * DH;

  for (int idx = tid; idx < kBQ * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    Qs[r * LD + d] = q0 + r < T ? qb[(q0 + r) * sqt + d] : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) {  // tiles wholly above the diagonal contribute nothing
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_kt = last < n_kt ? last : n_kt;
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH, d = idx % DH;
      const bool in = k0 + r < S;
      Ks[r * LD + d] = in ? kb[(k0 + r) * skt + d] : 0.0f;
      Vs[r * DH + d] = in ? vb[(k0 + r) * svt + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool ok = kj < S && (!causal || kj <= qi);
        s[i][c] = ok ? s[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // m_new == -inf: no key reached this row yet; keep everything at 0
      const float alpha = m_new == -INFINITY ? 1.0f : expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[i][c] == -INFINITY ? 0.0f : expf(s[i][c] - m_new);
        Ps[(ty * 4 + i) * LDP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  const long long sot = static_cast<long long>(H) * DH;
  float* ob = out + static_cast<long long>(b) * T * sot +
              static_cast<long long>(h) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= T) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[qi * sot + tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int DH>
static cudaError_t launch(const float* q, const float* k, const float* v,
                          float* out, int B, int T, int S, int H, int KV,
                          long long sqb, long long sqt, long long skb,
                          long long skt, long long svb, long long svt,
                          float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBQ) * (DH + 1) +
                                       static_cast<size_t>(kBK) * (DH + 1) +
                                       static_cast<size_t>(kBK) * DH +
                                       static_cast<size_t>(kBQ) * (kBK + 1));
  cudaError_t e = repro_allow_smem(flash_attention_kernel<DH>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<DH><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, T, S, H, KV, sqb, sqt, skb, skt, svb, svt, scale,
      causal);
  return cudaGetLastError();
}

REPRO_EXPORT int flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int B,
    int T, int S, int H, int KV, int Dh, long long sqb, long long sqt,
    long long skb, long long skt, long long svb, long long svt, float scale,
    int causal, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch<16>(q, k, v, out, B, T, S, H, KV, sqb, sqt, skb,
                               skt, svb, svt, scale, causal, st);
    case 32: return launch<32>(q, k, v, out, B, T, S, H, KV, sqb, sqt, skb,
                               skt, svb, svt, scale, causal, st);
    case 64: return launch<64>(q, k, v, out, B, T, S, H, KV, sqb, sqt, skb,
                               skt, svb, svt, scale, causal, st);
    case 128: return launch<128>(q, k, v, out, B, T, S, H, KV, sqb, sqt, skb,
                                 skt, svb, svt, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

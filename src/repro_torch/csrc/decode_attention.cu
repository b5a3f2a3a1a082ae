// One-token GQA decode attention against a KV cache, float32.
//
// Replaces src/repro/kernels/decode_attention/kernel.py:
// decode_attention_kernel (_decode_kernel).  q: (B, 1, H, Dh); k/v:
// (B, S, KV, Dh), read in place through their batch and token strides
// (the reference's ops.py transposes the whole cache to (B, KV, S, Dh)
// on every step; here nothing is copied); kv_len: (B,) int32.  Query
// head h reads kv head h / G (G = H / KV); keys s < kv_len[b] are
// attended with scale * q.k logits; keys past kv_len[b] are never read,
// and a row with kv_len[b] == 0 writes zeros, as the Pallas kernel does.
// On the serving path (Qwen3-4B) it runs once per layer per decode step:
// q (8, 1, 32, 128) against (8, max_len, 8, 128) caches.
//
// Bound on the H100: bytes.  The K and V rows below kv_len are streamed
// once, B * kv_len * KV * Dh * 8 bytes, at about one flop per byte.
// Design, simple first: one block of 4 warps per (split of the keys,
// group of up to 8 query heads of one kv head, batch row), so the G
// query heads of a kv head share every cache read.  A lane holds a
// 16-byte slice of each query row; Dh / 4 lanes cover one key row, so a
// warp reads whole 512-byte rows at Dh = 128 (several rows at smaller
// Dh).  Each lane group walks its keys four rows at a time (eight loads
// in flight), reduces the dot products over the group with shuffles,
// and keeps a running max, sum and output slice per query row (online
// softmax, plain float32 FMA: TF32 would break parity).  The groups of
// a warp, then the warps of the block, merge their partial softmaxes;
// with one split the block writes the output, otherwise it writes its
// partial (max, sum, output) and a second kernel merges the splits.  The
// wrapper picks the split count so that a long cache puts about four
// blocks on every SM, and one split when the cache is short.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps, kMaxG = 8, kUnroll = 4;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// Merge partial softmax (m2, l2, a2) into (m, l, a): both scaled to the
// larger max.  A part with no key yet has m == -inf and contributes 0.
__device__ __forceinline__ void merge(float& m, float& l, float4& a,
                                      float m2, float l2, float4 a2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  const float c1 = m == -INFINITY ? 0.0f : expf(m - mx);
  const float c2 = m2 == -INFINITY ? 0.0f : expf(m2 - mx);
  l = l * c1 + l2 * c2;
  a.x = a.x * c1 + a2.x * c2;
  a.y = a.y * c1 + a2.y * c2;
  a.z = a.z * c1 + a2.z * c2;
  a.w = a.w * c1 + a2.w * c2;
  m = mx;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ kv_len,
    float* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int S, int H,
    int KV, int keys_per_split, long long sqb, long long skb, long long skt,
    long long svb, long long svt, float scale) {
  constexpr int LPK = DH / 4;      // lanes per key row, 4 floats each
  constexpr int KPW = 32 / LPK;    // key rows a warp covers per load
  constexpr int TILE = KPW * kUnroll;
  __shared__ float sm_m[kWarps][kMaxG], sm_l[kWarps][kMaxG];
  __shared__ float4 sm_acc[kWarps][kMaxG][LPK];

  const int G = H / KV, n_gc = (G + kMaxG - 1) / kMaxG;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_gc, g0 = (blockIdx.y % n_gc) * kMaxG;
  const int ng = min(kMaxG, G - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, col = (lane % LPK) * 4;
  const int len = min(max(kv_len[b], 0), S);
  const int s0 = split * keys_per_split;
  const int s1 = min(s0 + keys_per_split, len);

  float4 qv[kMaxG];
  const float* qb = q + b * sqb + static_cast<long long>(kvh * G + g0) * DH
                    + col;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < ng) t = *reinterpret_cast<const float4*>(qb + g * DH);
    qv[g] = make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale);
  }
  float m[kMaxG], l[kMaxG];
  float4 acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const float* kb = k + b * skb + static_cast<long long>(kvh) * DH + col;
  const float* vb = v + b * svb + static_cast<long long>(kvh) * DH + col;
  for (int t0 = s0 + warp * TILE; t0 < s1; t0 += kWarps * TILE) {
    float4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = t0 + u * KPW + sub;
      ok[u] = j < s1;
      kr[u] = ok[u] ? *reinterpret_cast<const float4*>(kb + j * skt)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = ok[u] ? *reinterpret_cast<const float4*>(vb + j * svt)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= ng) break;
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = dot4(qv[g], kr[u]);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      }
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u]);
      if (mx > -INFINITY) {                 // some key of this group seen
        const float alpha = expf(m[g] - mx);  // 0 while m[g] is -inf
        float4 a = acc[g];
        float lsum = l[g] * alpha;
        a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float p = ok[u] ? expf(s[u] - mx) : 0.0f;
          lsum += p;
          a.x = fmaf(p, vr[u].x, a.x);
          a.y = fmaf(p, vr[u].y, a.y);
          a.z = fmaf(p, vr[u].z, a.z);
          a.w = fmaf(p, vr[u].w, a.w);
        }
        acc[g] = a;
        l[g] = lsum;
        m[g] = mx;
      }
    }
  }

  // merge the KPW lane groups of the warp, then the warps of the block
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      float4 a2;
      a2.x = __shfl_xor_sync(0xffffffffu, acc[g].x, off);
      a2.y = __shfl_xor_sync(0xffffffffu, acc[g].y, off);
      a2.z = __shfl_xor_sync(0xffffffffu, acc[g].z, off);
      a2.w = __shfl_xor_sync(0xffffffffu, acc[g].w, off);
      merge(m[g], l[g], acc[g], m2, l2, a2);
    }
    if (sub == 0) {
      sm_acc[warp][g][lane] = acc[g];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  const int H0 = kvh * G + g0;
  for (int idx = threadIdx.x; idx < ng * LPK; idx += kThreads) {
    const int g = idx / LPK, c = idx % LPK;
    float mm = -INFINITY, ll = 0.0f;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      merge(mm, ll, aa, sm_m[w][g], sm_l[w][g], sm_acc[w][g][c]);
    const long long row = static_cast<long long>(b) * H + H0 + g;
    if (part_acc == nullptr) {             // one split: the final output
      const float inv = ll > 0.0f ? 1.0f / ll : 0.0f;
      reinterpret_cast<float4*>(out + row * DH)[c] =
          make_float4(aa.x * inv, aa.y * inv, aa.z * inv, aa.w * inv);
    } else {
      const long long prow = row * gridDim.x + split;
      reinterpret_cast<float4*>(part_acc + prow * DH)[c] = aa;
      if (c == 0) {
        part_m[prow] = mm;
        part_l[prow] = ll;
      }
    }
  }
}

// Merge the n_split partial softmaxes of every (batch row, query head):
// one block per row, one thread per output feature.
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      float* __restrict__ out, int n_split,
                                      int Dh) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * n_split;
  const float* pl = part_l + row * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  float l = 0.0f, a = 0.0f;
  if (mx != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      if (pm[s] == -INFINITY) continue;
      const float c = expf(pm[s] - mx);
      l = fmaf(pl[s], c, l);
      a = fmaf(part_acc[(row * n_split + s) * Dh + d], c, a);
    }
  }
  out[row * Dh + d] = l > 0.0f ? a / l : 0.0f;
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* kv_len, float* out, float* part_m,
                   float* part_l, float* part_acc, int B, int S, int H,
                   int KV, int n_split, long long sqb, long long skb,
                   long long skt, long long svb, long long svt, float scale,
                   cudaStream_t stream) {
  const int G = H / KV, n_gc = (G + kMaxG - 1) / kMaxG;
  const int keys_per_split = repro_ceil_div(S, n_split);
  dim3 grid(n_split, KV * n_gc, B);
  decode_split_kernel<DH><<<grid, kThreads, 0, stream>>>(
      q, k, v, kv_len, out, n_split > 1 ? part_m : nullptr,
      n_split > 1 ? part_l : nullptr, n_split > 1 ? part_acc : nullptr, S,
      H, KV, keys_per_split, sqb, skb, skt, svb, svt, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  decode_combine_kernel<<<B * H, DH, 0, stream>>>(part_m, part_l, part_acc,
                                                  out, n_split, DH);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, 1, H, Dh) with dense heads (q's batch stride sqb); k/v:
// (B, S, KV, Dh) with dense heads, batch and token strides given;
// part_*: n_split > 1 scratch of B * H * n_split (* Dh) floats.  Every
// pointer and stride must allow 16-byte loads (the wrapper checks).
REPRO_EXPORT int decode_attention_f32(
    const float* q, const float* k, const float* v, const int* kv_len,
    float* out, float* part_m, float* part_l, float* part_acc, int B,
    int S, int H, int KV, int Dh, int n_split, long long sqb, long long skb,
    long long skt, long long svb, long long svt, float scale, int device,
    void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV || n_split < 1 || (n_split > 1 && !part_acc))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch<16>(q, k, v, kv_len, out, part_m, part_l,
                               part_acc, B, S, H, KV, n_split, sqb, skb, skt,
                               svb, svt, scale, st);
    case 32: return launch<32>(q, k, v, kv_len, out, part_m, part_l,
                               part_acc, B, S, H, KV, n_split, sqb, skb, skt,
                               svb, svt, scale, st);
    case 64: return launch<64>(q, k, v, kv_len, out, part_m, part_l,
                               part_acc, B, S, H, KV, n_split, sqb, skb, skt,
                               svb, svt, scale, st);
    case 128: return launch<128>(q, k, v, kv_len, out, part_m, part_l,
                                 part_acc, B, S, H, KV, n_split, sqb, skb,
                                 skt, svb, svt, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

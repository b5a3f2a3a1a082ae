// Non-overlapping window attention over a window-blocked sequence.
//
// Replaces src/repro/kernels/window_attention/kernel.py:
// window_attention_kernel (_window_attend, and _window_kernel_flagged for
// the per-window valid flag).  q: (B, T, H, Dh), k/v: (B, T, KV, Dh),
// T = W * w2; every run of w2 tokens attends only to itself, softmax in
// float32, query head h reads kv head h / (H / KV).  Windows at or past
// win_valid[b] (the pad windows of a length-bucketed sequence) write
// zeros and skip the arithmetic.  At ViTDet-L width w2 = 64, Dh = 64,
// H = 16 (15 in the int8 lane), T in {1536, 3072, 4096}; q, k and v are
// column views of the fused QKV product (token pitch 3072 or 2880).
//
// Bound on the H100: bytes.  q, k, v read once and out written once are
// 16 B per token, head and feature (134 MB per full-resolution layer of a
// wave of two, 40 us at 3.35 TB/s), against 4 * w2 * Dh flops per token
// and head (2.15 GFLOP, 32 us on the float32 FMA units, 4.3 us at the
// TF32 tensor-core rate).  A scalar FMA kernel sits at the FMA bound or
// above it, with shared-memory loads beside every FMA; the tensor cores
// take the arithmetic off the critical path, if they keep float32
// accuracy.
//
// Design: mma.sync m16n8k8 TF32 tensor-core tiles in the 3xTF32 scheme
// (the helpers are shared with the other float32 kernels, tf32_mma.cuh).
// Each operand x splits into x_hi (x with its low 13 mantissa bits
// cleared, a TF32 value) and x_lo = x - x_hi, of which the tensor core
// reads the top 11 significant bits; a product keeps three terms,
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, in a float32 accumulator.  The
// dropped a_lo*b_lo and the bits of x_lo the tensor core ignores leave
// at most ~2^-19 of each product, near float32, where one TF32 product
// (2^-11) breaks the 1e-4 parity.  The split is an AND and a subtraction; two
// cvt.rna roundings (round to nearest, 2^-22) cost more ALU time than the
// tensor cores save, for no accuracy the parity needs.
//  - A block owns one (window, head): w2 rounded up to a multiple of 16
//    query rows, 16 per warp (4 warps at w2 = 64).  The blocks of one
//    window are its heads, launched side by side, so the blocks in flight
//    read whole token rows of the fused QKV product.  q, k and v of the
//    window are staged with 16-byte cp.async copies into shared rows of
//    Dh + 4 floats, so the fragment loads of a warp hit 32 distinct banks.
//    52 KB of shared memory and 128 threads a block: four blocks (16
//    warps) an SM, one block's copies overlapping the others' arithmetic.
//  - S = Q K^T (16 x w2 per warp) stays in registers; the row softmax runs
//    there, the row max and sum over the four threads of a row by quad
//    shuffles.  Pad keys (w2 not a multiple of 16) score -inf; pad rows of
//    q, k and v are zero and pad query rows are not stored.
//  - O = P V reuses the score accumulators as the A operand without a
//    trip through shared memory: a thread's accumulator holds columns
//    2t, 2t + 1 of each 8-key tile and the A fragment wants k = t, t + 4,
//    so each 8-key tile's keys are relabelled (k slot t <-> key 2t, slot
//    t + 4 <-> key 2t + 1) and v's B fragment is read with the same
//    relabelling; a sum over keys does not depend on their order.  The
//    rows are divided by the softmax sum at the end and stored as float2.
// Dh must be a multiple of 8 and at most 128, w2 at most 128.
//
// Element types (common.cuh): q, k, v and out all float32, fp16 or bf16,
// exported as window_attention_{f32,f16,bf16}.  Half rows convert to
// float while they are staged (plain 16-byte loads of 8 elements, then
// float stores into the same shared rows), so shared memory, the
// fragments and the softmax are float32 at every type, as the
// reference's kernel casts q, k and v to float32 on load.  A half value
// is an exact TF32 value: its split leaves lo = 0, and the products are
// those of float32 (the zero lo products are kept; dropping them is
// speed work).  The output rounds once to the input type.
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

// Stage rows [0, w2) of a (w2, Dh) slab with token pitch `st` into shared
// rows of `ld` floats.
template <typename T>
__device__ __forceinline__ void stage(float* s, const T* g, long long st,
                                      int w2, int Dh, int ld, bool vec) {
  if constexpr (sizeof(T) != 4) {   // fp16 / bf16: convert while staging
    if (vec) {
      const int cpr = Dh / 8;
      for (int idx = threadIdx.x; idx < w2 * cpr; idx += blockDim.x) {
        const int i = idx / cpr, c = (idx % cpr) * 8;
        float f[8];
        load16(g + i * st + c, f);
        float4* d = reinterpret_cast<float4*>(s + i * ld + c);
        d[0] = make_float4(f[0], f[1], f[2], f[3]);
        d[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    } else {
      for (int idx = threadIdx.x; idx < w2 * Dh; idx += blockDim.x) {
        const int i = idx / Dh, c = idx % Dh;
        s[i * ld + c] = to_f32(g[i * st + c]);
      }
    }
  } else if (vec) {
    const int cpr = Dh / 4;
    for (int idx = threadIdx.x; idx < w2 * cpr; idx += blockDim.x) {
      const int i = idx / cpr, c = (idx % cpr) * 4;
      cp_async16_zfill(s + i * ld + c, g + i * st + c, true);
    }
  } else {
    for (int idx = threadIdx.x; idx < w2 * Dh; idx += blockDim.x) {
      const int i = idx / Dh, c = idx % Dh;
      cp_async4_zfill(s + i * ld + c, g + i * st + c, true);
    }
  }
}

// The arguments every (window, head) of a call shares.
template <typename T>
struct Args {
  const T *q, *k, *v;
  const int* win_valid;
  T* out;
  int W, w2, H, KV, Dh;
  long long sqb, sqt, skb, skt, svb, svt;
  float scale;
  bool vec;
};

// Item `it` of the call is window bw = it / H (of the B * W), head it % H.
template <typename T>
__device__ __forceinline__ bool item_valid(const Args<T>& a, int it) {
  const int bw = it / a.H;
  return a.win_valid == nullptr || bw % a.W < a.win_valid[bw / a.W];
}

// Start the cp.async copies of item `it`'s q, k and v rows into `buf`.
template <typename T>
__device__ __forceinline__ void load_item(const Args<T>& a, int it, float* buf,
                                          int w2p, int ld) {
  const int bw = it / a.H, h = it % a.H;
  const int b = bw / a.W;
  const long long t0 = static_cast<long long>(bw % a.W) * a.w2;
  const int kvh = h / (a.H / a.KV);
  stage(buf, a.q + b * a.sqb + t0 * a.sqt + static_cast<long long>(h) * a.Dh,
        a.sqt, a.w2, a.Dh, ld, a.vec);
  stage(buf + w2p * ld,
        a.k + b * a.skb + t0 * a.skt + static_cast<long long>(kvh) * a.Dh,
        a.skt, a.w2, a.Dh, ld, a.vec);
  stage(buf + 2 * w2p * ld,
        a.v + b * a.svb + t0 * a.svt + static_cast<long long>(kvh) * a.Dh,
        a.svt, a.w2, a.Dh, ld, a.vec);
}

// Item `it` from its staged rows in `buf` (or zeros for a pad window).
template <int NT, int ND, typename T>
__device__ __forceinline__ void attend(const Args<T>& a, int it,
                                       const float* buf, int w2p, int ld) {
  const int bw = it / a.H, h = it % a.H;
  const int w2 = a.w2, Dh = a.Dh;
  const long long sot = static_cast<long long>(a.H) * Dh;
  T* ob = a.out + static_cast<long long>(bw) * w2 * sot +
              static_cast<long long>(h) * Dh;
  if (!item_valid(a, it)) {
    for (int idx = threadIdx.x; idx < w2 * Dh; idx += blockDim.x)
      ob[(idx / Dh) * sot + idx % Dh] = from_f32<T>(0.0f);
    return;
  }
  const int nt = w2p / 8, nd = Dh / 8;
  const float* Ks = buf + w2p * ld;
  const float* Vs = Ks + w2p * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* qw = buf + (16 * warp + g) * ld + t;

  // S = Q K^T: fragment (j, e) is row g (+8 for e >= 2), key 8j + 2t + (e&1)
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < ND; ++kk) {
    if (kk >= nd) break;
    const float af[4] = {qw[8 * kk], qw[8 * kk + 8 * ld], qw[8 * kk + 4],
                         qw[8 * kk + 8 * ld + 4]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      const float* kp = Ks + (8 * j + g) * ld + 8 * kk + t;
      const float bf[2] = {kp[0], kp[4]};
      mma_3xtf32(s[j], af, bf);
    }
  }

  // row softmax in registers; rows g and g + 8 of the warp's 16
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = 8 * j + 2 * t + e < w2;
      s[j][e] = key ? s[j][e] * a.scale : -INFINITY;
      s[j][2 + e] = key ? s[j][2 + e] * a.scale : -INFINITY;
      m0 = fmaxf(m0, s[j][e]);
      m1 = fmaxf(m1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - m0);
      s[j][2 + e] = expf(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // O = P V, keys of tile j relabelled: k slot t <-> key 8j + 2t, slot
  // t + 4 <-> key 8j + 2t + 1
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
    const float af[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
    const float* vp = Vs + (8 * j + 2 * t) * ld + g;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (n >= nd) break;
      const float bf[2] = {vp[8 * n], vp[8 * n + ld]};
      mma_3xtf32(o[n], af, bf);
    }
  }

  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (n >= nd) break;
    const int c = 8 * n + 2 * t;
    if (r0 < w2) store2(ob + r0 * sot + c, o[n][0] * i0, o[n][1] * i0);
    if (r1 < w2) store2(ob + r1 * sot + c, o[n][2] * i1, o[n][3] * i1);
  }
}

// NT: most 8-key tiles (w2 rounded up to 16, over 8); ND: most 8-feature
// tiles (Dh / 8); the loops run to the call's own counts.  Block it is
// head it % H of window it / H (of the B * W), so the blocks in flight
// read whole token rows of a fused QKV.
template <int NT, int ND, typename T>
__global__ void __launch_bounds__(16 * NT, NT == 8 ? 4 : 1)
    window_attention_kernel(const Args<T> a) {
  const int it = blockIdx.x;
  const int w2p = (a.w2 + 15) / 16 * 16, ld = a.Dh + 4;
  extern __shared__ __align__(16) float sm[];
  if (item_valid(a, it)) {
    load_item(a, it, sm, w2p, ld);
    cp_async_commit();
    // pad rows (w2 <= row < w2p) of q, k and v are zero
    for (int idx = threadIdx.x; idx < 3 * (w2p - a.w2) * a.Dh;
         idx += blockDim.x) {
      const int r = idx / a.Dh, c = idx % a.Dh;
      sm[(r / (w2p - a.w2)) * w2p * ld + (a.w2 + r % (w2p - a.w2)) * ld + c] =
          0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  attend<NT, ND>(a, it, sm, w2p, ld);
}

template <int NT, int ND, typename T>
cudaError_t launch(const Args<T>& a, int n_items, cudaStream_t stream) {
  const int w2p = (a.w2 + 15) / 16 * 16;
  const size_t smem = sizeof(float) * 3 * w2p * (a.Dh + 4);
  cudaError_t e = repro_allow_smem(window_attention_kernel<NT, ND, T>, smem);
  if (e != cudaSuccess) return e;
  window_attention_kernel<NT, ND, T><<<n_items, 2 * w2p, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

template <typename T>
int entry(const T* q, const T* k, const T* v, const int* win_valid, T* out,
          int B, int W, int w2, int H, int KV, int Dh, long long sqb,
          long long sqt, long long skb, long long skt, long long svb,
          long long svt, float scale, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV || w2 <= 0 || w2 > 128 || Dh <= 0 || Dh % 8 ||
      Dh > 128)
    return cudaErrorInvalidValue;
  if (B == 0 || W == 0 || H == 0) return cudaSuccess;
  constexpr int V = Vec16<T>::N;   // 16-byte vectors: strides in elements
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (sqb | sqt | skb | skt | svb | svt) % V == 0;
  const Args<T> a{q,   k,   v,   win_valid, out, W,   w2,  H,     KV,
                  Dh,  sqb, sqt, skb,       skt, svb, svt, scale, vec};
  const long long n_items = static_cast<long long>(B) * W * H;
  if (n_items > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w2 <= 64 && Dh <= 64)
    return launch<8, 8>(a, static_cast<int>(n_items), s);
  return launch<16, 16>(a, static_cast<int>(n_items), s);
}

#define REPRO_WINDOW_ENTRY(T, SUF)                                          \
  REPRO_EXPORT int window_attention_##SUF(                                  \
      const T* q, const T* k, const T* v, const int* win_valid, T* out,     \
      int B, int W, int w2, int H, int KV, int Dh, long long sqb,           \
      long long sqt, long long skb, long long skt, long long svb,            \
      long long svt, float scale, int device, void* stream) {               \
    return entry<T>(q, k, v, win_valid, out, B, W, w2, H, KV, Dh, sqb, sqt, \
                    skb, skt, svb, svt, scale, device, stream);             \
  }

REPRO_FLOAT_TYPES(REPRO_WINDOW_ENTRY)

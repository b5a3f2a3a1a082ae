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
// exported as window_attention_{f32,f16,bf16}.  Float32 runs the kernel
// above.  fp16 / bf16 run window_attention_kernel_half:
//  - Bound: bytes.  Half q, k, v and out are 8 B per token, head and
//    feature: 67 MB per full-resolution layer of a wave of two, 20.0 us
//    at 3.35 TB/s, against 2.15 GFLOP (2.2 us at the 989 TFLOP/s half
//    tensor-core rate, 3.3 us for the three half products a product this
//    design takes).  The arithmetic is far off the critical path; what
//    bounds a kernel is how well its loads keep the memory busy.
//  - Design: half rows stay half.  A block owns one (window, head), as
//    at float32; its q, k and v rows are copied by 16-byte cp.async
//    straight into half shared rows of Dh rounded up to 16, plus 8
//    elements of padding, so the eight row addresses of an ldmatrix hit
//    eight distinct 16-byte bank groups: 27 KB a block at w2 = Dh = 64
//    (the float32 kernel's 52 KB); five blocks an SM (at most 102
//    registers a thread), one's copies running under the others'
//    arithmetic.  Within a block, q and k are one cp.async group and v
//    another: S and the softmax start once q and k have landed, while v
//    is still on its way.  A block that walks several items with two
//    buffers was slower (four blocks an SM, and a coarser tail), and so
//    were two heads a block (256-byte runs of a token row) and six
//    blocks an SM (80 registers): PERF.md §6.
//  - S = Q K^T and O = P V run as mma.sync m16n8k16 tiles with float32
//    accumulators, fragments from ldmatrix (V's transposed), one half
//    product a product for S (exact), two for O: P_hi V + P_lo V, P split
//    into two half pieces of the input's type as it leaves the scores,
//    whose layout is already the A fragment's (half_mma.cuh).  The row
//    softmax runs in base 2 (scores times scale * log2(e), one MUFU op
//    a probability); pad keys (w2 not a multiple of 16) score -inf, pad
//    rows and pad feature columns are zero.  The rows, divided by their
//    sum and rounded once, go through the warp's own q rows (no longer
//    read) so that a warp stores whole rows in 16-byte pieces.
//  - What is left between it and its bound: the copies' access pattern
//    (128-byte runs of 6 KB token rows) and the arithmetic (96 mma.sync
//    a warp and item, 64 of them P V's two pieces) that the blocks in
//    flight do not hide.
// The half kernel takes 16-byte-aligned bases and strides; the wrapper
// copies a view that misses them, and counts the copy.
//
// Windows a block (wb, both types): one (window, head) a block is the
// default and the kernels above, unchanged.  Where w2 <= 64 and Dh <= 64
// the wrapper may launch wb = 2 or 4 windows of one head a block, where
// the autotuner's sweep found it faster at the call's shape bucket
// (kernels/autotune.py): the block walks its windows with two buffers,
// and the next window's cp.async copies go out before the current
// window's arithmetic (window_attention_kernel_wb / _half_wb).  Twice the
// shared memory a block: two blocks an SM at float32 (104 KB), four at
// half (54 KB).
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "half_mma.cuh"
#include "tf32_mma.cuh"

namespace {

// Stage rows [0, w2) of a (w2, Dh) float slab with token pitch `st` into
// shared rows of `ld` floats.
__device__ __forceinline__ void stage(float* s, const float* g, long long st,
                                      int w2, int Dh, int ld, bool vec) {
  if (vec) {
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

// wb windows of one head a block (w2 <= 64, Dh <= 64): block x serves head
// x % H of windows [wb (x / H), wb (x / H) + wb) of the B * W, with two
// buffers; window i + 1's copies go out before window i's arithmetic.
template <int WB, typename T>
__global__ void __launch_bounds__(128, 2)
    window_attention_kernel_wb(const Args<T> a, int n_bw) {
  const int h = blockIdx.x % a.H, bw0 = blockIdx.x / a.H * WB;
  const int n = min(WB, n_bw - bw0);
  const int w2p = (a.w2 + 15) / 16 * 16, ld = a.Dh + 4;
  const int bufn = 3 * w2p * ld;                 // floats a buffer
  extern __shared__ __align__(16) float sm[];
  // pad rows (w2 <= row < w2p) of q, k and v in both buffers are zero: no
  // copy writes them
  const int pr = w2p - a.w2;
  for (int idx = threadIdx.x; idx < 6 * pr * a.Dh; idx += blockDim.x) {
    const int m = idx / (pr * a.Dh), r = idx % (pr * a.Dh);
    sm[(m / 3) * bufn + (m % 3) * w2p * ld + (a.w2 + r / a.Dh) * ld +
       r % a.Dh] = 0.0f;
  }
  const int it0 = bw0 * a.H + h;
  if (item_valid(a, it0)) load_item(a, it0, sm, w2p, ld);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int it = it0 + i * a.H;
    if (i + 1 < n && item_valid(a, it + a.H))
      load_item(a, it + a.H, sm + ((i + 1) & 1) * bufn, w2p, ld);
    cp_async_commit();
    cp_async_wait<1>();   // window i's rows have landed
    __syncthreads();
    attend<8, 8>(a, it, sm + (i & 1) * bufn, w2p, ld);
    __syncthreads();      // every warp is done with buffer i & 1
  }
}

template <int WB, typename T>
cudaError_t launch_wb(const Args<T>& a, int n_bw, cudaStream_t stream) {
  const int w2p = (a.w2 + 15) / 16 * 16;
  const size_t smem = sizeof(float) * 2 * 3 * w2p * (a.Dh + 4);
  cudaError_t e = repro_allow_smem(window_attention_kernel_wb<WB, T>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      static_cast<long long>((n_bw + WB - 1) / WB) * a.H;
  window_attention_kernel_wb<WB, T>
      <<<static_cast<int>(blocks), 2 * w2p, smem, stream>>>(a, n_bw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp16 / bf16: half rows in shared memory, m16n8k16 half tensor cores.

constexpr float kLog2e = 1.4426950408889634f;

// The shape of one item's half buffer: q, k and v, w2p rows each of ld =
// dp + 8 elements (dp: Dh rounded up to 16), so each row starts 16 bytes
// further round the banks and the eight row addresses of an ldmatrix hit
// distinct banks.
struct HalfBuf {
  int w2p, dp, ld, elems;
  __host__ __device__ explicit HalfBuf(int w2, int Dh)
      : w2p((w2 + 15) / 16 * 16), dp((Dh + 15) / 16 * 16), ld(dp + 8),
        elems(3 * w2p * ld) {}
};

// Start the 16-byte cp.async copies of item `it`'s rows [0, w2), columns
// [0, Dh) of q, k and v (m = 0, 1, 2) for m in [m0, m1) into `buf`.
template <typename E>
__device__ __forceinline__ void stage_half(const Args<E>& a, int it, E* buf,
                                           const HalfBuf& hb, int m0,
                                           int m1) {
  const int bw = it / a.H, h = it % a.H;
  const int b = bw / a.W, kvh = h / (a.H / a.KV), w2 = a.w2;
  const long long t0 = static_cast<long long>(bw % a.W) * w2;
  const E* src[3] = {
      a.q + b * a.sqb + t0 * a.sqt + static_cast<long long>(h) * a.Dh,
      a.k + b * a.skb + t0 * a.skt + static_cast<long long>(kvh) * a.Dh,
      a.v + b * a.svb + t0 * a.svt + static_cast<long long>(kvh) * a.Dh};
  const long long st[3] = {a.sqt, a.skt, a.svt};
  const int cpr = a.Dh / 8;
  for (int idx = m0 * w2 * cpr + threadIdx.x; idx < m1 * w2 * cpr;
       idx += blockDim.x) {
    const int m = idx / (w2 * cpr), r = idx % (w2 * cpr);
    const int i = r / cpr, c = (r % cpr) * 8;
    cp_async16(buf + (m * hb.w2p + i) * hb.ld + c, src[m] + i * st[m] + c);
  }
}

// Item `it` from its half rows in `buf`: S = Q K^T (one exact half
// product, float32 sums), the row softmax in float32 in base 2, O =
// P_hi V + P_lo V (half_mma.cuh), rows divided by their sum and rounded
// once; zeros for a pad window.
template <int NT, int ND, int VWAIT = 0, typename E>
__device__ __forceinline__ void attend_half(const Args<E>& a, int it,
                                            const E* buf,
                                            const HalfBuf& hb) {
  const int w2 = a.w2, Dh = a.Dh, ld = hb.ld;
  const int bw = it / a.H, h = it % a.H;
  const long long sot = static_cast<long long>(a.H) * Dh;
  E* ob = a.out + static_cast<long long>(bw) * w2 * sot +
          static_cast<long long>(h) * Dh;
  if (!item_valid(a, it)) {
    for (int idx = threadIdx.x; idx < w2 * Dh; idx += blockDim.x)
      ob[(idx / Dh) * sot + idx % Dh] = from_f32<E>(0.0f);
    return;
  }
  const E* const sq = buf;
  const E* const sk = sq + hb.w2p * ld;
  const E* const sv = sk + hb.w2p * ld;
  const int nt = hb.w2p / 8, nd = hb.dp / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;

  // S = Q K^T: fragment (j, e) is row g (+8 for e >= 2), key 8j + 2t +
  // (e & 1); ldmatrix x4 gives Q's A fragment of a k16 step, and two
  // neighbouring 8-key tiles of K's B fragments
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
  const E* qa = sq + (16 * warp + lane % 16) * ld + (lane / 16) * 8;
  const E* kb = sk + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < ND / 2; ++kk) {
    if (2 * kk >= nd) break;
    uint32_t af[4];
    ldsm_x4(af, qa + 16 * kk);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      if (2 * jp >= nt) break;
      uint32_t bf[4];
      ldsm_x4(bf, kb + 16 * jp * ld + 16 * kk);
      mma_16816<E>(s[2 * jp], af, bf);
      mma_16816<E>(s[2 * jp + 1], af, bf + 2);
    }
  }

  // row softmax in registers, in base 2: scores times scale * log2(e),
  // p = 2^(s - max) in one MUFU op; rows g and g + 8
  const float sl = a.scale * kLog2e;
  const bool pad = w2 != hb.w2p;      // pad keys to mask
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool key = !pad || 8 * j + 2 * t + e < w2;
      s[j][e] = key ? s[j][e] * sl : -INFINITY;
      s[j][2 + e] = key ? s[j][2 + e] * sl : -INFINITY;
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
      s[j][e] = ex2(s[j][e] - m0);
      s[j][2 + e] = ex2(s[j][2 + e] - m1);
      l0 += s[j][e];
      l1 += s[j][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // O = P_hi V + P_lo V per k16 step of keys, once V has landed (VWAIT:
  // the copy groups of a next window still in flight); ldmatrix.trans
  // gives V's B fragments of two neighbouring 8-feature tiles
  cp_async_wait<VWAIT>();
  __syncthreads();
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const E* vb = sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                (lane >> 4) * 8;
#pragma unroll
  for (int c = 0; c < NT / 2; ++c) {
    if (2 * c >= nt) break;
    uint32_t ph[4], pl[4];
    split_a<E>(s[2 * c], s[2 * c + 1], ph, pl);
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      if (2 * np >= nd) break;
      uint32_t bf[4];
      ldsm_x4_t(bf, vb + 16 * c * ld + 16 * np);
      mma_16816<E>(o[2 * np], ph, bf);
      mma_16816<E>(o[2 * np], pl, bf);
      mma_16816<E>(o[2 * np + 1], ph, bf + 2);
      mma_16816<E>(o[2 * np + 1], pl, bf + 2);
    }
  }

  // the rows divided by their sum and rounded once into the warp's own q
  // rows (Q is no longer read), then stored as 16-byte pieces: a warp
  // writes whole 16-row x Dh blocks
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
  E* const so = const_cast<E*>(sq) + 16 * warp * ld;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (8 * n >= Dh) break;
    const int c = 8 * n + 2 * t;
    store2(so + (lane / 4) * ld + c, o[n][0] * i0, o[n][1] * i0);
    store2(so + (lane / 4 + 8) * ld + c, o[n][2] * i1, o[n][3] * i1);
  }
  __syncwarp();
  const int cpr = Dh / 8;
  for (int idx = lane; idx < 16 * cpr; idx += 32) {
    const int r = idx / cpr, c = (idx % cpr) * 8;
    if (16 * warp + r < w2)
      *reinterpret_cast<uint4*>(ob + (16 * warp + r) * sot + c) =
          *reinterpret_cast<const uint4*>(so + r * ld + c);
  }
}

// Block it is head it % H of window it / H (of the B * W), as at float32,
// so the blocks in flight read whole token rows of a fused QKV; up to
// five blocks an SM (27 KB of shared memory and at most 102 registers a
// thread each), one's copies running under the others' arithmetic.
template <int NT, int ND, typename E>
__global__ void __launch_bounds__(16 * NT, NT == 8 ? 5 : 1)
    window_attention_kernel_half(const Args<E> a) {
  const HalfBuf hb(a.w2, a.Dh);
  extern __shared__ __align__(16) uint8_t smh[];
  E* const buf = reinterpret_cast<E*>(smh);
  const int it = blockIdx.x;
  if (item_valid(a, it)) {
    stage_half(a, it, buf, hb, 0, 2);   // q and k: what S needs
    cp_async_commit();
    stage_half(a, it, buf, hb, 2, 3);   // v lands under S and the softmax
    cp_async_commit();
    // pad rows and the pad column block of every row are zero
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const int pr = hb.w2p - a.w2, cb = hb.dp / 8;
    for (int idx = threadIdx.x; idx < 3 * pr * cb; idx += blockDim.x) {
      const int m = idx / (pr * cb), r = idx % (pr * cb);
      *reinterpret_cast<uint4*>(buf + (m * hb.w2p + a.w2 + r / cb) * hb.ld +
                                (r % cb) * 8) = zero;
    }
    if (hb.dp != a.Dh)
      for (int idx = threadIdx.x; idx < 3 * a.w2; idx += blockDim.x)
        *reinterpret_cast<uint4*>(
            buf + ((idx / a.w2) * hb.w2p + idx % a.w2) * hb.ld + a.Dh) = zero;
    cp_async_wait<1>();
    __syncthreads();
  }
  attend_half<NT, ND>(a, it, buf, hb);
}

template <int NT, int ND, typename E>
cudaError_t launch_half(const Args<E>& a, int n_items, cudaStream_t stream) {
  const HalfBuf hb(a.w2, a.Dh);
  const size_t smem = sizeof(E) * hb.elems;
  cudaError_t e =
      repro_allow_smem(window_attention_kernel_half<NT, ND, E>, smem);
  if (e != cudaSuccess) return e;
  window_attention_kernel_half<NT, ND, E>
      <<<n_items, 2 * hb.w2p, smem, stream>>>(a);
  return cudaGetLastError();
}

// wb windows of one head a block at half (w2 <= 64, Dh <= 64), as
// window_attention_kernel_wb: two buffers; window i + 1's q / k and v copy
// groups go out before window i's arithmetic, whose S waits for its own
// q and k (three groups may stay in flight) and P V for its v (two).
template <int WB, typename E>
__global__ void __launch_bounds__(128, 4)
    window_attention_kernel_half_wb(const Args<E> a, int n_bw) {
  const HalfBuf hb(a.w2, a.Dh);
  extern __shared__ __align__(16) uint8_t smh[];
  E* const sm = reinterpret_cast<E*>(smh);
  const int h = blockIdx.x % a.H, bw0 = blockIdx.x / a.H * WB;
  const int n = min(WB, n_bw - bw0);
  // pad rows and the pad column block of every row, in both buffers, are
  // zero: no copy writes them
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const int pr = hb.w2p - a.w2, cb = hb.dp / 8;
  for (int idx = threadIdx.x; idx < 6 * pr * cb; idx += blockDim.x) {
    const int m = idx / (pr * cb), r = idx % (pr * cb);
    *reinterpret_cast<uint4*>(sm + (m / 3) * hb.elems +
                              ((m % 3) * hb.w2p + a.w2 + r / cb) * hb.ld +
                              (r % cb) * 8) = zero;
  }
  if (hb.dp != a.Dh)
    for (int idx = threadIdx.x; idx < 6 * a.w2; idx += blockDim.x) {
      const int m = idx / a.w2;
      *reinterpret_cast<uint4*>(sm + (m / 3) * hb.elems +
                                ((m % 3) * hb.w2p + idx % a.w2) * hb.ld +
                                a.Dh) = zero;
    }
  const int it0 = bw0 * a.H + h;
  const bool v0 = item_valid(a, it0);
  if (v0) stage_half(a, it0, sm, hb, 0, 2);
  cp_async_commit();
  if (v0) stage_half(a, it0, sm, hb, 2, 3);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    const int it = it0 + i * a.H;
    const bool nx = i + 1 < n && item_valid(a, it + a.H);
    E* const nb = sm + ((i + 1) & 1) * hb.elems;
    if (nx) stage_half(a, it + a.H, nb, hb, 0, 2);
    cp_async_commit();
    if (nx) stage_half(a, it + a.H, nb, hb, 2, 3);
    cp_async_commit();
    cp_async_wait<3>();   // window i's q and k have landed
    __syncthreads();
    attend_half<8, 8, 2>(a, it, sm + (i & 1) * hb.elems, hb);
    __syncthreads();      // every warp is done with buffer i & 1
  }
}

template <int WB, typename E>
cudaError_t launch_half_wb(const Args<E>& a, int n_bw, cudaStream_t stream) {
  const HalfBuf hb(a.w2, a.Dh);
  const size_t smem = sizeof(E) * 2 * hb.elems;
  cudaError_t e =
      repro_allow_smem(window_attention_kernel_half_wb<WB, E>, smem);
  if (e != cudaSuccess) return e;
  const long long blocks =
      static_cast<long long>((n_bw + WB - 1) / WB) * a.H;
  window_attention_kernel_half_wb<WB, E>
      <<<static_cast<int>(blocks), 2 * hb.w2p, smem, stream>>>(a, n_bw);
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
          long long svt, float scale, int wb, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV || w2 <= 0 || w2 > 128 || Dh <= 0 || Dh % 8 ||
      Dh > 128 || (wb != 1 && wb != 2 && wb != 4) ||
      (wb > 1 && (w2 > 64 || Dh > 64)))
    return cudaErrorInvalidValue;
  if (B == 0 || W == 0 || H == 0) return cudaSuccess;
  constexpr int V = Vec16<T>::N;   // 16-byte vectors: strides in elements
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (sqb | sqt | skb | skt | svb | svt) % V == 0;
  const Args<T> a{q,   k,   v,   win_valid, out, W,   w2,  H,     KV,
                  Dh,  sqb, sqt, skb,       skt, svb, svt, scale, vec};
  const long long n_items = static_cast<long long>(B) * W * H;
  if (n_items > 0x7fffffff) return cudaErrorInvalidValue;
  const int n_bw = B * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) != 4) {   // half rows: 16-byte copies only
    if (!vec) return cudaErrorInvalidValue;
    if (wb == 2) return launch_half_wb<2>(a, n_bw, s);
    if (wb == 4) return launch_half_wb<4>(a, n_bw, s);
    if (w2 <= 64 && Dh <= 64)
      return launch_half<8, 8>(a, static_cast<int>(n_items), s);
    return launch_half<16, 16>(a, static_cast<int>(n_items), s);
  } else {
    if (wb == 2) return launch_wb<2>(a, n_bw, s);
    if (wb == 4) return launch_wb<4>(a, n_bw, s);
    if (w2 <= 64 && Dh <= 64)
      return launch<8, 8>(a, static_cast<int>(n_items), s);
    return launch<16, 16>(a, static_cast<int>(n_items), s);
  }
}

#define REPRO_WINDOW_ENTRY(T, SUF)                                          \
  REPRO_EXPORT int window_attention_##SUF(                                  \
      const T* q, const T* k, const T* v, const int* win_valid, T* out,     \
      int B, int W, int w2, int H, int KV, int Dh, long long sqb,           \
      long long sqt, long long skb, long long skt, long long svb,            \
      long long svt, float scale, int wb, int device, void* stream) {       \
    return entry<T>(q, k, v, win_valid, out, B, W, w2, H, KV, Dh, sqb, sqt, \
                    skb, skt, svb, svt, scale, wb, device, stream);         \
  }

REPRO_FLOAT_TYPES(REPRO_WINDOW_ENTRY)

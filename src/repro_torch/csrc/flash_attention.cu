// Flash attention: online-softmax attention over kv tiles, float32
// accuracy on the TF32 tensor cores.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:
// flash_attention_kernel (_flash_kernel).  q: (B, T, H, Dh), k/v:
// (B, S, KV, Dh), read through their batch and token strides; query head
// h reads kv head h / (H / KV); optional causal mask (query t sees keys
// s <= t); a row that no key reaches writes 0.  On the serving paths:
// the ViT global blocks after the restoration point, (2, 4096, 16, 64)
// not causal, as column views of the fused QKV product (token pitch 3072,
// or 2880 in the int8 lane); the LM prefill, causal GQA (8, 128, 32/8,
// 128); zamba2's shared block, causal.
//
// Bound on the H100: operations, 4 * T * S * Dh flops per head (137.4
// GFLOP at the ViT shape).  At float32 accuracy through 3xTF32 (three
// TF32 products per product, tf32_mma.cuh) that is 3 x 137.4 GFLOP at
// the 495 TFLOP/s dense TF32 rate: 0.83 ms, against 2.05 ms on the 67
// TFLOP/s float32 FMA units, where a scalar kernel is held further back
// by its shared-memory loads (four FMAs per pair of loads).
//
// Design:
//  - A block of 4 warps owns 64 MT query rows of one (batch row, head),
//    MT 16-row m-tiles a warp; the TPU's sequential kv grid axis becomes
//    a loop over 64-key tiles of the matching kv head.  Grid (T / 64 MT,
//    H, B); MT = 2 at Dh <= 64, 1 at Dh = 128.
//  - S = Q K^T and O += P V run as mma.sync m16n8k8 tiles in the 3xTF32
//    scheme into float32 accumulators; S (16 MT x 64 a warp) and O
//    (16 MT x Dh) stay in registers.
//  - The online softmax runs in registers on scores prescaled by
//    scale * log2(e) (exp2): the row max over the four threads of a row
//    by quad shuffles; each thread keeps a partial row sum of its own
//    columns, rescaled with the row, and the four are added once at the
//    end.  Masked scores are -inf; a row whose running max is still -inf
//    subtracts 0, so its probabilities and its rescale factor are 0 and
//    its output stays 0.
//  - Each key tile's P V accumulates from zero in its own fragment and
//    joins O in one float32 FMA a row, O = O alpha + (P V): an mma.sync
//    rounds its sum toward zero, so accumulating every tile's products
//    into the running O adds three such truncations a k-step, all of one
//    sign, of O's own size (on an H100, 1e-4 of the largest output of a
//    ViTDet-L global block, S = 4096, against float64: 25 times the
//    float32 plain version's error); within one tile they are of the
//    tile's partial sum.
//  - P feeds P V as the A operand without leaving registers: the 8 keys
//    of each tile are relabelled (k slot t <-> key 2t, slot t + 4 <->
//    key 2t + 1) and V's B fragment is read with the same relabelling,
//    as in window_attention.cu.
//  - K and V tiles are double-buffered: 16-byte cp.async copies of tile
//    kt + 1 (zero-filled past S) are issued right after tile kt lands,
//    so they run under tile kt's arithmetic.  Shared rows are Dh + 4
//    floats, so every fragment load of a warp hits 32 distinct banks.
//  - Where the operands split into TF32 hi / lo: K and V per fragment as
//    each warp reads them, every split feeding the warp's MT m-tiles:
//    hi / lo copies in shared memory would save the splits but double
//    the shared-memory bytes each mma reads.  Q per tile from shared
//    memory, an eighth of the K and V splits: held split in registers it
//    takes Dh registers a tile, which two m-tiles cannot afford.  P is
//    split in registers.
//  - Causal: key tiles wholly above the diagonal are skipped; only tiles
//    that straddle it or S test the mask.
// Shared memory: Q plus two stages of K and V, (64 MT + 4 x 64) x (Dh + 4)
// floats: 104 KB at Dh = 64, MT = 2 (two blocks an SM), 169 KB at
// Dh = 128.
//
// Element types (common.cuh): q, k, v and out all float32, fp16 or bf16,
// exported as flash_attention_{f32,f16,bf16}.  Half rows convert to
// float while staged (tf32_mma.cuh's stage_rows: plain 16-byte loads
// into the same float shared rows, so the shared-memory budget and the
// ring are those of float32; the next tile's loads are issued where its
// copies are, before the current tile's arithmetic).  Half values split
// with lo = 0 (exact TF32), so the arithmetic is float32's; the output
// rounds once to the input type, as the reference casts its float32
// result.
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kBK = 64, kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename E>
struct Args {
  const E *q, *k, *v;
  E* out;
  int T, S, H, KV;
  long long sqb, sqt, skb, skt, svb, svt;
  float scale_log2;  // softmax scale * log2(e)
  int causal;
  bool vec;          // 16-byte copies (aligned base and strides)
};

// 16-row m-tiles a warp: two where the registers allow (at Dh = 128 O
// alone takes 64 registers a tile)
__host__ __device__ constexpr int m_tiles(int dh) { return dh <= 64 ? 2 : 1; }

template <int DH, typename E>
__global__ void __launch_bounds__(kThreads, DH <= 64 ? 2 : 1)
    flash_attention_kernel(const Args<E> a) {
  constexpr int LD = DH + 4, ND = DH / 8, NJ = kBK / 8, MT = m_tiles(DH);
  constexpr int BQ = 64 * MT;  // query rows a block
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;               // BQ x LD
  float* KVs = Qs + BQ * LD;    // stage s: K at 2 s kBK LD, V after it

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const E* kb = a.k + b * a.skb + static_cast<long long>(kvh) * DH;
  const E* vb = a.v + b * a.svb + static_cast<long long>(kvh) * DH;

  int n_kt = (a.S + kBK - 1) / kBK;
  if (a.causal) {  // tiles wholly above the diagonal contribute nothing
    const int last = (min(q0 + BQ, a.T) - 1) / kBK + 1;
    n_kt = min(n_kt, last);
  }

  stage_rows<DH>(Qs, LD,
                 a.q + b * a.sqb + static_cast<long long>(q0) * a.sqt +
                     static_cast<long long>(h) * DH,
                 a.sqt, BQ, a.T - q0, a.vec);
  if (n_kt > 0) {
    stage_rows<DH>(KVs, LD, kb, a.skt, kBK, a.S, a.vec);
    stage_rows<DH>(KVs + kBK * LD, LD, vb, a.svt, kBK, a.S, a.vec);
  }
  cp_async_commit();

  // the warp's m-tile mt holds rows 16 (MT warp + mt) + g and + 8; the
  // thread's fragments read columns t and t + 4
  const float* qw = Qs + (16 * MT * warp + g) * LD + t;
  int r0[MT];
  float o[MT][ND][4], m0[MT], m1[MT], l0[MT], l1[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    r0[mt] = q0 + 16 * (MT * warp + mt) + g;
    m0[mt] = m1[mt] = -INFINITY;
    l0[mt] = l1[mt] = 0.0f;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + 1 < n_kt) {
      const int k1 = (kt + 1) * kBK;
      float* nxt = KVs + ((kt + 1) & 1) * 2 * kBK * LD;
      stage_rows<DH>(nxt, LD, kb + k1 * a.skt, a.skt, kBK, a.S - k1, a.vec);
      stage_rows<DH>(nxt + kBK * LD, LD, vb + k1 * a.svt, a.svt, kBK,
                     a.S - k1, a.vec);
    }
    cp_async_commit();
    const float* Ks = KVs + (kt & 1) * 2 * kBK * LD;
    const float* Vs = Ks + kBK * LD;
    const int k0 = kt * kBK;

    // S = Q K^T: fragment (mt, j, e) is row r0[mt] (+8 for e >= 2), key
    // k0 + 8j + 2t + (e & 1); each K fragment is split once for the MT
    // m-tiles
    float s[MT][NJ][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* qp = qw + 16 * mt * LD + 8 * kk;
        split_tf32(qp[0], ah[mt][0], al[mt][0]);
        split_tf32(qp[8 * LD], ah[mt][1], al[mt][1]);
        split_tf32(qp[4], ah[mt][2], al[mt][2]);
        split_tf32(qp[8 * LD + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kp = Ks + (8 * j + g) * LD + 8 * kk + t;
        uint32_t bh[2], bl[2];
        split_tf32(kp[0], bh[0], bl[0]);
        split_tf32(kp[4], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32_split(s[mt][j], ah[mt], al[mt], bh, bl);
      }
    }

    // online softmax, in base 2; alpha rescales O once the tile's P V is in
    const bool edge = k0 + kBK > a.S || (a.causal && k0 + kBK - 1 > q0);
    float al0[MT], al1[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int ra = r0[mt], rb = ra + 8;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = s[mt][j][e] * a.scale_log2;
          float v1 = s[mt][j][2 + e] * a.scale_log2;
          if (edge) {
            const int kj = k0 + 8 * j + 2 * t + e;
            if (kj >= a.S || (a.causal && kj > ra)) v0 = -INFINITY;
            if (kj >= a.S || (a.causal && kj > rb)) v1 = -INFINITY;
          }
          s[mt][j][e] = v0;
          s[mt][j][2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0[mt], mx0), mn1 = fmaxf(m1[mt], mx1);
      // a row no key has reached yet subtracts 0: exp2(-inf) = 0 throughout
      const float mr0 = mn0 == -INFINITY ? 0.0f : mn0;
      const float mr1 = mn1 == -INFINITY ? 0.0f : mn1;
      al0[mt] = exp2f(m0[mt] - mr0);
      al1[mt] = exp2f(m1[mt] - mr1);
      m0[mt] = mn0;
      m1[mt] = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[mt][j][e] = exp2f(s[mt][j][e] - mr0);
          s[mt][j][2 + e] = exp2f(s[mt][j][2 + e] - mr1);
          rs0 += s[mt][j][e];
          rs1 += s[mt][j][2 + e];
        }
      }
      l0[mt] = l0[mt] * al0[mt] + rs0;
      l1[mt] = l1[mt] * al1[mt] + rs1;
    }

    // P V, keys of tile j relabelled: k slot t <-> key 8j + 2t, slot
    // t + 4 <-> key 8j + 2t + 1; each V fragment is split once for the MT
    // m-tiles
    float pv[MT][ND][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[mt][n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][j][0], ah[mt][0], al[mt][0]);
        split_tf32(s[mt][j][2], ah[mt][1], al[mt][1]);
        split_tf32(s[mt][j][1], ah[mt][2], al[mt][2]);
        split_tf32(s[mt][j][3], ah[mt][3], al[mt][3]);
      }
      const float* vp = Vs + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(vp[8 * n], bh[0], bl[0]);
        split_tf32(vp[8 * n + LD], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_3xtf32_split(pv[mt][n], ah[mt], al[mt], bh, bl);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[mt][n][0] = fmaf(o[mt][n][0], al0[mt], pv[mt][n][0]);
        o[mt][n][1] = fmaf(o[mt][n][1], al0[mt], pv[mt][n][1]);
        o[mt][n][2] = fmaf(o[mt][n][2], al1[mt], pv[mt][n][2]);
        o[mt][n][3] = fmaf(o[mt][n][3], al1[mt], pv[mt][n][3]);
      }
  }
  cp_async_wait<0>();  // the Q copy, when no tile ran

  const long long sot = static_cast<long long>(a.H) * DH;
  E* ob = a.out + static_cast<long long>(b) * a.T * sot +
              static_cast<long long>(h) * DH + 2 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float s0 = l0[mt], s1 = l1[mt];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    const float i0 = s0 > 0.0f ? 1.0f / s0 : 0.0f;
    const float i1 = s1 > 0.0f ? 1.0f / s1 : 0.0f;
    const int ra = r0[mt], rb = ra + 8;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (ra < a.T)
        store2(ob + ra * sot + 8 * n, o[mt][n][0] * i0, o[mt][n][1] * i0);
      if (rb < a.T)
        store2(ob + rb * sot + 8 * n, o[mt][n][2] * i1, o[mt][n][3] * i1);
    }
  }
}

template <int DH, typename E>
cudaError_t launch(const Args<E>& a, int B, cudaStream_t stream) {
  constexpr int BQ = 64 * m_tiles(DH);
  const size_t smem = sizeof(float) * (BQ + 4 * kBK) * (DH + 4);
  cudaError_t e = repro_allow_smem(flash_attention_kernel<DH, E>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, B);
  flash_attention_kernel<DH, E><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

template <typename E>
int entry(const E* q, const E* k, const E* v, E* out, int B, int T_, int S,
          int H, int KV, int Dh, long long sqb, long long sqt, long long skb,
          long long skt, long long svb, long long svt, float scale,
          int causal, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  if (B == 0 || T_ == 0 || H == 0) return cudaSuccess;
  constexpr int V = Vec16<E>::N;   // 16-byte vectors: strides in elements
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   (sqb | sqt | skb | skt | svb | svt) % V == 0;
  const Args<E> a{q,   k,   v,   out, T_,  S,   H,
                  KV,  sqb, sqt, skb, skt, svb, svt,
                  scale * kLog2e, causal, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch<16>(a, B, st);
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    case 128: return launch<128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

#define REPRO_FLASH_ENTRY(T, SUF)                                            \
  REPRO_EXPORT int flash_attention_##SUF(                                    \
      const T* q, const T* k, const T* v, T* out, int B, int T_, int S,      \
      int H, int KV, int Dh, long long sqb, long long sqt, long long skb,    \
      long long skt, long long svb, long long svt, float scale, int causal,  \
      int device, void* stream) {                                            \
    return entry<T>(q, k, v, out, B, T_, S, H, KV, Dh, sqb, sqt, skb, skt,   \
                    svb, svt, scale, causal, device, stream);                \
  }

REPRO_FLOAT_TYPES(REPRO_FLASH_ENTRY)

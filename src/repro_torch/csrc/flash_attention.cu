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
//    H, B).  MT is a template parameter: the default is m_tiles(Dh), 2 at
//    Dh <= 64 and 1 at Dh = 128, and at Dh = 64 the wrapper may launch MT
//    = 1, where the autotuner's sweep found it faster at the call's shape
//    bucket (kernels/autotune.py, kernels/flash_attention/ops.py:
//    F32_TILES): a block of 64 query rows wastes less of a short T (one
//    query row a step of whisper's cross-attention).  MT = 2 at Dh = 128
//    spilled (1140 / 868 bytes of spill stores / loads, ptxas: O, P V
//    and S of two m-tiles want ~320 registers) and is not built.
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
// floats: 104 KB at Dh = 64, MT = 2 (two blocks an SM), 87 KB at MT = 1;
// 169 KB at Dh = 128.
//
// Element types (common.cuh): q, k, v and out all float32, fp16 or bf16,
// exported as flash_attention_{f32,f16,bf16}.  Float32 runs the kernel
// above.  fp16 / bf16 run flash_attention_kernel_half, built for Hopper's
// half tensor cores:
//  - Bound: operations, 137.4 GFLOP at the ViT shape, 139 us at the 989
//    TFLOP/s dense half rate for one half product a product.  Q K^T takes
//    one (a product of two half values is exact in float32, summed in a
//    float32 accumulator); P V takes two, P_hi V + P_lo V, with P split in
//    registers into two pieces of the input's type (half_mma.cuh): P
//    rounded once moves a third of the outputs off the float32 plain
//    version's rounding, the split keeps over 99% of them bit-equal.
//    Three half products a product: a floor of 208 us at the ViT shape.
//    Beside them the softmax runs on the CUDA cores (an exp2 per score,
//    16 a clock an SM: ~140 us at the ViT shape) with the split's
//    conversions.
//  - Design: wgmma.mma_async m64nNk16 with float32 accumulators, the
//    only way to the half tensor cores' full rate.  A block of 128 query
//    rows of one (batch row, head) has two consumer warpgroups of 64
//    rows and one producer warp.  The producer's lane 0 loads Q once and
//    keeps a ring of STAGES K / V stages full with TMA (4D maps over
//    (Dh, heads, tokens, batch) built per call, so the fused QKV product's
//    column views go in as they are), each stage completing on a "full"
//    mbarrier and reused once all eight consumer warps have arrived on
//    its "empty" one.  Rows are 128 bytes (64 half columns) with the
//    128-byte swizzle, the layout wgmma's descriptors read: Dh = 128 is
//    two such panels, Dh = 16 or 32 one panel whose extra columns TMA
//    fills with zeros (exact zeros in Q K^T, unstored in O).  Rows past T
//    or S read as zero; masked scores are -inf.
//  - S = Q K^T: wgmma with Q and K both K-major in shared memory, BN
//    keys a tile.  BN and STAGES are template parameters: the default is
//    BN = 128 at Dh <= 64 (64 at Dh = 128, where O takes 64 registers a
//    thread) and three stages; the wrapper may launch BN 64 / 128 and two
//    or three stages where the autotuner's sweep found one faster at the
//    call's shape bucket (ops.py: HALF_TILES; BN = 128 only at Dh <= 64).  The online softmax is the float32 kernel's in registers,
//    in base 2, with its -inf handling; the scale multiplies the row max
//    of the raw scores once and folds into p = 2^(s scale - max) as one
//    FMA, and 2^x is one MUFU op (ex2.approx.ftz).  The score
//    accumulator's layout is already the A-register layout of 16 keys,
//    so P_hi and P_lo feed wgmma from registers with no relabelling; V is
//    B, MN-major in shared memory under wgmma's transpose bit.
//  - Each key tile's P V starts from zero in its own fragment (scale-d 0
//    on its first wgmma), per 64-column panel of V, and joins O in one
//    float32 FMA a value, O = O alpha + (P V): the tensor cores' sums
//    round toward zero, wgmma's as well as mma.sync's, so accumulating
//    into the running O would add truncations of O's own size.
//  - The two warpgroups take turns at the tensor cores (named barriers):
//    a turn issues tile kt - 1's P V, joins it, and issues tile kt's
//    Q K^T; tile kt's softmax runs outside the turn, under the other
//    warpgroup's products.  That keeps one tile's scores and the P pieces
//    of the tile before live one at a time: 139-167 registers a thread
//    with no spills, inside the 168 that a 288-thread block gets (a
//    block's registers are counted in whole warpgroups).  FA3's
//    two-stage pipeline (the next Q K^T under this tile's softmax) needs
//    both live, ~215 registers: ptxas compiled it at 168 even under
//    setmaxnreg, spilled and ran slower (PERF.md §6).  One block an SM;
//    outputs round once, to nearest, on store.
// The half kernel takes 16-byte-aligned bases and strides (TMA's terms);
// the wrapper copies a view that misses them, and counts the copy.
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "half_mma.cuh"
#include "hopper.cuh"
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

template <int DH, int MT, typename E>
__global__ void __launch_bounds__(kThreads, DH <= 64 ? 2 : 1)
    flash_attention_kernel(const Args<E> a) {
  constexpr int LD = DH + 4, ND = DH / 8, NJ = kBK / 8;
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

template <int DH, int MT, typename E>
cudaError_t launch(const Args<E>& a, int B, cudaStream_t stream) {
  constexpr int BQ = 64 * MT;
  const size_t smem = sizeof(float) * (BQ + 4 * kBK) * (DH + 4);
  cudaError_t e = repro_allow_smem(flash_attention_kernel<DH, MT, E>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, B);
  flash_attention_kernel<DH, MT, E><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// fp16 / bf16: TMA loads, wgmma on the half tensor cores.

// Tile sizes of the half kernel for head width DH, BN_ keys a tile and a
// ring of ST_ stages.  Shared rows are 128 bytes, 64 half columns, the
// 128-byte swizzle's row: a head of DH > 64 takes DH / 64 such panels, and
// one of DH < 64 is zero-filled by TMA to one panel (its extra columns add
// exact zeros to Q K^T, and their outputs are not stored).
template <int DH, int BN_, int ST_>
struct HalfTile {
  static constexpr int DP = DH < 64 ? 64 : DH;  // staged head width
  static constexpr int NP = DP / 64;            // 64-column panels
  static constexpr int BQ = 128;                // query rows: 2 warpgroups
  static constexpr int BN = BN_;                // keys a tile
  static constexpr int STAGES = ST_;
  static_assert(BN == 64 || (BN == 128 && DP == 64), "BN");
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BN * 128;  // bytes
  static constexpr int Q_BYTES = NP * Q_PANEL, KV_BYTES = NP * KV_PANEL;
  static constexpr int STAGE = 2 * KV_BYTES;    // K then V
  // 1 KB of slack to align to the swizzle's 1024 bytes, Q, the ring, and
  // the Q barrier, a full and an empty barrier per stage
  static constexpr size_t SMEM =
      1024 + Q_BYTES + STAGES * STAGE + (1 + 2 * STAGES) * sizeof(uint64_t);
};
constexpr int kHalfConsumers = 2;                        // warpgroups
constexpr int kHalfThreads = kHalfConsumers * 128 + 32;  // + producer warp
constexpr int kSched = 1;   // named barriers kSched + wg: the issue turns

template <int DH, int BN_, int ST_, typename E>
__global__ void __launch_bounds__(kHalfThreads, 1)
    flash_attention_kernel_half(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                E* __restrict__ out, int T, int S, int H,
                                int KV, float scale_log2, int causal) {
  using L = HalfTile<DH, BN_, ST_>;
  constexpr int BQ = L::BQ, BN = L::BN, NP = L::NP, ST = L::STAGES;
  constexpr int NS = BN / 8;      // 8-key blocks of a score row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = Qs + L::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + ST * L::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + ST;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int n_kt = (S + BN - 1) / BN;
  if (causal) {  // tiles wholly above the diagonal contribute nothing
    const int last = (min(q0 + BQ, T) - 1) / BN + 1;
    n_kt = min(n_kt, last);
  }

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kHalfConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kHalfConsumers * 4) {
    // producer: lane 0 loads Q once, then keeps the ring of K / V tiles
    // full; TMA zero-fills rows past T or S and columns past DH
    if (lane == 0) {
      mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_4d(&mq, Qs + p * L::Q_PANEL, qbar, 64 * p, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(&empty[s], ((kt / ST) - 1) & 1);
        uint8_t* st = ring + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(&mk, st + p * L::KV_PANEL, &full[s], 64 * p, kvh,
                      kt * BN, b);
          tma_load_4d(&mv, st + L::KV_BYTES + p * L::KV_PANEL, &full[s],
                      64 * p, kvh, kt * BN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the
  // block; the thread holds rows ra and rb = ra + 8 of them, and the
  // columns 8j + 2t, + 1 of every 8-column block of a 64-wide fragment
  const int wg = warp / 4, t = lane % 4;
  const int ra = q0 + 64 * wg + 16 * (warp % 4) + lane / 4, rb = ra + 8;
  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  const uint32_t qa = smem_u32(Qs) + wg * 64 * 128;
  mbar_wait(qbar, 0);

  // tile kt's online softmax on sc in float32, in base 2: the row max of
  // the masked raw scores, scaled once (the scale is positive, so this is
  // the max of the scaled scores), p = 2^(s scale - max) in one FMA; then
  // P as two half pieces in the A layout of each 16 keys (half_mma.cuh)
  uint32_t ph[BN / 16][4], pl[BN / 16][4];
  float al0 = 1.0f, al1 = 1.0f;      // the rescale of the tile in ph / pl
  auto softmax = [&](int kt, float* sc) {
    const int k0 = kt * BN;
    const bool edge = k0 + BN > S || (causal && k0 + BN - 1 > ra);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t + e;
          if (kj >= S || (causal && kj > ra)) sc[4 * j + e] = -INFINITY;
          if (kj >= S || (causal && kj > rb)) sc[4 * j + 2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, sc[4 * j + e]);
        mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    // a row no key has reached yet subtracts 0: 2^-inf = 0 throughout
    const float mr0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float mr1 = mn1 == -INFINITY ? 0.0f : mn1;
    al0 = ex2(m0 - mr0);
    al1 = ex2(m1 - mr1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -mr0));
        sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -mr1));
        rs0 += sc[4 * j + e];
        rs1 += sc[4 * j + 2 + e];
      }
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int c = 0; c < BN / 16; ++c)
      split_a<E>(sc + 8 * c, sc + 8 * c + 4, ph[c], pl[c]);
  };
  // S = Q K^T of tile kt: one half product a product (exact), float32
  // sums; fragment 4j + e is row ra (rb for e >= 2), key kt BN + 8j + 2t
  // + (e & 1)
  auto issue_qk = [&](int kt, float* sc) {
    mbar_wait(&full[kt % ST], (kt / ST) & 1);
    const uint32_t ks = smem_u32(ring + (kt % ST) * L::STAGE);
    fence_regs<4 * NS>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::DP / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      wgmma_ss<BN, E>(sc, sw128_desc(qa + p * L::Q_PANEL + off),
                      sw128_desc(ks + p * L::KV_PANEL + off), kk);
    }
    wgmma_commit();
  };
  auto wait_qk = [&](float* sc) {
    wgmma_wait<0>();
    fence_regs<4 * NS>(sc);
  };
  // P V of tile kt per 64-column panel of V: from zero in its own
  // fragment, P_hi V then P_lo V each 16 keys, joined to O in one float32
  // FMA a value; then the stage is released
  auto pv_join = [&](int kt) {
    const uint32_t vs =
        smem_u32(ring + (kt % ST) * L::STAGE) + L::KV_BYTES;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float pv[32];
      fence_regs<32>(pv);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        const uint64_t dv = sw128_desc(vs + p * L::KV_PANEL + c * 16 * 128);
        wgmma_rs<E>(pv, ph[c], dv, c);
        wgmma_rs<E>(pv, pl[c], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(pv);
#pragma unroll
      for (int c = 0; c < BN / 16; ++c) {
        fence_regs<4>(ph[c]);
        fence_regs<4>(pl[c]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[p][i] = fmaf(o[p][i], (i & 2) ? al1 : al0, pv[i]);
    }
    if (lane == 0) mbar_arrive(&empty[kt % ST]);   // this warp is done
  };

  // The two warpgroups take turns at the tensor cores (named barriers
  // kSched + wg): a turn issues tile kt - 1's P V and tile kt's Q K^T, and
  // the softmax of tile kt runs outside the turn, while the other
  // warpgroup has its own.  n_kt + 1 turns a warpgroup, warpgroup 0 first
  // and warpgroup 1 last.  Each step's scores are a fresh array, so no
  // tile's scores stay live across the next turn.
  if (n_kt > 0) {
    if (wg == 1) named_arrive(kSched, 256);
    {
      float sc[4 * NS];
      named_sync(kSched + wg, 256);
      issue_qk(0, sc);
      named_arrive(kSched + 1 - wg, 256);
      wait_qk(sc);
      softmax(0, sc);
    }
    for (int kt = 1; kt < n_kt; ++kt) {
      float sc[4 * NS];
      named_sync(kSched + wg, 256);
      pv_join(kt - 1);
      issue_qk(kt, sc);
      named_arrive(kSched + 1 - wg, 256);
      wait_qk(sc);
      softmax(kt, sc);
    }
    named_sync(kSched + wg, 256);
    pv_join(n_kt - 1);
    if (wg == 0) named_arrive(kSched + 1, 256);
  }

  float s0 = l0, s1 = l1;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  const float i0 = s0 > 0.0f ? 1.0f / s0 : 0.0f;
  const float i1 = s1 > 0.0f ? 1.0f / s1 : 0.0f;
  const long long sot = static_cast<long long>(H) * DH;
  E* ob = out + static_cast<long long>(b) * T * sot +
          static_cast<long long>(h) * DH + 2 * t;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (64 * p + 8 * j >= DH) break;
      const int c = 64 * p + 8 * j;
      if (ra < T)
        store2(ob + ra * sot + c, o[p][4 * j] * i0, o[p][4 * j + 1] * i0);
      if (rb < T)
        store2(ob + rb * sot + c, o[p][4 * j + 2] * i1,
               o[p][4 * j + 3] * i1);
    }
}

// A (B, rows, heads, DH) half tensor, heads dense, as a 4D TMA map of
// boxes of 64 columns x 1 head x `box_rows` rows, swizzled 128 bytes;
// elements outside the tensor read as zero.  Strides in elements.
template <typename E>
bool head_map(CUtensorMap* map, const E* base, int DH, int heads, int rows,
              int B, long long srow, long long sb, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (B == 1) sb = srow * rows;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(DH) * sizeof(E),
      static_cast<cuuint64_t>(srow) * sizeof(E),
      static_cast<cuuint64_t>(sb) * sizeof(E)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType ty = std::is_same_v<E, __half>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, ty, 4, const_cast<E*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int BN, int ST, typename E>
cudaError_t launch_half(const E* q, const E* k, const E* v, E* out, int B,
                        int T, int S, int H, int KV, long long sqb,
                        long long sqt, long long skb, long long skt,
                        long long svb, long long svt, float scale_log2,
                        int causal, cudaStream_t stream) {
  using L = HalfTile<DH, BN, ST>;
  CUtensorMap mq, mk, mv;
  int rows = S;
  if (S == 0) {  // no key: no K / V tile is loaded; their maps are q's
    k = v = q;
    KV = H;
    rows = T;
    skt = svt = sqt;
    skb = svb = sqb;
  }
  if (!head_map(&mq, q, DH, H, T, B, sqt, sqb, L::BQ) ||
      !head_map(&mk, k, DH, KV, rows, B, skt, skb, L::BN) ||
      !head_map(&mv, v, DH, KV, rows, B, svt, svb, L::BN))
    return cudaErrorInvalidValue;
  auto* kernel = flash_attention_kernel_half<DH, BN, ST, E>;
  cudaError_t e = repro_allow_smem(kernel, L::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((T + L::BQ - 1) / L::BQ, H, B);
  kernel<<<grid, kHalfThreads, L::SMEM, stream>>>(mq, mk, mv, out, T, S, H,
                                                   KV, scale_log2, causal);
  return cudaGetLastError();
}

// TMA's terms: 16-byte-aligned bases and byte strides (the wrapper copies
// a view that misses them).  (bn, stages) picks the tile: 128 or 64 keys
// (64 only at Dh = 128), two or three stages.
template <typename E>
int entry_half(const E* q, const E* k, const E* v, E* out, int B, int T_,
               int S, int H, int KV, int Dh, long long sqb, long long sqt,
               long long skb, long long skt, long long svb, long long svt,
               float scale, int causal, int bn, int stages, cudaStream_t st) {
  constexpr int V = Vec16<E>::N;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) ||
      (sqb | sqt | skb | skt | svb | svt) % V || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  const float sl = scale * kLog2e;
#define REPRO_FLASH_HALF(DH, BN, ST)                                         \
  if (Dh == DH && bn == BN && stages == ST)                                  \
    return launch_half<DH, BN, ST>(q, k, v, out, B, T_, S, H, KV, sqb, sqt,  \
                                   skb, skt, svb, svt, sl, causal, st)
#define REPRO_FLASH_HALF_64(DH)                                              \
  REPRO_FLASH_HALF(DH, 128, 3);                                              \
  REPRO_FLASH_HALF(DH, 128, 2);                                              \
  REPRO_FLASH_HALF(DH, 64, 3);                                               \
  REPRO_FLASH_HALF(DH, 64, 2)
  REPRO_FLASH_HALF_64(16);
  REPRO_FLASH_HALF_64(32);
  REPRO_FLASH_HALF_64(64);
  REPRO_FLASH_HALF(128, 64, 3);
  REPRO_FLASH_HALF(128, 64, 2);
#undef REPRO_FLASH_HALF_64
#undef REPRO_FLASH_HALF
  return cudaErrorInvalidValue;
}

}  // namespace

template <typename E>
int entry(const E* q, const E* k, const E* v, E* out, int B, int T_, int S,
          int H, int KV, int Dh, long long sqb, long long sqt, long long skb,
          long long skt, long long svb, long long svt, float scale,
          int causal, int mt, int bn, int stages, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV) return cudaErrorInvalidValue;
  if (B == 0 || T_ == 0 || H == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(E) != 4) {
    return entry_half(q, k, v, out, B, T_, S, H, KV, Dh, sqb, sqt, skb, skt,
                      svb, svt, scale, causal, bn, stages, st);
  } else {
    constexpr int V = Vec16<E>::N;   // 16-byte vectors: strides in elements
    const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                     (sqb | sqt | skb | skt | svb | svt) % V == 0;
    const Args<E> a{q,   k,   v,   out, T_,  S,   H,
                    KV,  sqb, sqt, skb, skt, svb, svt,
                    scale * kLog2e, causal, vec};
    // mt m-tiles a warp: m_tiles(Dh) at every width, or 1 at Dh = 64
    if (Dh == 16 && mt == 2) return launch<16, 2>(a, B, st);
    if (Dh == 32 && mt == 2) return launch<32, 2>(a, B, st);
    if (Dh == 64 && mt == 2) return launch<64, 2>(a, B, st);
    if (Dh == 64 && mt == 1) return launch<64, 1>(a, B, st);
    if (Dh == 128 && mt == 1) return launch<128, 1>(a, B, st);
    return cudaErrorInvalidValue;
  }
}

#define REPRO_FLASH_ENTRY(T, SUF)                                            \
  REPRO_EXPORT int flash_attention_##SUF(                                    \
      const T* q, const T* k, const T* v, T* out, int B, int T_, int S,      \
      int H, int KV, int Dh, long long sqb, long long sqt, long long skb,    \
      long long skt, long long svb, long long svt, float scale, int causal,  \
      int mt, int bn, int stages, int device, void* stream) {                \
    return entry<T>(q, k, v, out, B, T_, S, H, KV, Dh, sqb, sqt, skb, skt,   \
                    svb, svt, scale, causal, mt, bn, stages, device,         \
                    stream);                                                 \
  }

REPRO_FLOAT_TYPES(REPRO_FLASH_ENTRY)

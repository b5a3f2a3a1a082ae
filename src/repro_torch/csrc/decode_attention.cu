// One-token GQA decode attention against a KV cache, float32 arithmetic.
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
// once, B * kv_len * KV * Dh * 8 bytes, at about one flop per byte.  At
// the serving shape that is ~8.5 MB, 2.6 us at 3.35 TB/s: the time goes
// to getting enough bytes in flight, not to arithmetic.
//
// Design: one launch, no scratch in device memory, no host read of
// kv_len (the launch depends on the shapes alone, so a CUDA graph can
// hold it).  The keys of each (batch row, kv head, group of up to 8 query
// heads) -- or, where every kv head has one query head, of 4 adjacent kv
// heads, whose rows of a token lie side by side -- are shared by the
// n_split <= 8 blocks of one thread-block cluster: the wrapper's plan
// puts two blocks on every SM for a short cache (splits of ~32 keys at
// the Qwen3-4B serving shape) and about one an SM, in splits of at most
// 1,024 keys, for a long one.  On the device each row's kv_len valid
// keys are cut evenly over the cluster, so no block of it waits idle on
// another.  A block copies its K and V rows into shared memory with
// 16-byte cp.async, in tiles of 16 KB each of K and V in a ring of two:
// at the serving shape a split is one tile, all of it in flight before
// the first dot product.  Every staged row is read from shared memory
// once, for all the query heads that share it: each lane holds its
// slices of those query rows in registers, a few lanes reduce a key's
// dot products by shuffles, and the warp keeps a running max, sum and
// output slice per query head (online softmax, plain float32 FMA: TF32
// would break parity).  The warps of a block, then the blocks of the
// cluster, merge their partial softmaxes; rank 0 reads the others'
// through distributed shared memory, all at once, and writes the output.
//
// Element types (common.cuh).  The reference casts q, k and v to float32
// each on load, so q's type and the cache's may differ (fp16 weights over
// the default float32 cache, float32 weights over a bf16 cache).  The
// kernel is a template over the cache's type, exported as
// decode_attention_{f32,f16,bf16}; q's type (and the output's, which is
// q's) is an argument, 0 / 1 / 2 for float32 / fp16 / bf16, read once a
// block.  A half cache converts to float while staged: plain 16-byte
// loads of 8 elements, stored as two float4 slots of the same ring, so
// the arithmetic reads float32 at every type; the cache's bytes, which
// bound the kernel, halve.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "tf32_mma.cuh"  // cp.async copies

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr int kMaxStages = 2;    // ring depth of a long split
constexpr int kTileFloats = 4096;  // 16 KB of K (and of V) rows per stage

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Wait for every cp.async group but the `pending` newest (kMaxStages
// is 2, so at most one).
__device__ __forceinline__ void wait_pending(int pending) {
  if (pending) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// Shared-memory slot (in float4s) of float4 c of staged row `row`, RW
// float4s a row: odd rows swap the 64-byte halves of every 128-byte run
// (c ^ 4), so the two rows one quarter-warp reads while scoring fall on
// distinct banks (rows of 16 floats already do).
template <int RW>
__device__ __forceinline__ int slot(int row, int c) {
  return row * RW + (RW >= 8 ? c ^ ((row & 1) << 2) : c);
}

// One block: split `cluster rank` of the keys of batch row b and either
// one kv head with a group of up to GT of its query heads (HB = 1), or
// HB = 4 adjacent kv heads of one query head each (G = 1): one run of
// 4 * Dh floats a token instead of four short ones.  With HB = 1 each
// warp serves every head of the group on its KPI-key runs of every tile;
// with HB = 4 warp w serves kv head w on every key.  Scores: LPS lanes
// per key, each holding QF float4s of every query row in registers,
// reduced by shuffles; the warp takes the max of KPI keys at once (more
// keys, so more independent chains, where the group has few heads).
// P V: Dh / 4 lanes cover one V row, 32 * 4 / Dh rows at a time, each
// key's p broadcast by a shuffle.
// Four consecutive elements of q (type code qdt) at element offset off
// (a multiple of 4), as floats; and four outputs, rounded once.
__device__ __forceinline__ float4 load_q4(const void* q, int qdt,
                                          long long off) {
  if (qdt == 1) return load4(static_cast<const __half*>(q) + off);
  if (qdt == 2) return load4(static_cast<const __nv_bfloat16*>(q) + off);
  return load4(static_cast<const float*>(q) + off);
}

__device__ __forceinline__ void store_o4(void* out, int qdt, long long off,
                                         float4 v) {
  if (qdt == 1) store4(static_cast<__half*>(out) + off, v);
  else if (qdt == 2) store4(static_cast<__nv_bfloat16*>(out) + off, v);
  else store4(static_cast<float*>(out) + off, v);
}

template <int DH, int GT, int HB, typename CT>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const void* __restrict__ q, const CT* __restrict__ k,
    const CT* __restrict__ v, const int* __restrict__ kv_len,
    void* __restrict__ out, int qdt, int S, int H, int KV, int stages,
    long long sqb, long long skb, long long skt, long long svb,
    long long svt, float scale) {
  static_assert(HB == 1 || (HB == kWarps && GT == 1), "HB");
  constexpr int LPK = DH / 4;      // P V: lanes per V row, 4 floats each
  constexpr int KPW = 32 / LPK;    // P V: rows a warp covers per step
  // scores: LPS lanes per key, each holding QF float4s of every head's
  // query row in registers (at most 16 float4s); KPS keys a sub-run
  constexpr int LPS0 = GT * DH / 64 > 4 ? GT * DH / 64 : 4;
  constexpr int LPS = LPS0 < LPK ? LPS0 : LPK;
  constexpr int KPS = 32 / LPS, QF = LPK / LPS;
  constexpr int RW = HB * LPK;     // float4s of a staged row
  constexpr int TK = kTileFloats / (4 * RW);   // key rows per stage
  constexpr int STAGE = 2 * TK * RW;           // K then V, float4s
  constexpr int KW = HB == 1 ? kWarps : 1;     // warps across keys
  // keys a warp takes at once: 8 U, more where the group has few heads
  // (independent softmax chains), as far as a tile keeps KW warps busy
  constexpr int U0 = 4 / GT > 1 ? 4 / GT : 1, U1 = TK / (KW * 8);
  constexpr int KPI = 8 * (U0 < U1 ? U0 : U1), NS = KPI / KPS;
  static_assert(KPI > 0 && KPS % KPW == 0 && KPI % KPS == 0 &&
                    TK % (KW * KPI) == 0, "runs");
  constexpr int NH = HB * GT;      // query heads of the block
  // stages x STAGE float4s; after the last tile, the warps' partials
  extern __shared__ float4 smem4[];
  __shared__ float sm_m[kWarps][GT], sm_l[kWarps][GT];
  // the block's partial softmax, which the cluster's rank 0 reads
  __shared__ float blk_m[NH], blk_l[NH];
  __shared__ float4 blk_acc[NH * LPK];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int G = H / KV, n_gc = (G + GT - 1) / GT;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / n_gc * HB, g0 = (blockIdx.y % n_gc) * GT;
  const int ng = min(GT, G - g0);  // valid heads of each kv head's group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = HB == 1 ? warp : 0;         // this warp's key runs
  const int hw = HB == 1 ? 0 : warp;         // ... and kv head
  const int kq = lane / LPS, r = lane % LPS;     // score lanes
  const int kg = lane / LPK, c4 = lane % LPK;    // P V lanes
  // the row's valid keys, in even runs of a multiple of 8 over the
  // cluster (none longer than the host's keys_per_split, which sized the
  // ring): a short row keeps no block of its cluster waiting on another
  const int len = min(max(kv_len[b], 0), S);
  const int run = ((len + n_split - 1) / n_split + 7) / 8 * 8;
  const int s0 = split * run;
  const int n_keys = max(0, min(s0 + run, len) - s0);
  const int n_tiles = (n_keys + TK - 1) / TK;

  const CT* kb = k + b * skb + static_cast<long long>(kvh) * DH;
  const CT* vb = v + b * svb + static_cast<long long>(kvh) * DH;
  auto load = [&](int t) {       // tile t of the split into its stage
    float4* ks = smem4 + (t % stages) * STAGE;
    const int r0 = s0 + t * TK, rows = min(TK, n_keys - t * TK);
    if constexpr (sizeof(CT) == 4) {
      for (int idx = threadIdx.x; idx < rows * RW; idx += kThreads) {
        const int i = idx / RW, c = idx % RW, dst = slot<RW>(i, c);
        cp_async16_zfill(reinterpret_cast<float*>(ks + dst),
                         kb + (r0 + i) * skt + 4 * c, true);
        cp_async16_zfill(reinterpret_cast<float*>(ks + TK * RW + dst),
                         vb + (r0 + i) * svt + 4 * c, true);
      }
    } else {           // 8 half elements a load: float4 slots 2c, 2c + 1
      constexpr int RH = RW / 2;
      for (int idx = threadIdx.x; idx < rows * RH; idx += kThreads) {
        const int i = idx / RH, c = idx % RH;
        const int d0 = slot<RW>(i, 2 * c), d1 = slot<RW>(i, 2 * c + 1);
        float f[8];
        load16(kb + (r0 + i) * skt + 8 * c, f);
        ks[d0] = make_float4(f[0], f[1], f[2], f[3]);
        ks[d1] = make_float4(f[4], f[5], f[6], f[7]);
        load16(vb + (r0 + i) * svt + 8 * c, f);
        ks[TK * RW + d0] = make_float4(f[0], f[1], f[2], f[3]);
        ks[TK * RW + d1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  };
  for (int t = 0; t < stages; ++t) {    // the ring's first tiles, before
    if (t < n_tiles) load(t);             // anything waits on a load
    cp_async_commit();
  }

  // this lane's slices of the query rows of its warp's heads, scaled:
  // kv head kvh + hw, query heads g0 .. g0 + GT - 1 (zero past ng)
  float4 qr[GT][QF];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    const long long qrow =
        b * sqb + static_cast<long long>((kvh + hw) * G + g0 + h) * DH;
#pragma unroll
    for (int i = 0; i < QF; ++i) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (h < ng) t = load_q4(q, qdt, qrow + 4 * (r + LPS * i));
      qr[h][i] = make_float4(t.x * scale, t.y * scale, t.z * scale,
                             t.w * scale);
    }
  }
  float m[GT], l[GT];            // l: this lane's share of the sum
  float4 acc[GT];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.0f;
    acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < n_tiles; ++t) {
    wait_pending(stages - 1);     // tile t's copies have landed
    __syncthreads();
    const float4* ks = smem4 + (t % stages) * STAGE;
    const float4* vs = ks + TK * RW;
    const int nv = min(TK, n_keys - t * TK);
    for (int j0 = kw * KPI; j0 < nv; j0 += KW * KPI) {
      bool valid[NS];
      float s[NS][GT];
#pragma unroll
      for (int u = 0; u < NS; ++u) {
        valid[u] = j0 + u * KPS + kq < nv;
#pragma unroll
        for (int h = 0; h < GT; ++h) s[u][h] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < QF; ++i) {
        const int c = hw * LPK + r + LPS * i;
#pragma unroll
        for (int u = 0; u < NS; ++u) {   // rows < TK: TK is a multiple
          const float4 kf = ks[slot<RW>(j0 + u * KPS + kq, c)];  // of KPI
#pragma unroll
          for (int h = 0; h < GT; ++h) {
            s[u][h] = fmaf(qr[h][i].x, kf.x, s[u][h]);
            s[u][h] = fmaf(qr[h][i].y, kf.y, s[u][h]);
            s[u][h] = fmaf(qr[h][i].z, kf.z, s[u][h]);
            s[u][h] = fmaf(qr[h][i].w, kf.w, s[u][h]);
          }
        }
      }
      // every head of the group, also those past ng (their q rows are
      // zero and their outputs never leave the block)
      float p[NS][GT];
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          float sc = s[u][h];
#pragma unroll
          for (int off = 1; off < LPS; off <<= 1)
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
          p[u][h] = valid[u] ? sc : -INFINITY;
          mx = fmaxf(mx, p[u][h]);
        }
#pragma unroll
        for (int off = LPS; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float mn = fmaxf(m[h], mx);    // finite: key j0 is valid
        const float alpha = expf(m[h] - mn);  // 0 while m[h] is -inf
        float ps = 0.0f;
#pragma unroll
        for (int u = 0; u < NS; ++u) {
          p[u][h] = valid[u] ? expf(p[u][h] - mn) : 0.0f;
          ps += p[u][h];
        }
        l[h] = fmaf(l[h], alpha, r == 0 ? ps : 0.0f);
        acc[h].x *= alpha;
        acc[h].y *= alpha;
        acc[h].z *= alpha;
        acc[h].w *= alpha;
        m[h] = mn;
      }
#pragma unroll
      for (int jj = 0; jj < KPI; jj += KPW) {
        const int row = j0 + jj + kg, src = (jj % KPS + kg) * LPS;
        const float4 vf = row < nv ? vs[slot<RW>(row, hw * LPK + c4)]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int h = 0; h < GT; ++h) {
          const float pj = __shfl_sync(0xffffffffu, p[jj / KPS][h], src);
          acc[h].x = fmaf(pj, vf.x, acc[h].x);
          acc[h].y = fmaf(pj, vf.y, acc[h].y);
          acc[h].z = fmaf(pj, vf.z, acc[h].z);
          acc[h].w = fmaf(pj, vf.w, acc[h].w);
        }
      }
    }
    __syncthreads();              // the stage is free for tile t + stages
    if (t + stages < n_tiles) load(t + stages);
    cp_async_commit();
  }

  // each warp's partial per head: the lanes' sums, and the KPW row
  // groups' outputs (one max, so a plain sum); the staging ring is free
  // now and holds them
  float4* sm_acc = smem4;         // [kWarps][GT][LPK]
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    const float lw = warp_sum(l[h]);
    float4 a = acc[h];
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) {
      a.x += __shfl_xor_sync(0xffffffffu, a.x, off);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, off);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, off);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, off);
    }
    if (lane < LPK) sm_acc[(warp * GT + h) * LPK + lane] = a;
    if (lane == 0) {
      sm_m[warp][h] = m[h];
      sm_l[warp][h] = lw;
    }
  }
  __syncthreads();
  // the block's partial per query head: the KW warps that served it
  for (int idx = threadIdx.x; idx < NH * LPK; idx += kThreads) {
    const int hs = idx / LPK, c = idx % LPK, h = hs % GT;
    if (h >= ng) continue;
    float mm = -INFINITY, ll = 0.0f;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const int w = HB == 1 ? j : hs / GT;
      merge(mm, ll, aa, sm_m[w][h], sm_l[w][h],
            sm_acc[(w * GT + h) * LPK + c]);
    }
    blk_acc[idx] = aa;
    if (c == 0) {
      blk_m[hs] = mm;
      blk_l[hs] = ll;
    }
  }

  // merge the splits of the cluster: rank 0 reads every block's partial
  // through distributed shared memory and writes the output; the second
  // sync keeps every block's shared memory alive until it has
  cluster.sync();
  if (split == 0) {
    for (int idx = threadIdx.x; idx < NH * LPK; idx += kThreads) {
      const int hs = idx / LPK, c = idx % LPK;
      if (hs % GT >= ng) continue;
      float pm[kMaxCluster], pl[kMaxCluster];
      float4 pa[kMaxCluster];
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk) {   // all loads in flight
        if (rk < n_split) {
          pm[rk] = cluster.map_shared_rank(&blk_m[0], rk)[hs];
          pl[rk] = cluster.map_shared_rank(&blk_l[0], rk)[hs];
          pa[rk] = cluster.map_shared_rank(&blk_acc[0], rk)[idx];
        }
      }
      float mm = -INFINITY, ll = 0.0f;
      float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk)
        if (rk < n_split) merge(mm, ll, aa, pm[rk], pl[rk], pa[rk]);
      const float inv = ll > 0.0f ? 1.0f / ll : 0.0f;
      const long long row = static_cast<long long>(b) * H +
                            (kvh + hs / GT) * G + g0 + hs % GT;
      store_o4(out, qdt, row * DH + 4 * c,
               make_float4(aa.x * inv, aa.y * inv, aa.z * inv, aa.w * inv));
    }
  }
  cluster.sync();
}

template <int DH, int GT, int HB, typename CT>
cudaError_t launch(const void* q, const CT* k, const CT* v,
                   const int* kv_len, void* out, int qdt, int B, int S, int H,
                   int KV, int n_split, int keys_per_split, long long sqb,
                   long long skb, long long skt, long long svb,
                   long long svt, float scale, cudaStream_t stream) {
  constexpr int TK = kTileFloats / (HB * DH);
  const int n_gc = (H / KV + GT - 1) / GT;
  const int tiles = repro_ceil_div(keys_per_split, TK);
  const int stages = tiles < kMaxStages ? tiles : kMaxStages;
  const size_t smem = static_cast<size_t>(stages) * 2 * kTileFloats *
                      sizeof(float);
  auto* kernel = decode_attention_kernel<DH, GT, HB, CT>;
  cudaError_t e = repro_allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, KV / HB * n_gc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, q, k, v, kv_len, out, qdt, S, H, KV,
                         stages, sqb, skb, skt, svb, svt, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The block's heads: with one query head per kv head and KV a multiple
// of 4, four kv heads (HB = 4); else one kv head and a group of GT query
// heads, G rounded up to 1, 2, 4 or 8 (larger groups take several blocks
// of 8).  ops.py's plan counts blocks the same way.
template <int DH, typename CT>
cudaError_t launch_g(const void* q, const CT* k, const CT* v,
                     const int* kv_len, void* out, int qdt, int B, int S,
                     int H, int KV, int n_split, int keys_per_split,
                     long long sqb, long long skb, long long skt,
                     long long svb, long long svt, float scale,
                     cudaStream_t stream) {
  const int G = H / KV;
#define REPRO_DECODE_LAUNCH(GT, HB)                                         \
  return launch<DH, GT, HB>(q, k, v, kv_len, out, qdt, B, S, H, KV,       \
                            n_split, keys_per_split, sqb, skb, skt, svb,  \
                            svt, scale, stream)
  if (G == 1 && KV % kWarps == 0) REPRO_DECODE_LAUNCH(1, kWarps);
  if (G == 1) REPRO_DECODE_LAUNCH(1, 1);
  if (G == 2) REPRO_DECODE_LAUNCH(2, 1);
  if (G <= 4) REPRO_DECODE_LAUNCH(4, 1);
  REPRO_DECODE_LAUNCH(8, 1);
#undef REPRO_DECODE_LAUNCH
}

}  // namespace

// q, out: (B, 1, H, Dh) with dense heads (q's batch stride sqb), of type
// code qdt (0 float32, 1 fp16, 2 bf16); k/v: (B, S, KV, Dh) of the
// entry's type, with dense heads, batch and token strides given.  The
// keys split into n_split (1..8) runs of keys_per_split, which must
// cover [0, S) with no run wholly past S.  Every pointer and stride must
// allow 16-byte loads of the cache and 4-element loads of q (the wrapper
// checks).
template <typename CT>
int entry(const void* q, const CT* k, const CT* v, const int* kv_len,
          void* out, int qdt, int B, int S, int H, int KV, int Dh,
          int n_split, int keys_per_split, long long sqb, long long skb,
          long long skt, long long svb, long long svt, float scale,
          int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (KV <= 0 || H % KV || n_split < 1 || n_split > kMaxCluster ||
      keys_per_split < 1 || qdt < 0 || qdt > 2 ||
      static_cast<long long>(n_split) * keys_per_split < S ||
      (S > 0 && static_cast<long long>(n_split - 1) * keys_per_split >= S))
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
#define REPRO_DECODE_DH(DH)                                                 \
  case DH:                                                                  \
    return launch_g<DH>(q, k, v, kv_len, out, qdt, B, S, H, KV, n_split,    \
                        keys_per_split, sqb, skb, skt, svb, svt, scale, st)
    REPRO_DECODE_DH(16);
    REPRO_DECODE_DH(32);
    REPRO_DECODE_DH(64);
    REPRO_DECODE_DH(128);
#undef REPRO_DECODE_DH
    default: return cudaErrorInvalidValue;
  }
}

#define REPRO_DECODE_ENTRY(T, SUF)                                          \
  REPRO_EXPORT int decode_attention_##SUF(                                  \
      const void* q, const T* k, const T* v, const int* kv_len, void* out,  \
      int qdt, int B, int S, int H, int KV, int Dh, int n_split,            \
      int keys_per_split, long long sqb, long long skb, long long skt,      \
      long long svb, long long svt, float scale, int device, void* stream) {\
    return entry<T>(q, k, v, kv_len, out, qdt, B, S, H, KV, Dh, n_split,    \
                    keys_per_split, sqb, skb, skt, svb, svt, scale, device, \
                    stream);                                                \
  }

REPRO_FLOAT_TYPES(REPRO_DECODE_ENTRY)

// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060),
// float32 accuracy on the TF32 tensor cores.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py: ssd_scan_kernel
// (_ssd_kernel) together with its wrapper's prologue (ops.py: xbar =
// x * dt, dA = dt * A, the zero pad of T to a chunk multiple).  x:
// (b, T, H, P) and B/C: (b, T, G, N), read in place through their batch
// and token strides (column views of the conv output need no copy); dt:
// (b, T, H); A: (H,); s0: (b, H, N, P) or null for zeros.  Writes y
// (b, T, H, P) and the final state (b, H, N, P).  Head h reads group
// h / (H / G).  For each chunk of Q rows, with cum the inclusive prefix
// sum of dt * A over the chunk:
//   y_i = exp(cum_i) C_i . S
//         + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xbar_j
//   S   = exp(cum_last) S  +  sum_j B_j (exp(cum_last - cum_j) xbar_j)^T
// The last chunk of a ragged T stops at row T - 1, which gives what the
// reference's dt = 0 padding gives (padded rows leave S unchanged).
//
// Bound on the H100: operations.  At the mamba2-370m serving shape
// (b 8, T 1024, H 32, P 64, N 128, Q 256) the chunked form needs ~12.1
// GFLOP (the C.B scores once per group), 3 x 12.1 GFLOP of TF32 products
// at float32 accuracy: 73 us at 495 TFLOP/s, above the 45 us that its
// ~152 MB of inputs and outputs take at 3.35 TB/s.
//
// Design: the SSD paper's chunk-parallel split (section 6), in four
// kernels on the caller's stream, one entry point.  Every product runs
// as mma.sync m16n8k8 tiles in the 3xTF32 scheme (tf32_mma.cuh), 4 warps a
// block; shared rows are padded so that every fragment load of a warp
// hits 32 distinct banks.  The caller's scratch buffer
// holds the scores (b, nc, G, Qp, Qp), the chunk states (b, nc, H, N, P)
// and the prefix sums (b, H, nc, Qp), Qp = Q rounded up to 64: ~44 MB at
// the mamba2 shape, most of it held by the 50 MB L2 between kernels.
//  1. scores: C_i . B_j for every 64 x 64 tile at or below the diagonal,
//     once per (batch row, chunk, group) and shared by the group's heads
//     (the mamba2 and zamba2 configs have one group for 32 / 64 heads).
//  2. chunk states, per (batch row, chunk, head, 64 columns of P), all
//     chunks in parallel: S_c = B^T (w . x) over the chunk's rows, w_j =
//     exp(cum_last - cum_j) dt_j folded into the A fragments; the B and x
//     tiles (32 rows) are double-buffered cp.async copies.  Its slice-0
//     block also writes the chunk's prefix sums for the later kernels.
//  3. state passing, per (batch row, head), in sequence over the chunks:
//     S_prev[c] = the state entering chunk c (written over S_c in place),
//     S = exp(cum_last) S + S_c; the last S is the final state.  Four
//     entries a thread, four chunks' loads in flight before the chain.
//  4. outputs, per (batch row, chunk, head, 64 rows from r, 64 columns of
//     P), all chunks in parallel.  For the columns j < r (and the carried
//     state) exp(cum_i - cum_j) = u_i v_j with u_i = exp(cum_i - cum_r)
//     and v_j = exp(cum_r - cum_j), each at most 1: exp(cum_r) C_i .
//     S_prev and the score tiles left of the diagonal times v_j dt_j
//     (one exp a column, not one a score) gather in the accumulators,
//     which are then scaled by u_i.  The diagonal tile forms (C.B)_ij
//     exp(cum_i - cum_j) dt_j in registers, evaluated only where j <= i:
//     above the diagonal the exp overflows, and inf * 0 would give NaN.
//     Score and x tiles are double-buffered; the carried-state operands
//     share their shared memory (three blocks an SM).
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128, kT = 64;  // 4 warps; 64-row tiles
constexpr int kTS = 32;                 // the chunk states' row tiles
constexpr int kPassThreads = 256;

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *s0;
  float *y, *s_fin;
  float *cb, *st, *cum;  // scratch: scores, chunk states, prefix sums
  int T, H, G, N, P, Q, Qp, nc;
  long long sxb, sxt, sdb, sdt, sbb, sbt, scb, sct;
  bool vec;  // x, B and C allow 16-byte copies
};

__device__ __forceinline__ long long cb_base(const Args& a, int b, int c,
                                             int g) {
  return ((static_cast<long long>(b) * a.nc + c) * a.G + g) *
         static_cast<long long>(a.Qp) * a.Qp;
}

__device__ __forceinline__ long long st_base(const Args& a, int b, int c,
                                             int h) {
  return ((static_cast<long long>(b) * a.nc + c) * a.H + h) *
         static_cast<long long>(a.N) * a.P;
}

__device__ __forceinline__ long long cum_base(const Args& a, int bhead,
                                              int c) {
  return (static_cast<long long>(bhead) * a.nc + c) * a.Qp;
}

// ---- 1. scores ----------------------------------------------------------
// Block (b * G + g, tile pair, chunk): the 64 x 64 tile (it, jt), jt <= it,
// of C_i . B_j, rows and columns past the chunk's end zero.
template <int N>
__global__ void __launch_bounds__(kThreads) ssd_scores_kernel(const Args a) {
  constexpr int LD = N + 4, NK = N / 8;
  extern __shared__ __align__(16) float sm[];
  float* Cs = sm;
  float* Bs = sm + kT * LD;
  const int b = blockIdx.x / a.G, g = blockIdx.x % a.G, c = blockIdx.z;
  int it = 0, jt = blockIdx.y;
  while (jt > it) jt -= ++it;
  const int t0 = c * a.Q, Qc = min(a.Q, a.T - t0);
  const int i0 = it * kT, j0 = jt * kT;
  if (i0 >= Qc) return;
  stage_rows<N>(Cs, LD,
                a.Cm + b * a.scb + static_cast<long long>(t0 + i0) * a.sct +
                    g * N,
                a.sct, kT, Qc - i0, a.vec);
  stage_rows<N>(Bs, LD,
                a.Bm + b * a.sbb + static_cast<long long>(t0 + j0) * a.sbt +
                    g * N,
                a.sbt, kT, Qc - j0, a.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  float s[8][4];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[jn][e] = 0.0f;
  const float* cw = Cs + (16 * warp + gq) * LD + tq;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(cw[8 * kk], ah[0], al[0]);
    split_tf32(cw[8 * kk + 8 * LD], ah[1], al[1]);
    split_tf32(cw[8 * kk + 4], ah[2], al[2]);
    split_tf32(cw[8 * kk + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float* bp = Bs + (8 * jn + gq) * LD + 8 * kk + tq;
      uint32_t bh[2], bl[2];
      split_tf32(bp[0], bh[0], bl[0]);
      split_tf32(bp[4], bh[1], bl[1]);
      mma_3xtf32_split(s[jn], ah, al, bh, bl);
    }
  }
  float* out = a.cb + cb_base(a, b, c, g) +
               static_cast<long long>(i0 + 16 * warp + gq) * a.Qp + j0 +
               2 * tq;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    *reinterpret_cast<float2*>(out + 8 * jn) = make_float2(s[jn][0], s[jn][1]);
    *reinterpret_cast<float2*>(out + 8 * a.Qp + 8 * jn) =
        make_float2(s[jn][2], s[jn][3]);
  }
}

// ---- 2. chunk states ----------------------------------------------------
// The chunk's dt (0 past its end) and inclusive prefix sums of dt * A
// into shared memory: one warp scans 32 rows at a time, carrying the sum.
__device__ __forceinline__ void chunk_cum(const Args& a, int b, int h,
                                          int t0, int Qc, float* dts,
                                          float* cum) {
  const int n = (Qc + 31) / 32 * 32;
  const float* dtb = a.dt + b * a.sdb + h;
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    dts[r] = r < Qc ? dtb[static_cast<long long>(t0 + r) * a.sdt] : 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float ah = a.A[h];
    float carry = 0.0f;
    for (int base = 0; base < n; base += 32) {
      float v = dts[base + lane] * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      v += carry;
      cum[base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// Block (b * H + h) * (P / PS) + slice, chunk): the chunk's local state
// S_c[n][p] = sum_j B_j[n] w_j x_j[p] for the slice's PS columns, over
// 32-row tiles of the chunk (56 KB of shared memory at N 128, against 109
// KB for 64-row tiles).  Warp w owns the 16-row tiles w, w + 4, ... of N.
template <int N, int PS>
__global__ void __launch_bounds__(kThreads) ssd_states_kernel(const Args a) {
  constexpr int LDB = N + 8, LDX = PS + 8, MT = N / 16, MTW = (MT + 3) / 4,
                NT = PS / 8, STAGE = kTS * (LDB + LDX);
  extern __shared__ __align__(16) float sm[];
  float* dts = sm + 2 * STAGE;
  float* cum = dts + a.Qp;
  float* w = cum + a.Qp;
  const int slices = a.P / PS;
  const int bhead = blockIdx.x / slices, p0 = (blockIdx.x % slices) * PS;
  const int b = bhead / a.H, h = bhead % a.H, g = h / (a.H / a.G);
  const int c = blockIdx.y;
  const int t0 = c * a.Q, Qc = min(a.Q, a.T - t0);
  const int nt = (Qc + kTS - 1) / kTS;
  const float* bb = a.Bm + b * a.sbb + static_cast<long long>(t0) * a.sbt +
                    g * N;
  const float* xb = a.x + b * a.sxb + static_cast<long long>(t0) * a.sxt +
                    static_cast<long long>(h) * a.P + p0;
  stage_rows<N>(sm, LDB, bb, a.sbt, kTS, Qc, a.vec);
  stage_rows<PS>(sm + kTS * LDB, LDX, xb, a.sxt, kTS, Qc, a.vec);
  cp_async_commit();

  chunk_cum(a, b, h, t0, Qc, dts, cum);
  const float cl = cum[Qc - 1];
  for (int r = threadIdx.x; r < a.Qp; r += blockDim.x) {
    w[r] = r < Qc ? expf(cl - cum[r]) * dts[r] : 0.0f;
    if (p0 == 0) a.cum[cum_base(a, bhead, c) + r] = r < Qc ? cum[r] : cl;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[MTW][NT][4];
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

  for (int jt = 0; jt < nt; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with jt - 1
    if (jt + 1 < nt) {
      const int j1 = (jt + 1) * kTS;
      float* nxt = sm + ((jt + 1) & 1) * STAGE;
      stage_rows<N>(nxt, LDB, bb + j1 * a.sbt, a.sbt, kTS, Qc - j1, a.vec);
      stage_rows<PS>(nxt + kTS * LDB, LDX, xb + j1 * a.sxt, a.sxt, kTS,
                     Qc - j1, a.vec);
    }
    cp_async_commit();
    if (warp >= MT) continue;  // N < 64: idle warps
    const float* Bs = sm + (jt & 1) * STAGE;
    const float* Xs = Bs + kTS * LDB;
    const float* wj = w + jt * kTS;
#pragma unroll
    for (int kk = 0; kk < kTS / 8; ++kk) {
      const int j = 8 * kk + tq;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split_tf32(Xs[j * LDX + 8 * n + gq], bh[n][0], bl[n][0]);
        split_tf32(Xs[(j + 4) * LDX + 8 * n + gq], bh[n][1], bl[n][1]);
      }
      const float w0 = wj[j], w1 = wj[j + 4];
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
        const int mi = warp + 4 * m;
        if (mi >= MT) break;
        const float* bp = Bs + j * LDB + 16 * mi + gq;
        uint32_t ah[4], al[4];
        split_tf32(bp[0] * w0, ah[0], al[0]);
        split_tf32(bp[8] * w0, ah[1], al[1]);
        split_tf32(bp[4 * LDB] * w1, ah[2], al[2]);
        split_tf32(bp[4 * LDB + 8] * w1, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma_3xtf32_split(acc[m][n], ah, al, bh[n], bl[n]);
      }
    }
  }
  cp_async_wait<0>();

  float* out = a.st + st_base(a, b, c, h) + p0 + 2 * tq;
#pragma unroll
  for (int m = 0; m < MTW; ++m) {
    const int mi = warp + 4 * m;
    if (mi >= MT) break;
    const long long r0 = static_cast<long long>(16 * mi + gq) * a.P;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<float2*>(out + r0 + 8 * n) =
          make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(out + r0 + 8 * a.P + 8 * n) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  }
}

// ---- 3. state passing ---------------------------------------------------
// Block (b * H + h, slice of N * P): four state entries a thread, the
// chunks in sequence; S_c is replaced by the state entering chunk c.
__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(
    const Args a) {
  const int bhead = blockIdx.x, b = bhead / a.H, h = bhead % a.H;
  const long long np = static_cast<long long>(a.N) * a.P;
  const long long e =
      4 * (static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x);
  if (e >= np) return;
  float4 s = a.s0 ? *reinterpret_cast<const float4*>(a.s0 + bhead * np + e)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  constexpr int kAhead = 4;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < a.nc; c0 += kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c >= a.nc) break;
      const int Qc = min(a.Q, a.T - c * a.Q);
      dec[u] = expf(a.cum[cum_base(a, bhead, c) + Qc - 1]);
      loc[u] = *reinterpret_cast<const float4*>(a.st + st_base(a, b, c, h) +
                                                e);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c >= a.nc) break;
      *reinterpret_cast<float4*>(a.st + st_base(a, b, c, h) + e) = s;
      s = make_float4(fmaf(dec[u], s.x, loc[u].x), fmaf(dec[u], s.y, loc[u].y),
                      fmaf(dec[u], s.z, loc[u].z), fmaf(dec[u], s.w, loc[u].w));
    }
  }
  *reinterpret_cast<float4*>(a.s_fin + bhead * np + e) = s;
}

// ---- 4. outputs ---------------------------------------------------------
// Block ((b * H + h) * (P / PS) + slice, row tile, chunk): 64 rows x PS
// columns of y; warp w owns rows 16w .. 16w + 15 of the tile.
template <int N, int PS>
__global__ void __launch_bounds__(kThreads) ssd_outputs_kernel(const Args a) {
  constexpr int LDC = N + 4, LDS = PS + 8, LDG = kT + 4, LDX = PS + 8,
                NT = PS / 8, NK = N / 8, STAGE = kT * (LDG + LDX),
                CARRY = kT * LDC + N * LDS,
                REGION = CARRY > 2 * STAGE ? CARRY : 2 * STAGE;
  extern __shared__ __align__(16) float sm[];
  float* cum = sm + REGION;
  float* dts = cum + a.Qp;
  float* vj = dts + a.Qp;
  const int slices = a.P / PS;
  const int bhead = blockIdx.x / slices, p0 = (blockIdx.x % slices) * PS;
  const int b = bhead / a.H, h = bhead % a.H, g = h / (a.H / a.G);
  const int it = blockIdx.y, c = blockIdx.z;
  const int t0 = c * a.Q, Qc = min(a.Q, a.T - t0), i0 = it * kT;
  if (i0 >= Qc) return;
  const bool carried = c > 0 || a.s0 != nullptr;

  if (carried) {
    stage_rows<N>(sm, LDC,
                  a.Cm + b * a.scb + static_cast<long long>(t0 + i0) * a.sct +
                      g * N,
                  a.sct, kT, Qc - i0, a.vec);
    stage_rows<PS>(sm + kT * LDC, LDS, a.st + st_base(a, b, c, h) + p0, a.P,
                   N, N, true);
  }
  cp_async_commit();
  const float* dtb = a.dt + b * a.sdb + h;
  for (int r = threadIdx.x; r < a.Qp; r += blockDim.x) {
    cum[r] = a.cum[cum_base(a, bhead, c) + r];
    dts[r] = r < Qc ? dtb[static_cast<long long>(t0 + r) * a.sdt] : 0.0f;
  }
  __syncthreads();
  // the columns left of the tile: v_j = exp(cum_i0 - cum_j) dt_j <= dt_j
  for (int r = threadIdx.x; r < i0; r += blockDim.x)
    vj[r] = expf(cum[i0] - cum[r]) * dts[r];
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ra = 16 * warp + gq, rb = ra + 8;  // the thread's rows
  const int ia = i0 + ra, ib = i0 + rb;        // ... in the chunk
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  // Rows i of the tile and columns j < i0 (the carried state counts as
  // j = -1) have exp(cum_i - cum_j) = u_i v_j / dt_j, u_i = exp(cum_i -
  // cum_i0): both factors are at most 1.  Their terms gather in acc, which
  // is scaled by u_i before the diagonal tile adds its own.
  if (carried) {  // exp(cum_i0) C_i . S_prev
    const float* Cs = sm;
    const float* Ss = sm + kT * LDC;
    const float* cw = Cs + ra * LDC + tq;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(cw[8 * kk], ah[0], al[0]);
      split_tf32(cw[8 * kk + 8 * LDC], ah[1], al[1]);
      split_tf32(cw[8 * kk + 4], ah[2], al[2]);
      split_tf32(cw[8 * kk + 8 * LDC + 4], ah[3], al[3]);
      const float* sp = Ss + (8 * kk + tq) * LDS + gq;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(sp[8 * n], bh[0], bl[0]);
        split_tf32(sp[4 * LDS + 8 * n], bh[1], bl[1]);
        mma_3xtf32_split(acc[n], ah, al, bh, bl);
      }
    }
    const float e0 = expf(cum[i0]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= e0;
    __syncthreads();  // the score and x tiles reuse this shared memory
  }

  // the chunk's own rows j <= i, one 64-column score tile at a time
  const float* cbb = a.cb + cb_base(a, b, c, g) +
                     static_cast<long long>(i0) * a.Qp;
  const float* xb = a.x + b * a.sxb + static_cast<long long>(t0) * a.sxt +
                    static_cast<long long>(h) * a.P + p0;
  stage_rows<kT>(sm, LDG, cbb, a.Qp, kT, kT, true);
  stage_rows<PS>(sm + kT * LDG, LDX, xb, a.sxt, kT, Qc, a.vec);
  cp_async_commit();
  const float ca = cum[ia], cb = cum[ib];
  const bool va = ia < Qc, vb = ib < Qc;
  for (int jt = 0; jt <= it; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with jt - 1
    if (jt < it) {
      const int j1 = (jt + 1) * kT;
      float* nxt = sm + ((jt + 1) & 1) * STAGE;
      stage_rows<kT>(nxt, LDG, cbb + j1, a.Qp, kT, kT, true);
      stage_rows<PS>(nxt + kT * LDG, LDX, xb + j1 * a.sxt, a.sxt, kT,
                     Qc - j1, a.vec);
    }
    cp_async_commit();
    const float* Gs = sm + (jt & 1) * STAGE;
    const float* Xs = Gs + kT * LDG;
    const int j0 = jt * kT;
    if (jt == it) {  // u_i on what came before the diagonal tile
      const float ua = expf(ca - cum[i0]), ub = expf(cb - cum[i0]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= ua;
        acc[n][1] *= ua;
        acc[n][2] *= ub;
        acc[n][3] *= ub;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int jl = 8 * kk + tq, ja = j0 + jl, jb = ja + 4;
      const float* gp = Gs + ra * LDG + jl;
      float m0, m1, m2, m3;
      if (jt < it) {  // (C.B)_ij v_j
        const float v0 = vj[ja], v1 = vj[jb];
        m0 = gp[0] * v0;
        m1 = gp[8 * LDG] * v0;
        m2 = gp[4] * v1;
        m3 = gp[8 * LDG + 4] * v1;
      } else {  // (C.B)_ij exp(cum_i - cum_j) dt_j, only where j <= i
        m0 = va && ja <= ia ? gp[0] * expf(ca - cum[ja]) * dts[ja] : 0.0f;
        m1 = vb && ja <= ib ? gp[8 * LDG] * expf(cb - cum[ja]) * dts[ja]
                            : 0.0f;
        m2 = va && jb <= ia ? gp[4] * expf(ca - cum[jb]) * dts[jb] : 0.0f;
        m3 = vb && jb <= ib ? gp[8 * LDG + 4] * expf(cb - cum[jb]) * dts[jb]
                            : 0.0f;
      }
      uint32_t ah[4], al[4];
      split_tf32(m0, ah[0], al[0]);
      split_tf32(m1, ah[1], al[1]);
      split_tf32(m2, ah[2], al[2]);
      split_tf32(m3, ah[3], al[3]);
      const float* xp = Xs + jl * LDX + gq;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(xp[8 * n], bh[0], bl[0]);
        split_tf32(xp[4 * LDX + 8 * n], bh[1], bl[1]);
        mma_3xtf32_split(acc[n], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

  const long long syt = static_cast<long long>(a.H) * a.P;
  float* yb = a.y + (static_cast<long long>(b) * a.T + t0) * syt +
              static_cast<long long>(h) * a.P + p0 + 2 * tq;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (va)
      *reinterpret_cast<float2*>(yb + ia * syt + 8 * n) =
          make_float2(acc[n][0], acc[n][1]);
    if (vb)
      *reinterpret_cast<float2*>(yb + ib * syt + 8 * n) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

template <int N, int PS>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  const int ntq = a.Qp / kT, slices = a.P / PS;
  const size_t f = sizeof(float);
  const size_t smem1 = f * 2 * kT * (N + 4);
  const size_t smem2 = f * (2 * kTS * ((N + 8) + (PS + 8)) + 3 * a.Qp);
  const size_t carry = static_cast<size_t>(kT) * (N + 4) + N * (PS + 8);
  const size_t stages = 2 * kT * ((kT + 4) + (PS + 8));
  const size_t smem4 = f * ((carry > stages ? carry : stages) + 3 * a.Qp);
  cudaError_t e = repro_allow_smem(ssd_scores_kernel<N>, smem1);
  if (e == cudaSuccess) e = repro_allow_smem(ssd_states_kernel<N, PS>, smem2);
  if (e == cudaSuccess)
    e = repro_allow_smem(ssd_outputs_kernel<N, PS>, smem4);
  if (e != cudaSuccess) return e;
  ssd_scores_kernel<N><<<dim3(B * a.G, ntq * (ntq + 1) / 2, a.nc), kThreads,
                         smem1, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_states_kernel<N, PS><<<dim3(B * a.H * slices, a.nc), kThreads, smem2,
                             st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int per = 4 * kPassThreads;
  ssd_pass_kernel<<<dim3(B * a.H, (N * a.P + per - 1) / per), kPassThreads,
                    0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_outputs_kernel<N, PS><<<dim3(B * a.H * slices, ntq, a.nc), kThreads,
                              smem4, st>>>(a);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const Args& a, int B, cudaStream_t st) {
  switch (a.P < 64 ? a.P : 64) {
    case 16: return launch<N, 16>(a, B, st);
    case 32: return launch<N, 32>(a, B, st);
    case 64: return launch<N, 64>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Floats of scratch a call needs: the scores (B, nc, G, Qp, Qp), the
// chunk states (B, nc, H, N, P) and the prefix sums (B, H, nc, Qp), with
// nc = ceil(T / Q) and Qp = Q rounded up to a multiple of 64 (the
// wrapper's ops.scratch_floats).
long long scratch_floats(int B, int T, int H, int G, int N, int P, int Q) {
  const long long nc = (T + Q - 1) / Q, Qp = (Q + kT - 1) / kT * kT;
  return B * nc * (G * Qp * Qp + static_cast<long long>(H) * N * P + H * Qp);
}

}  // namespace

// x: (B, T, H, P) with dense heads (batch / token strides sxb, sxt); dt:
// (B, T, H) with dense heads (sdb, sdt); A: (H,); Bm / Cm: (B, T, G, N)
// with dense groups (sbb, sbt / scb, sct); s0: (B, H, N, P) contiguous or
// null; y: (B, T, H, P) and s_fin: (B, H, N, P) contiguous; scratch:
// n_scratch floats, 16-byte aligned, at least scratch_floats(...).  Q
// is the chunk length; N one of 16, 32, 64, 128; P 16, 32 or a multiple
// of 64.
REPRO_EXPORT int ssd_scan_f32(
    const float* x, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* s0, float* y, float* s_fin, float* scratch,
    long long n_scratch, int B, int T, int H, int G, int N, int P, int Q,
    long long sxb, long long sxt, long long sdb, long long sdt, long long sbb,
    long long sbt, long long scb, long long sct, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (G <= 0 || H % G || Q <= 0 || (P > 64 && P % 64))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  const long long need = scratch_floats(B, T, H, G, N, P, Q);
  if (n_scratch < need || !aligned16(scratch)) return cudaErrorInvalidValue;
  const int nc = (T + Q - 1) / Q, Qp = (Q + kT - 1) / kT * kT;
  const long long sq = static_cast<long long>(Qp) * Qp;
  float* st_buf = scratch + static_cast<long long>(B) * nc * G * sq;
  float* cum_buf = st_buf + static_cast<long long>(B) * nc * H * N * P;
  const bool vec = aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   (sxb | sxt | sbb | sbt | scb | sct) % 4 == 0;
  const Args a{x,   dt,  A,   Bm,     Cm,      s0, y, s_fin, scratch, st_buf,
               cum_buf, T, H, G, N, P, Q, Qp, nc, sxb, sxt, sdb, sdt, sbb,
               sbt, scb, sct, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch_n<16>(a, B, st);
    case 32: return launch_n<32>(a, B, st);
    case 64: return launch_n<64>(a, B, st);
    case 128: return launch_n<128>(a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060),
// float32.
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
// GFLOP of float32 FMA (the C.B scores once per group; 0.18 ms at 67
// TFLOP/s) against ~152 MB of inputs and outputs (45 us at 3.35 TB/s).
// Design, simple first.  The TPU kernel's sequential chunk grid axis,
// which carries the state in VMEM scratch, becomes a loop over the
// chunks inside one block.  A block of 256 threads owns one (batch row,
// head, slice of up to 64 columns of P): the state columns are
// independent, so slices never communicate.  It keeps its (N, PS) state
// in shared memory and walks the chunk in tiles of 32 rows: a C tile,
// then for every B / xbar tile at or left of the diagonal the 32 x 32
// scores (2 x 2 per thread, float4 reads over N) masked to j <= i,
// then the tile's 32 x PS outputs (2 x PS/16 per thread).  The decay is
// evaluated only where j <= i: exp(cum_i - cum_j) is huge above the
// diagonal, and a product with a masked zero would give inf * 0 = NaN.
// The state update keeps N/16 x PS/16 state entries per thread in
// registers.  Scores are recomputed by every head of a group (sharing
// them is later work).  Plain float32 FMA, no TF32: parity needs it.
// Shared memory: the state, two tiles of 32 rows of N + 4 floats (an
// odd number of 16-byte units, so float4 reads of 8 rows hit 8 bank
// groups), an xbar tile, the score tile and the per-row dt and cum:
// ~79 KB at N 128, PS 64, Q 256, above the 48 KB static limit, so the
// launch raises the dynamic limit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256, kTQ = 32, kGS = kTQ + 2;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// kTQ rows of N floats from src rows t, t + 1, ... (row stride st) into
// dst (row stride N + 4); rows at or past `valid` are zeros.
template <int N>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int t, int valid, long long st) {
  for (int e = threadIdx.x; e < kTQ * N; e += kThreads) {
    const int r = e / N, n = e % N;
    dst[r * (N + 4) + n] = r < valid ? src[(t + r) * st + n] : 0.0f;
  }
}

template <int N, int PS>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_fin, int T, int H, int G,
    int P, int Q, long long sxb, long long sxt, long long sdb,
    long long sdt, long long sbb, long long sbt, long long scb,
    long long sct) {
  constexpr int NS = N + 4;        // B / C tile row stride
  constexpr int CP = PS / 16;      // output columns a thread owns
  constexpr int NR = N / 16;       // state rows a thread owns (update)
  extern __shared__ float4 sm4[];
  float* S = reinterpret_cast<float*>(sm4);   // (N, PS) state
  float* Cs = S + N * PS;                      // (kTQ, NS) C rows i
  float* Bs = Cs + kTQ * NS;                   // (kTQ, NS) B rows j
  float* Xs = Bs + kTQ * NS;                   // (kTQ, PS) xbar rows j
  float* Gs = Xs + kTQ * PS;                   // (kTQ, kGS) scores [j][i]
  const int Qr = (Q + kTQ - 1) / kTQ * kTQ;
  float* dts = Gs + kTQ * kGS;                 // (Qr) dt of the rows
  float* cum = dts + Qr;                       // (Qr) prefix sum of dt * A

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];
  const float* xb = x + b * sxb + static_cast<long long>(h) * P + p0;
  const float* dtb = dt + b * sdb + h;
  const float* bb = Bm + b * sbb + static_cast<long long>(g) * N;
  const float* cb = Cm + b * scb + static_cast<long long>(g) * N;
  const long long syt = static_cast<long long>(H) * P;
  float* yb = y + static_cast<long long>(b) * T * syt +
              static_cast<long long>(h) * P + p0;
  const long long sbase = (static_cast<long long>(b) * H + h) * N * P + p0;

  for (int e = tid; e < N * PS; e += kThreads)
    S[e] = s0 ? s0[sbase + static_cast<long long>(e / PS) * P + e % PS]
              : 0.0f;

  for (int t0 = 0; t0 < T; t0 += Q) {
    const int Qc = min(Q, T - t0), nt = (Qc + kTQ - 1) / kTQ;
    // per-row dt (0 past the chunk's end) and its log decay prefix sum:
    // one warp scans 32 rows at a time and carries the running total
    for (int r = tid; r < nt * kTQ; r += kThreads)
      dts[r] = r < Qc ? dtb[(t0 + r) * sdt] : 0.0f;
    __syncthreads();
    if (tid < 32) {
      float carry = 0.0f;
      for (int base = 0; base < nt * kTQ; base += 32) {
        float v = dts[base + tid] * a;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        cum[base + tid] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    // ---- outputs, one tile of kTQ rows i at a time --------------------
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kTQ;
      load_rows<N>(Cs, cb, t0 + i0, Qc - i0, sct);
      __syncthreads();
      // the carried state: acc = exp(cum_i) C_i . S for rows 2 ty, 2 ty + 1
      float acc[2][CP];
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[0][c] = acc[1][c] = 0.0f;
      {
        const float* c0 = Cs + (2 * ty) * NS;
        const float* c1 = c0 + NS;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float u0 = c0[n], u1 = c1[n];
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            const float s = S[n * PS + tx + 16 * c];
            acc[0][c] = fmaf(u0, s, acc[0][c]);
            acc[1][c] = fmaf(u1, s, acc[1][c]);
          }
        }
        const float e0 = expf(cum[i0 + 2 * ty]);
        const float e1 = expf(cum[i0 + 2 * ty + 1]);
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          acc[0][c] *= e0;
          acc[1][c] *= e1;
        }
      }
      // the chunk's own rows j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTQ;
        load_rows<N>(Bs, bb, t0 + j0, Qc - j0, sbt);
        for (int e = tid; e < kTQ * PS; e += kThreads) {
          const int j = j0 + e / PS;
          Xs[e] = j < Qc ? xb[(t0 + j) * sxt + e % PS] * dts[j] : 0.0f;
        }
        __syncthreads();
        {
          // scores of rows i = ty (+16) against rows j = tx (+16)
          float d[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
          const float4* ci0 = reinterpret_cast<const float4*>(Cs + ty * NS);
          const float4* ci1 = ci0 + 4 * NS;             // 16 rows on
          const float4* bj0 = reinterpret_cast<const float4*>(Bs + tx * NS);
          const float4* bj1 = bj0 + 4 * NS;
#pragma unroll 4
          for (int k = 0; k < N / 4; ++k) {
            const float4 u0 = ci0[k], u1 = ci1[k], v0 = bj0[k], v1 = bj1[k];
            d[0][0] = dot4(u0, v0, d[0][0]);
            d[0][1] = dot4(u0, v1, d[0][1]);
            d[1][0] = dot4(u1, v0, d[1][0]);
            d[1][1] = dot4(u1, v1, d[1][1]);
          }
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
#pragma unroll
            for (int rj = 0; rj < 2; ++rj) {
              const int i = ty + 16 * ri, j = tx + 16 * rj;
              const int ig = i0 + i, jg = j0 + j;
              Gs[j * kGS + i] =
                  jg <= ig ? d[ri][rj] * expf(cum[ig] - cum[jg]) : 0.0f;
            }
          }
        }
        __syncthreads();
#pragma unroll 8
        for (int j = 0; j < kTQ; ++j) {
          const float2 gv =
              *reinterpret_cast<const float2*>(Gs + j * kGS + 2 * ty);
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            const float xv = Xs[j * PS + tx + 16 * c];
            acc[0][c] = fmaf(gv.x, xv, acc[0][c]);
            acc[1][c] = fmaf(gv.y, xv, acc[1][c]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + 2 * ty + r;
        if (i < Qc) {
#pragma unroll
          for (int c = 0; c < CP; ++c)
            yb[(t0 + i) * syt + tx + 16 * c] = acc[r][c];
        }
      }
    }

    // ---- state update: rows n = ty + 16 r, columns p = tx + 16 c -------
    const float clast = cum[Qc - 1];
    float st[NR][CP];
    {
      const float dec = expf(clast);
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c)
          st[r][c] = S[(ty + 16 * r) * PS + tx + 16 * c] * dec;
    }
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kTQ;
      load_rows<N>(Bs, bb, t0 + j0, Qc - j0, sbt);
      for (int e = tid; e < kTQ * PS; e += kThreads) {
        const int j = j0 + e / PS;
        Xs[e] = j < Qc ? xb[(t0 + j) * sxt + e % PS] * dts[j] *
                             expf(clast - cum[j])
                       : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kTQ; ++j) {
        float bv[NR], xv[CP];
#pragma unroll
        for (int r = 0; r < NR; ++r) bv[r] = Bs[j * NS + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < CP; ++c) xv[c] = Xs[j * PS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
          for (int c = 0; c < CP; ++c) st[r][c] = fmaf(bv[r], xv[c], st[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < CP; ++c)
        S[(ty + 16 * r) * PS + tx + 16 * c] = st[r][c];
    __syncthreads();
  }

  for (int e = tid; e < N * PS; e += kThreads)
    s_fin[sbase + static_cast<long long>(e / PS) * P + e % PS] = S[e];
}

template <int N, int PS>
cudaError_t launch(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* s0,
                   float* y, float* s_fin, int B, int T, int H, int G, int P,
                   int Q, long long sxb, long long sxt, long long sdb,
                   long long sdt, long long sbb, long long sbt,
                   long long scb, long long sct, cudaStream_t stream) {
  const int Qr = (Q + kTQ - 1) / kTQ * kTQ;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(N) * PS + 2 * kTQ * (N + 4) +
                       kTQ * PS + kTQ * kGS + 2 * static_cast<size_t>(Qr));
  cudaError_t e = repro_allow_smem(ssd_scan_kernel<N, PS>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(P / PS, H, B);
  ssd_scan_kernel<N, PS><<<grid, kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, s0, y, s_fin, T, H, G, P, Q, sxb, sxt, sdb, sdt,
      sbb, sbt, scb, sct);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const float* x, const float* dt, const float* A,
                     const float* Bm, const float* Cm, const float* s0,
                     float* y, float* s_fin, int B, int T, int H, int G,
                     int P, int Q, long long sxb, long long sxt,
                     long long sdb, long long sdt, long long sbb,
                     long long sbt, long long scb, long long sct,
                     cudaStream_t st) {
  switch (P < 64 ? P : 64) {
    case 16: return launch<N, 16>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H, G,
                                  P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                  sct, st);
    case 32: return launch<N, 32>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H, G,
                                  P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                  sct, st);
    case 64: return launch<N, 64>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H, G,
                                  P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                  sct, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, T, H, P) with dense heads (batch / token strides sxb, sxt); dt:
// (B, T, H) with dense heads (sdb, sdt); A: (H,); Bm / Cm: (B, T, G, N)
// with dense groups (sbb, sbt / scb, sct); s0: (B, H, N, P) contiguous or
// null; y: (B, T, H, P) and s_fin: (B, H, N, P) contiguous.  Q is the
// chunk length; N one of 16, 32, 64, 128; P 16, 32 or a multiple of 64.
REPRO_EXPORT int ssd_scan_f32(
    const float* x, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* s0, float* y, float* s_fin, int B, int T,
    int H, int G, int N, int P, int Q, long long sxb, long long sxt,
    long long sdb, long long sdt, long long sbb, long long sbt,
    long long scb, long long sct, int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (G <= 0 || H % G || Q <= 0 || (P > 64 && P % 64))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || H == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch_n<16>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H, G,
                                 P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                 sct, st);
    case 32: return launch_n<32>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H, G,
                                 P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                 sct, st);
    case 64: return launch_n<64>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H, G,
                                 P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                 sct, st);
    case 128: return launch_n<128>(x, dt, A, Bm, Cm, s0, y, s_fin, B, T, H,
                                   G, P, Q, sxb, sxt, sdb, sdt, sbb, sbt, scb,
                                   sct, st);
    default: return cudaErrorInvalidValue;
  }
}

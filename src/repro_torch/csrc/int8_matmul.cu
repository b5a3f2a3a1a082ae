// int8 x int8 -> int32 GEMM with a per-row x per-column dequant epilogue:
//
//     out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * sx[m] * sw[n]
//
// Replaces src/repro/kernels/int8_matmul/kernel.py:int8_matmul_kernel
// (_matmul_kernel).  On the quantized serving path it runs every backbone
// GEMM of ViTDet-L: patch embedding (K, N) = (768, 1024), fused QKV
// (1024, 2880) with one head pruned, w_o (960, 1024), MLP up (1024, 4096)
// and down (4096, 1024), at M = 8192 tokens for a full-resolution wave of
// two frames.
//
// Bound on the H100: the float32 output.  The work is 2*M*N*K int8
// operations against M*K + K*N bytes in and 4*M*N bytes out, about K/2
// operations per byte at these M and N, while the card balances ~590
// (1,979 dense int8 TOPS over 3.35 TB/s): bytes bound the K <= 1024 GEMMs
// and the tensor cores only the K = 4096 MLP down projection.  Either
// floor is far below what this simple kernel reaches, whose limit is its
// unpipelined shared-memory staging (the design below).
//
// Design: mma.sync.aligned.m16n8k32 (s8 x s8 -> s32) from shared-memory
// tiles.  A block computes a 128 x 128 output tile with 8 warps (2 x 4,
// each 64 x 32 = 4 x 4 mma tiles) and keeps its int32 accumulators in
// registers across the whole K loop: the loop inside the block takes the
// place of the TPU kernel's sequential K grid axis and its VMEM
// accumulator.  Each K step stages a 128 x 64-byte tile of xq (M, K) and
// of the weight codes, which the caller keeps K-contiguous as (N, K) (the
// mma's column-major B operand), so both operands load as 16-byte
// vectors when K is a multiple of 16 and byte by byte otherwise.  Shared
// rows are padded to 80 bytes so the fragment loads of a warp hit 32
// distinct banks.  Ragged M, N and K are masked here: out-of-range rows
// and k columns load as zero (exact for integer sums) and out-of-range
// outputs are not stored, so the pruned widths 960 and 2880 need no
// padding.  The epilogue converts the int32 sum to float (round to
// nearest) and multiplies by sx[m], then by sw[n], in that order, as the
// reference does, so the result is bit-exact against it.  A simple
// single-stage kernel: no cp.async or TMA pipeline and no wgmma yet.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;        // padded shared row, bytes
constexpr int THREADS = 256;        // 8 warps: 2 (M) x 4 (N)
constexpr int WM = 64, WN = 32;     // warp tile
constexpr int MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + 128) x bytes [k0, k0 + 64) of a K-contiguous
// (rows, K) int8 matrix into shared memory; out-of-range bytes are zero.
template <bool VEC>
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g,
                                          int rows, int K, int row0,
                                          int k0) {
  constexpr int CHUNKS = BK / 16;
  for (int c = threadIdx.x; c < BM * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, kc = (c % CHUNKS) * 16;
    const int gr = row0 + r, gk = k0 + kc;
    union {
      int4 v;
      int8_t b[16];
    } u;
    u.v = make_int4(0, 0, 0, 0);
    if (gr < rows) {
      const int8_t* p = g + static_cast<long long>(gr) * K + gk;
      if (VEC) {
        if (gk < K) u.v = *reinterpret_cast<const int4*>(p);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (gk + i < K) u.b[i] = p[i];
      }
    }
    *reinterpret_cast<int4*>(s + r * LDS + kc) = u.v;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ xq,
                       const int8_t* __restrict__ wt,
                       const float* __restrict__ sx,
                       const float* __restrict__ sw,
                       float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;
  const int g = lane >> 2, t = lane & 3;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<VEC>(As, xq, M, K, m0, k0);
    load_tile<VEC>(Bs, wt, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(p);
        b[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // accumulator (i, j, e): row g (+8 for e >= 2), column 2t + (e & 1)
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + i * 16 + g + h * 8;
      if (r >= M) continue;
      const float s = sx[r];
      float* orow = out + static_cast<long long>(r) * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn + j * 8 + t * 2 + e;
          if (c < N)
            orow[c] = static_cast<float>(acc[i][j][h * 2 + e]) * s * sw[c];
        }
      }
    }
  }
}

}  // namespace

// xq: (M, K) int8 row-major; wt: the weight codes as (N, K) int8
// row-major (the (K, N) weight's transpose); sx: (M,) f32; sw: (N,) f32;
// out: (M, N) f32 row-major.
REPRO_EXPORT int int8_matmul_f32(const int8_t* xq, const int8_t* wt,
                                 const float* sx, const float* sw,
                                 float* out, int M, int N, int K,
                                 int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid(repro_ceil_div(N, BN), repro_ceil_div(M, BM));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    int8_matmul_kernel<true><<<grid, THREADS, 0, s>>>(xq, wt, sx, sw, out,
                                                      M, N, K);
  else
    int8_matmul_kernel<false><<<grid, THREADS, 0, s>>>(xq, wt, sx, sw, out,
                                                       M, N, K);
  return cudaGetLastError();
}

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
// Bound on the H100: the work is 2*M*N*K int8 operations against M*K +
// K*N bytes in and 4*M*N bytes out, about K/2 operations per byte at
// these M and N, while the card balances ~590 (1,979 dense int8 TOPS over
// 3.35 TB/s): the float32 output bounds the K <= 1024 GEMMs and the
// tensor cores only the K = 4096 MLP down projection.  So the design keeps
// both busy at once: the tensor cores fed at Hopper's rate, and the output
// written as full coalesced lines while the other block on the SM runs its
// main loop.
//
// Design.  A block computes a 128 x BN output tile with three roles:
//  - one producer warp, whose lane 0 keeps a ring of STAGES shared-memory
//    stages full with TMA (cp.async.bulk.tensor) loads of a 128 x 128-byte
//    tile of xq (M, K) and a BN x 128-byte tile of the weight codes, which
//    the caller keeps K-major as (N, K), the layout wgmma needs of 8-bit
//    operands.  The loads use the 128-byte swizzle and complete on a "full"
//    mbarrier per stage; the producer reuses a stage once its "empty"
//    mbarrier says every consumer warp has retired the wgmma that read it.
//    TMA fills rows and K columns outside the tensor with zeros, which is
//    exact for integer sums, so ragged M, N and K (the pruned widths 960
//    and 2880) need no padding in memory and no masks in the main loop;
//  - two consumer warpgroups, each owning 64 rows of the tile, which issue
//    wgmma.mma_async m64n128k32 s32.s8.s8 with both operands read from the
//    swizzled stages (four per 128-byte stage and 128 columns), keep the
//    int32 sums in registers across the whole K loop (the loop takes the
//    place of the TPU kernel's sequential K grid axis and its VMEM
//    accumulator), and keep one wgmma group in flight: stage k is released
//    when the group of stage k + 1 has been issued and that of stage k has
//    retired (wgmma.wait_group 1);
//  - the epilogue: after the loop the two warpgroups stage their int32
//    sums through the now idle ring (rows padded by 8 words, so a warp's
//    fragment stores hit every bank once per 256 bytes), then each thread
//    reads four neighbouring sums, converts each to float (round to
//    nearest), multiplies by sx[m] and then by sw[n], in that order, as the
//    reference does, so the result is bit-exact against it, and writes
//    them as one 16-byte store: a warp writes 512 contiguous bytes of a
//    row.  Where N is not a multiple of 4 the row pitch is not 16-byte
//    aligned and the stores are scalar.
// The wrapper picks BN by what bounds the GEMM (ops.tile_n).  BN = 128
// where the output's bytes do: a block takes 96 KB of shared memory
// (three stages), so two blocks share an SM and one's epilogue overlaps
// the other's main loop.  BN = 256 (two m64n128 wgmmas a k step, four
// 48 KB stages, one block an SM) where the tensor cores do, as in the MLP
// down projection: it reads A from shared memory once per 256 columns,
// not per 128, and shared-memory reads are what hold 128-wide tiles back
// there.
// TMA needs 16-byte-aligned base pointers and row pitches: K must be a
// multiple of 16 (the wrapper zero-pads it) and the bases 16-byte aligned
// (else the entry point refuses the call).
//
// Output types (common.cuh): the epilogue's float32 value rounds once to
// float32, fp16 or bf16 (the reference's out_dtype), exported as
// int8_matmul_{f32,f16,bf16}; the TMA maps and the wgmma main loop read
// int8 and do not change.  A half row stores four outputs (8 bytes) at a
// time.  The product sx[m] * sw[n] stays in float32 in the same order,
// so each type is bit-exact against the reference's epilogue.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128;          // rows of a tile: two warpgroups of 64
constexpr int BK = 128;          // bytes of K a stage holds: one swizzle row
constexpr int CONSUMERS = 2;     // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp

template <int BN>
struct Tile;
template <>
struct Tile<128> {  // 3 x 32 KB stages: two blocks an SM
  static constexpr int STAGES = 3, BLOCKS_PER_SM = 2;
};
template <>
struct Tile<256> {  // 4 x 48 KB stages: one block an SM
  static constexpr int STAGES = 4, BLOCKS_PER_SM = 1;
};

template <int BN>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the ring to the 1024-byte swizzle atom, the
  // ring, and a full and an empty mbarrier per stage
  return 1024 + static_cast<size_t>(Tile<BN>::STAGES) * (BM + BN) * BK +
         2 * Tile<BN>::STAGES * sizeof(uint64_t);
}

// d (64 x 128 int32, this warpgroup's fragment) += A (64 x 32) * B^T,
// with A and B both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32(int* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN, typename OT>
__global__ void __launch_bounds__(THREADS, Tile<BN>::BLOCKS_PER_SM)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float* __restrict__ sx,
                       const float* __restrict__ sw,
                       OT* __restrict__ out, int M, int N, int K) {
  constexpr int STAGES = Tile<BN>::STAGES;
  constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  constexpr int NH = BN / 128;             // m64n128 wgmmas per k step
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + STAGES * (A_BYTES + B_BYTES));
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: lane 0 keeps the ring full, one stage per 128 bytes of K
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) - 1) & 1);
        uint8_t* sa = ring + s * (A_BYTES + B_BYTES);
        mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
        tma_load(&map_x, sa, &full[s], kt * BK, m0);
        tma_load(&map_w, sa + A_BYTES, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  int acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const uint32_t sa =
        smem_u32(ring + s * (A_BYTES + B_BYTES)) + wg * 64 * BK;
    const uint32_t sb = smem_u32(ring + s * (A_BYTES + B_BYTES) + A_BYTES);
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs<64>(acc[h]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_m64n128k32(acc[h], sw128_desc(sa + kk * 32),
                         sw128_desc(sb + h * 128 * BK + kk * 32));
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs<64>(acc[h]);
    wgmma_wait<1>();
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) fence_regs<64>(acc[h]);

  // epilogue: both warpgroups are done with the ring; stage the sums
  constexpr int LDC = BN + 8;              // padded staging row, words
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1, CONSUMERS * 128);
  int* stg = reinterpret_cast<int*>(ring) + wg * 64 * LDC;
  {
    // fragment (h, 4i + e): row 16 w + g (+8 for e >= 2), column
    // 128 h + 8 i + 2 t + (e & 1)
    const int w = warp % 4, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        int* p = stg + (16 * w + g) * LDC + 128 * h + 8 * i + 2 * t;
        *reinterpret_cast<int2*>(p) =
            make_int2(acc[h][4 * i], acc[h][4 * i + 1]);
        *reinterpret_cast<int2*>(p + 8 * LDC) =
            make_int2(acc[h][4 * i + 2], acc[h][4 * i + 3]);
      }
  }
  named_sync(2 + wg, 128);

  constexpr int TPR = BN / 4;              // threads per staged row
  const int tid = threadIdx.x % 128;
  const int c = (tid % TPR) * 4, gc = n0 + c;
  float wv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) wv[e] = gc + e < N ? sw[gc + e] : 0.0f;
  const bool vec = N % 4 == 0;
  for (int r = tid / TPR; r < 64; r += 128 / TPR) {
    const int gr = m0 + wg * 64 + r;
    if (gr >= M) break;
    const int4 a = *reinterpret_cast<const int4*>(stg + r * LDC + c);
    const float s = sx[gr];
    float4 o;
    o.x = __fmul_rn(__fmul_rn(__int2float_rn(a.x), s), wv[0]);
    o.y = __fmul_rn(__fmul_rn(__int2float_rn(a.y), s), wv[1]);
    o.z = __fmul_rn(__fmul_rn(__int2float_rn(a.z), s), wv[2]);
    o.w = __fmul_rn(__fmul_rn(__int2float_rn(a.w), s), wv[3]);
    OT* dst = out + static_cast<long long>(gr) * N + gc;
    if (vec && gc + 3 < N) {
      store4(dst, o);
    } else {
      const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gc + e < N) dst[e] = from_f32<OT>(ov[e]);
    }
  }
}

// A (rows, K) int8 row-major matrix as 128-byte x box_rows TMA boxes with
// the 128-byte swizzle; out-of-range elements read as zero.
bool k_major_map(CUtensorMap* map, const int8_t* base, int rows, int K,
                 int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<int8_t*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename OT>
cudaError_t launch(const int8_t* xq, const int8_t* wt, const float* sx,
                   const float* sw, OT* out, int M, int N, int K,
                   cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!k_major_map(&map_x, xq, M, K, BM) || !k_major_map(&map_w, wt, N, K, BN))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<BN>();
  cudaError_t e = repro_allow_smem(int8_matmul_kernel<BN, OT>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(repro_ceil_div(N, BN), repro_ceil_div(M, BM));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_matmul_kernel<BN, OT><<<grid, THREADS, smem, stream>>>(
      map_x, map_w, sx, sw, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// xq: (M, K) int8 row-major; wt: the weight codes as (N, K) int8
// row-major (the (K, N) weight's transpose); sx: (M,) f32; sw: (N,) f32;
// out: (M, N) row-major in the entry's type.  K must be a positive
// multiple of 16 and xq, wt 16-byte aligned (TMA's terms); tile_n is 128
// or 256.
template <typename OT>
int entry(const int8_t* xq, const int8_t* wt, const float* sx,
          const float* sw, OT* out, int M, int N, int K, int tile_n,
          int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (M < 0 || N < 0 || K <= 0 || K % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16)
    return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_n == 128) return launch<128>(xq, wt, sx, sw, out, M, N, K, s);
  if (tile_n == 256) return launch<256>(xq, wt, sx, sw, out, M, N, K, s);
  return cudaErrorInvalidValue;
}

#define REPRO_INT8_ENTRY(T, SUF)                                             \
  REPRO_EXPORT int int8_matmul_##SUF(const int8_t* xq, const int8_t* wt,     \
                                     const float* sx, const float* sw,       \
                                     T* out, int M, int N, int K,            \
                                     int tile_n, int device, void* stream) { \
    return entry<T>(xq, wt, sx, sw, out, M, N, K, tile_n, device, stream);   \
  }

REPRO_FLOAT_TYPES(REPRO_INT8_ENTRY)

// Fused serving prologue and epilogue: two index-driven copy kernels.
//
// pack_pos replaces src/repro/kernels/fused_serving/kernel.py:
// pack_pos_kernel (_pack_pos_body):
//     out[b, i] = bank[b, win_src[b, i]] + pos_bank[win_src[b, i]]
//                                                    if i < nw[b], else 0
// restore_gather replaces fused_serving/kernel.py:restore_gather_kernel
// (_restore_body):
//     out[b, o, t] = src[b, out_src[b, o], maps[out_map[b, o], t]]
// where src is [packed windows | REUSE tiles], read from two pointers by
// whether out_src < nw_pad.  The TPU kernel multiplies by one-hot
// permutation matrices; here the token map is an index gather, so the
// copy is bit-exact with no arithmetic at all.
//
// Bound on the H100: bytes.  pack_pos reads each packed window of the
// bank and of the positional bank once and writes the packed sequence
// once; restore_gather reads each source window once per destination
// and writes the full-resolution sequence once (at ViTDet-L width a
// window is 64 tokens x 1024 floats = 256 KB).  Design: one block per
// (destination window, batch row, slice of the window), 16-byte loads
// and stores along the contiguous feature axis, indices read by the
// block itself.  An index outside its bank writes NaN instead of
// reading out of bounds, so a malformed layout shows as non-finite
// output.
#include <math.h>

#include "common.cuh"

// pack_pos: grid (nw_pad, B, SLICES); a window row of w2*C floats is cut
// into SLICES slices so a small batch still fills the card.
constexpr int kPackSlices = 8;

__global__ void pack_pos_kernel(const float* __restrict__ bank,
                                const float* __restrict__ pos,
                                const int* __restrict__ win_src,
                                const int* __restrict__ nw,
                                float* __restrict__ out, int nbank,
                                int nw_pad, long long row) {
  const int i = blockIdx.x, b = blockIdx.y;
  float* o = out + (static_cast<long long>(b) * nw_pad + i) * row;
  const long long per = (row + gridDim.z - 1) / gridDim.z;
  const long long lo = per * blockIdx.z;
  const long long hi = lo + per < row ? lo + per : row;
  const int s = win_src[static_cast<long long>(b) * nw_pad + i];
  const bool valid = i < nw[b];
  const bool in_range = s >= 0 && s < nbank;
  const float* a = bank + (static_cast<long long>(b) * nbank + s) * row;
  const float* p = pos + static_cast<long long>(s) * row;
  const bool vec = (row % 4 == 0) && (lo % 4 == 0) && (hi % 4 == 0);
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(o + lo);
    const float4* a4 = reinterpret_cast<const float4*>(a + lo);
    const float4* p4 = reinterpret_cast<const float4*>(p + lo);
    const long long n4 = (hi - lo) / 4;
    for (long long t = threadIdx.x; t < n4; t += blockDim.x) {
      float4 r;
      if (!valid) {
        r = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (!in_range) {
        r = make_float4(NAN, NAN, NAN, NAN);
      } else {
        const float4 x = a4[t], y = p4[t];
        r = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
      }
      o4[t] = r;
    }
  } else {
    for (long long t = lo + threadIdx.x; t < hi; t += blockDim.x)
      o[t] = !valid ? 0.f : (!in_range ? NAN : a[t] + p[t]);
  }
}

REPRO_EXPORT int pack_pos_f32(const float* bank, const float* pos,
                              const int* win_src, const int* nw, float* out,
                              int B, int nbank, int nw_pad, long long row,
                              int device, void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (B == 0 || nw_pad == 0 || row == 0) return cudaSuccess;
  dim3 grid(nw_pad, B, kPackSlices);
  pack_pos_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      bank, pos, win_src, nw, out, nbank, nw_pad, row);
  return cudaGetLastError();
}

// restore_gather: grid (nout, B, SLICES); slice z copies token rows
// t = z, z + SLICES, ... of its destination window.
constexpr int kRestoreSlices = 8;

__global__ void restore_gather_kernel(
    const float* __restrict__ windows, const float* __restrict__ tiles,
    const int* __restrict__ out_src, const int* __restrict__ out_map,
    const int* __restrict__ maps, float* __restrict__ out, int nw_pad,
    int ntile, int nout, int nmaps, int w2, int D) {
  const int o = blockIdx.x, b = blockIdx.y;
  const long long slot = static_cast<long long>(b) * nout + o;
  const int s = out_src[slot];
  const int m = out_map[slot];
  const long long win = static_cast<long long>(w2) * D;
  const float* base = nullptr;
  bool bad = m < 0 || m >= nmaps || s < 0;
  if (!bad && s < nw_pad) {
    base = windows + (static_cast<long long>(b) * nw_pad + s) * win;
  } else if (!bad && s < nw_pad + ntile) {
    if (tiles != nullptr)  // no tile bank: REUSE slots restore to zeros
      base = tiles + (static_cast<long long>(b) * ntile + (s - nw_pad)) * win;
  } else {
    bad = true;
  }
  float* dst = out + slot * win;
  const bool vec = (D % 4 == 0);
  for (int t = blockIdx.z; t < w2; t += gridDim.z) {
    float* drow = dst + static_cast<long long>(t) * D;
    const float* srow =
        base ? base + static_cast<long long>(maps[(bad ? 0 : m) * w2 + t]) * D
             : nullptr;
    const float fill = bad ? NAN : 0.0f;
    if (vec) {
      float4* d4 = reinterpret_cast<float4*>(drow);
      const float4* s4 = reinterpret_cast<const float4*>(srow);
      for (int c = threadIdx.x; c < D / 4; c += blockDim.x)
        d4[c] = srow ? s4[c] : make_float4(fill, fill, fill, fill);
    } else {
      for (int c = threadIdx.x; c < D; c += blockDim.x)
        drow[c] = srow ? srow[c] : fill;
    }
  }
}

REPRO_EXPORT int restore_gather_f32(const float* windows, const float* tiles,
                                    const int* out_src, const int* out_map,
                                    const int* maps, float* out, int B,
                                    int nw_pad, int ntile, int nout,
                                    int nmaps, int w2, int D, int device,
                                    void* stream) {
  cudaError_t e = repro_begin(device);
  if (e != cudaSuccess) return e;
  if (B == 0 || nout == 0 || w2 == 0 || D == 0) return cudaSuccess;
  dim3 grid(nout, B, w2 < kRestoreSlices ? w2 : kRestoreSlices);
  restore_gather_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      windows, tiles, out_src, out_map, maps, out, nw_pad, ntile, nout,
      nmaps, w2, D);
  return cudaGetLastError();
}

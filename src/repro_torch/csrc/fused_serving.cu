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
//
// Element types (common.cuh): float32, fp16 and bf16, exported as
// pack_pos_{f32,f16,bf16} and restore_gather_{f32,f16,bf16}.  At half
// pack_pos adds in float32 and rounds once: float32 carries 24 >= 2 p + 2
// bits for a p-bit half type (p = 11 or 8), so that is the correctly
// rounded half add, bit-equal to the reference's add in the input type.
// restore_gather copies bytes and is exact at every type (the
// reference's one-hot product in float32 is exact too).
#include <math.h>

#include "common.cuh"

namespace {

// pack_pos: grid (nw_pad, B, SLICES); a window row of w2*C elements is
// cut into SLICES slices so a small batch still fills the card.
constexpr int kPackSlices = 8;

template <typename T>
__global__ void pack_pos_kernel(const T* __restrict__ bank,
                                const T* __restrict__ pos,
                                const int* __restrict__ win_src,
                                const int* __restrict__ nw,
                                T* __restrict__ out, int nbank, int nw_pad,
                                long long row) {
  constexpr int V = Vec16<T>::N;
  const int i = blockIdx.x, b = blockIdx.y;
  T* o = out + (static_cast<long long>(b) * nw_pad + i) * row;
  const long long per = (row + gridDim.z - 1) / gridDim.z;
  const long long lo = per * blockIdx.z;
  const long long hi = lo + per < row ? lo + per : row;
  const int s = win_src[static_cast<long long>(b) * nw_pad + i];
  const bool valid = i < nw[b];
  const bool in_range = s >= 0 && s < nbank;
  const T* a = bank + (static_cast<long long>(b) * nbank + s) * row;
  const T* p = pos + static_cast<long long>(s) * row;
  const bool vec = (row % V == 0) && (lo % V == 0) && (hi % V == 0);
  if (vec) {
    const long long nv = (hi - lo) / V;
    for (long long t = threadIdx.x; t < nv; t += blockDim.x) {
      float r[V];
      if (!valid || !in_range) {
#pragma unroll
        for (int e = 0; e < V; ++e) r[e] = valid ? NAN : 0.0f;
      } else {
        float y[V];
        load16(a + lo + t * V, r);
        load16(p + lo + t * V, y);
#pragma unroll
        for (int e = 0; e < V; ++e) r[e] += y[e];
      }
      store16(o + lo + t * V, r);
    }
  } else {
    for (long long t = lo + threadIdx.x; t < hi; t += blockDim.x)
      o[t] = from_f32<T>(!valid ? 0.f
                                : (!in_range ? NAN
                                             : to_f32(a[t]) + to_f32(p[t])));
  }
}

// restore_gather: grid (nout, B, SLICES); slice z copies token rows
// t = z, z + SLICES, ... of its destination window.
constexpr int kRestoreSlices = 8;

template <typename T>
__global__ void restore_gather_kernel(
    const T* __restrict__ windows, const T* __restrict__ tiles,
    const int* __restrict__ out_src, const int* __restrict__ out_map,
    const int* __restrict__ maps, T* __restrict__ out, int nw_pad,
    int ntile, int nout, int nmaps, int w2, int D) {
  constexpr int V = Vec16<T>::N;
  const int o = blockIdx.x, b = blockIdx.y;
  const long long slot = static_cast<long long>(b) * nout + o;
  const int s = out_src[slot];
  const int m = out_map[slot];
  const long long win = static_cast<long long>(w2) * D;
  const T* base = nullptr;
  bool bad = m < 0 || m >= nmaps || s < 0;
  if (!bad && s < nw_pad) {
    base = windows + (static_cast<long long>(b) * nw_pad + s) * win;
  } else if (!bad && s < nw_pad + ntile) {
    if (tiles != nullptr)  // no tile bank: REUSE slots restore to zeros
      base = tiles + (static_cast<long long>(b) * ntile + (s - nw_pad)) * win;
  } else {
    bad = true;
  }
  T* dst = out + slot * win;
  const T fill = from_f32<T>(bad ? NAN : 0.0f);
  uint4 fill16;
  T* fe = reinterpret_cast<T*>(&fill16);
#pragma unroll
  for (int e = 0; e < V; ++e) fe[e] = fill;
  const bool vec = (D % V == 0);
  for (int t = blockIdx.z; t < w2; t += gridDim.z) {
    T* drow = dst + static_cast<long long>(t) * D;
    const T* srow =
        base ? base + static_cast<long long>(maps[(bad ? 0 : m) * w2 + t]) * D
             : nullptr;
    if (vec) {
      uint4* d16 = reinterpret_cast<uint4*>(drow);
      const uint4* s16 = reinterpret_cast<const uint4*>(srow);
      for (int c = threadIdx.x; c < D / V; c += blockDim.x)
        d16[c] = srow ? s16[c] : fill16;
    } else {
      for (int c = threadIdx.x; c < D; c += blockDim.x)
        drow[c] = srow ? srow[c] : fill;
    }
  }
}

}  // namespace

#define REPRO_FUSED_ENTRIES(T, SUF)                                          \
  REPRO_EXPORT int pack_pos_##SUF(const T* bank, const T* pos,               \
                                  const int* win_src, const int* nw, T* out, \
                                  int B, int nbank, int nw_pad,              \
                                  long long row, int device, void* stream) { \
    cudaError_t e = repro_begin(device);                                     \
    if (e != cudaSuccess) return e;                                          \
    if (B == 0 || nw_pad == 0 || row == 0) return cudaSuccess;               \
    dim3 grid(nw_pad, B, kPackSlices);                                       \
    pack_pos_kernel<T><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>( \
        bank, pos, win_src, nw, out, nbank, nw_pad, row);                    \
    return cudaGetLastError();                                               \
  }                                                                          \
  REPRO_EXPORT int restore_gather_##SUF(                                     \
      const T* windows, const T* tiles, const int* out_src,                  \
      const int* out_map, const int* maps, T* out, int B, int nw_pad,        \
      int ntile, int nout, int nmaps, int w2, int D, int device,             \
      void* stream) {                                                        \
    cudaError_t e = repro_begin(device);                                     \
    if (e != cudaSuccess) return e;                                          \
    if (B == 0 || nout == 0 || w2 == 0 || D == 0) return cudaSuccess;        \
    dim3 grid(nout, B, w2 < kRestoreSlices ? w2 : kRestoreSlices);           \
    restore_gather_kernel<T>                                                 \
        <<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(               \
            windows, tiles, out_src, out_map, maps, out, nw_pad, ntile,      \
            nout, nmaps, w2, D);                                             \
    return cudaGetLastError();                                               \
  }

REPRO_FLOAT_TYPES(REPRO_FUSED_ENTRIES)

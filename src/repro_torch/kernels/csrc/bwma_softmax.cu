// Blocked row softmax for Hopper (sm_90a), directly on the BWMA layout.
//
// Replaces the Pallas TPU kernel repro/kernels/bwma_softmax.py:_softmax_kernel
// (launched by bwma_softmax).
//
// x (..., gm, gn, bm, bn), contiguous, fp32 or bf16: logical row i * bm + r
// is row r of the gn blocks of block-row i, and its column j * bn + c lies in
// block j at column c.  Columns at or past n_logical are masked: they take
// finfo(x.dtype).min in the max (the TPU kernel's fill, in the input's type)
// and are written as exactly 0.  out = e / max(sum e, 1e-30) with
// e = exp(x - max), computed in fp32 and rounded once to x's type.
//
// What bounds it on this card: a few operations per element read once and
// written once, so the bytes (3.35 TB/s HBM3 on an H100 SXM).
//
// Design.  The TPU grid walks block-rows in order, one (gn, bm, bn) slab in
// VMEM at a time.  Here one CTA owns one block-row (the leading dims fold
// into the grid, since the operand is contiguous) and each warp owns whole
// logical rows: it reads the row's gn segments of bn contiguous values
// (lanes over the flattened column index, bn a compile-time power of two),
// reduces the max and then the sum of exponentials with warp shuffles, and
// writes the normalised row.  The block-row (256 KB in fp32 at block 128)
// does not fit in shared memory, so the second and third reads of each row
// come from the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
bwma_softmax_kernel(const T* x, T* out, int gn, int bm, int n_logical, float fill) {
  const long long base = static_cast<long long>(blockIdx.x) * gn * bm * BN;
  const T* xb = x + base;
  T* ob = out + base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int width = gn * BN;
  // the masked fill enters the max only where a masked column exists
  const float m0 = n_logical < width ? fill : -INFINITY;
  for (int row = warp; row < bm; row += kWarps) {
    const long long roff = static_cast<long long>(row) * BN;
    float m = m0;
    for (int k = lane; k < n_logical; k += 32)
      m = fmaxf(m, to_f32(xb[static_cast<long long>(k / BN) * bm * BN + roff + k % BN]));
    m = warp_max(m);
    float s = 0.0f;
    for (int k = lane; k < n_logical; k += 32)
      s += expf(to_f32(xb[static_cast<long long>(k / BN) * bm * BN + roff + k % BN]) - m);
    const float den = fmaxf(warp_sum(s), 1e-30f);
    for (int k = lane; k < width; k += 32) {
      const long long off = static_cast<long long>(k / BN) * bm * BN + roff + k % BN;
      const float e = k < n_logical ? expf(to_f32(xb[off]) - m) : 0.0f;
      ob[off] = from_f32<T>(e / den);
    }
  }
}

template <typename T, int BN>
int launch(const void* x, void* out, long long block_rows, int gn, int bm, int n_logical,
           float fill, void* stream) {
  bwma_softmax_kernel<T, BN>
      <<<static_cast<unsigned>(block_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<T*>(out), gn, bm, n_logical, fill);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* out, long long block_rows, int gn, int bm, int bn,
             int n_logical, float fill, void* stream) {
  if (block_rows < 1 || block_rows > 2147483647LL || gn < 1 || bm < 1 || n_logical < 1 ||
      static_cast<long long>(n_logical) > static_cast<long long>(gn) * bn)
    return cudaErrorInvalidValue;
  switch (bn) {
    case 8: return launch<T, 8>(x, out, block_rows, gn, bm, n_logical, fill, stream);
    case 16: return launch<T, 16>(x, out, block_rows, gn, bm, n_logical, fill, stream);
    case 32: return launch<T, 32>(x, out, block_rows, gn, bm, n_logical, fill, stream);
    case 64: return launch<T, 64>(x, out, block_rows, gn, bm, n_logical, fill, stream);
    case 128: return launch<T, 128>(x, out, block_rows, gn, bm, n_logical, fill, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int bwma_softmax_f32(const void* x, void* out, long long block_rows, int gn,
                                int bm, int bn, int n_logical, void* stream) {
  return dispatch<float>(x, out, block_rows, gn, bm, bn, n_logical, -FLT_MAX, stream);
}

// finfo(bfloat16).min = -(2 - 2^-7) * 2^127, exactly representable in fp32
extern "C" int bwma_softmax_bf16(const void* x, void* out, long long block_rows, int gn,
                                 int bm, int bn, int n_logical, void* stream) {
  return dispatch<__nv_bfloat16>(x, out, block_rows, gn, bm, bn, n_logical,
                                 -3.3895313892515355e38f, stream);
}

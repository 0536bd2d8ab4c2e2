// Blocked (BWMA) row LayerNorm in fp32 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bwma_layernorm.py:_ln_kernel
// (launched by _ln_4d from bwma_layernorm).
//
// x and out are (..., gm, gn, bm, bn) blocked matrices; gamma and beta are
// blocked vectors (gn, bn) shared by every leading (batch) slot.  Logical
// row r of block-row i is gn contiguous bn-runs at stride bm * bn.  Columns
// at or past n_logical are masked out of the mean and the variance and are
// written as exactly 0; eps is added inside the rsqrt, as in the reference.
//
// What bounds it on this card: memory bytes.  It reads x once and writes out
// once (about 3 MB per BERT-base sequence) against a handful of operations
// per element, so the 3.35 TB/s of HBM is the limit.
//
// Design: one CTA per (lead, block-row i), one warp per logical row, lanes
// striding over the row's columns; the two passes of the reference (masked
// mean, then masked variance) are warp-shuffle reductions.  A row is read
// three times (mean, variance, normalise) but the later reads hit L1/L2, so
// device memory sees it once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct LnArgs {
  const float* x;
  const float* gamma;
  const float* beta;
  float* out;
  int lead1;
  long long x_s0, x_s1;  // element strides of x along the two lead dims
  int gm, gn, bm, bn, n_logical;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) bwma_layernorm_kernel(LnArgs p) {
  const int i = blockIdx.x;
  const int z = blockIdx.y;
  const int l0 = z / p.lead1;
  const int l1 = z - l0 * p.lead1;
  const long long rowblk = static_cast<long long>(p.gn) * p.bm * p.bn;
  const float* x = p.x + l0 * p.x_s0 + l1 * p.x_s1 + i * rowblk;
  float* o = p.out + (static_cast<long long>(z) * p.gm + i) * rowblk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = kThreads / 32;
  const int bb = p.bm * p.bn;  // stride between successive column blocks
  const int ncols = p.gn * p.bn;
  const float n = static_cast<float>(p.n_logical);

  for (int r = warp; r < p.bm; r += nwarps) {
    const float* xr = x + r * p.bn;
    float* orow = o + r * p.bn;
    float s = 0.0f;
    for (int c = lane; c < p.n_logical; c += 32) {
      const int jb = c / p.bn;
      s += xr[jb * bb + (c - jb * p.bn)];
    }
    const float mean = warp_sum(s) / n;
    float v = 0.0f;
    for (int c = lane; c < p.n_logical; c += 32) {
      const int jb = c / p.bn;
      const float d = xr[jb * bb + (c - jb * p.bn)] - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / n + p.eps);
    for (int c = lane; c < ncols; c += 32) {
      const int jb = c / p.bn;
      const int off = jb * bb + (c - jb * p.bn);
      float y = 0.0f;
      if (c < p.n_logical) y = (xr[off] - mean) * rstd * p.gamma[c] + p.beta[c];
      orow[off] = y;
    }
  }
}

}  // namespace

extern "C" int bwma_layernorm_f32(const float* x, const float* gamma,
                                  const float* beta, float* out, int lead0,
                                  int lead1, long long x_s0, long long x_s1,
                                  int gm, int gn, int bm, int bn,
                                  int n_logical, float eps, void* stream) {
  if (lead0 * lead1 > 65535 || n_logical < 1 || n_logical > gn * bn)
    return cudaErrorInvalidValue;
  const LnArgs p{x, gamma, beta, out, lead1, x_s0, x_s1, gm, gn, bm, bn, n_logical, eps};
  const dim3 grid(gm, lead0 * lead1);
  bwma_layernorm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

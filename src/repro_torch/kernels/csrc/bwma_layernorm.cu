// Blocked (BWMA) row LayerNorm for Hopper (sm_90a), x in fp32 or bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/bwma_layernorm.py:_ln_kernel
// (launched by _ln_4d from bwma_layernorm).
//
// x and out are (..., gm, gn, bm, bn) blocked matrices of one type, fp32 or
// bf16; gamma and beta are blocked vectors (gn, bn) shared by every leading
// (batch) slot, each fp32 or bf16 on its own.  Logical row r of block-row i
// is gn contiguous bn-runs at stride bm * bn.  Columns at or past n_logical
// are masked out of the mean and the variance and are written as exactly 0;
// eps is added inside the rsqrt, as in the reference.  Everything is
// computed in fp32 and rounded once to x's type.
//
// What bounds it on this card: memory bytes.  It reads x once and writes out
// once against a handful of operations per element; at BERT-base (2048 rows
// of 768 fp32 at batch 4) that is 12.6 MB, 3.75 us at 3.35 TB/s.
//
// Design:
// - Rows, not block-rows, set the grid.  One warp owns one logical row; a
//   CTA holds kRows = 4 rows of one block-row (every supported bm is a
//   multiple of 4), so 512 CTAs at BERT-base batch 4 and 128 at batch 1, on
//   132 SMs, at any block size; the leading dims are gridDim.y with x's own
//   strides.  4 was the fastest of R = 1, 2, 4, 8 at every BERT-base call
//   on an H100 (PERF.md).
// - The row lives in registers: read once from device memory, written once.
//   A lane loads 16 bytes at a time (4 fp32 or 8 bf16), lane l taking the
//   row's vectors l, l + 32, ...; a bn-run is contiguous, so neighbouring
//   lanes read neighbouring addresses at every bn in 8..128.  Every load is
//   issued before the first reduction, so a warp has its whole row in
//   flight at once.
// - The two passes of the reference (the masked mean, then the masked
//   variance of x - mean) run on those registers with warp-shuffle sums.
// - bn is a template parameter, so a vector's block and offset are a shift
//   and a mask; n_logical masks per element inside the last vector.
// - NV, the 16-byte vectors a lane holds, is a template parameter (1, 2, 4,
//   8 or 16).  Rows up to 16 * 32 vectors -- 2048 fp32 or 4096 bf16 columns
//   of padded width -- take the register path.  A wider row takes the looped
//   path (NV = 0): the same vector walk three times, mean, variance and
//   output, its second and third reads of the row served by L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxVectors = 16;  // per lane on the register path
constexpr int kRows = 4;         // rows (one warp each) per CTA

struct LnArgs {
  const void* x;
  const void* gamma;
  const void* beta;
  void* out;
  bool gamma_bf16, beta_bf16;
  int lead1;
  long long x_s0, x_s1;  // element strides of x along the two lead dims
  int gm, gn, bm, n_logical;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16 bytes of T as floats, and back (bf16 rounded to nearest even)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& r, float* f) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* f) {
  unpack_bf16x2(r.x, f);
  unpack_bf16x2(r.y, f + 2);
  unpack_bf16x2(r.z, f + 4);
  unpack_bf16x2(r.w, f + 6);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}

// gamma or beta at flattened column c, V values (one vector of x)
template <int V>
__device__ __forceinline__ void load_param(const void* p, bool bf16, int c, float* f) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + c;
    if constexpr (V == 8) {
      unpack<__nv_bfloat16>(__ldg(reinterpret_cast<const uint4*>(q)), f);
    } else {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(q));
      unpack_bf16x2(r.x, f);
      unpack_bf16x2(r.y, f + 2);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + c);
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 r = __ldg(q + h);
      f[4 * h] = r.x;
      f[4 * h + 1] = r.y;
      f[4 * h + 2] = r.z;
      f[4 * h + 3] = r.w;
    }
  }
}

// The row's output vector v: masked columns 0, the rest normalised
template <typename T, int V>
__device__ __forceinline__ uint4 normalise(const LnArgs& p, const float* f, int v, float mean,
                                           float rstd) {
  float g[V], b[V], y[V];
  load_param<V>(p.gamma, p.gamma_bf16, v * V, g);
  load_param<V>(p.beta, p.beta_bf16, v * V, b);
  const int live = p.n_logical - v * V;  // columns of this vector inside n_logical
#pragma unroll
  for (int e = 0; e < V; ++e) y[e] = e < live ? (f[e] - mean) * rstd * g[e] + b[e] : 0.0f;
  return pack<T>(y);
}

template <typename T, int BN, int NV>
__global__ void __launch_bounds__(32 * kRows) bwma_layernorm_kernel(LnArgs p) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
  constexpr int VPB = BN / V;                            // vectors per bn-run
  static_assert(VPB >= 1 && (VPB & (VPB - 1)) == 0, "bn must be a power of two >= 16 bytes");
  const int lane = threadIdx.x & 31;
  const int z = blockIdx.y;
  const int l0 = z / p.lead1;
  const int l1 = z - l0 * p.lead1;
  const int rs = blockIdx.x * kRows + (threadIdx.x >> 5);  // row in the slot
  const int i = rs / p.bm;  // block-row (once per warp)
  const int r = rs - i * p.bm;
  const long long row = (static_cast<long long>(i) * p.gn * p.bm + r) * BN;
  const T* x = static_cast<const T*>(p.x) + l0 * p.x_s0 + l1 * p.x_s1 + row;
  T* o = static_cast<T*>(p.out) + static_cast<long long>(z) * p.gm * p.gn * p.bm * BN + row;
  const long long jstride = static_cast<long long>(p.bm) * BN;  // between a row's bn-runs
  const int nvec = p.gn * VPB;  // vectors in the padded row
  const float n = static_cast<float>(p.n_logical);
  // a vector's offset in the row: its bn-run (a shift) and its place in it (a mask)
  auto at = [&](int v) {
    const unsigned u = static_cast<unsigned>(v);
    return (u / VPB) * jstride + (u % VPB) * V;
  };

  if constexpr (NV > 0) {
    uint4 raw[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      raw[k] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(x + at(v))) : make_uint4(0, 0, 0, 0);
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[V];
      unpack<T>(raw[k], f);
      const int live = p.n_logical - (lane + 32 * k) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) s += e < live ? f[e] : 0.0f;
    }
    const float mean = warp_sum(s) / n;
    float q = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[V];
      unpack<T>(raw[k], f);
      const int live = p.n_logical - (lane + 32 * k) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = f[e] - mean;
        q += e < live ? d * d : 0.0f;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / n + p.eps);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v < nvec) {
        float f[V];
        unpack<T>(raw[k], f);
        *reinterpret_cast<uint4*>(o + at(v)) = normalise<T, V>(p, f, v, mean, rstd);
      }
    }
  } else {
    float s = 0.0f;
    for (int v = lane; v < nvec; v += 32) {
      float f[V];
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(x + at(v))), f);
      const int live = p.n_logical - v * V;
#pragma unroll
      for (int e = 0; e < V; ++e) s += e < live ? f[e] : 0.0f;
    }
    const float mean = warp_sum(s) / n;
    float q = 0.0f;
    for (int v = lane; v < nvec; v += 32) {
      float f[V];
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(x + at(v))), f);
      const int live = p.n_logical - v * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = f[e] - mean;
        q += e < live ? d * d : 0.0f;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / n + p.eps);
    for (int v = lane; v < nvec; v += 32) {
      float f[V];
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(x + at(v))), f);
      *reinterpret_cast<uint4*>(o + at(v)) = normalise<T, V>(p, f, v, mean, rstd);
    }
  }
}

template <typename T, int BN>
void launch(const LnArgs& p, int nv, dim3 grid, cudaStream_t s) {
  switch (nv) {
    case 0: bwma_layernorm_kernel<T, BN, 0><<<grid, 32 * kRows, 0, s>>>(p); break;
    case 1: bwma_layernorm_kernel<T, BN, 1><<<grid, 32 * kRows, 0, s>>>(p); break;
    case 2: bwma_layernorm_kernel<T, BN, 2><<<grid, 32 * kRows, 0, s>>>(p); break;
    case 4: bwma_layernorm_kernel<T, BN, 4><<<grid, 32 * kRows, 0, s>>>(p); break;
    case 8: bwma_layernorm_kernel<T, BN, 8><<<grid, 32 * kRows, 0, s>>>(p); break;
    default: bwma_layernorm_kernel<T, BN, 16><<<grid, 32 * kRows, 0, s>>>(p); break;
  }
}

template <typename T>
int dispatch(const LnArgs& p, int lead0, int bn, int nv, void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const long long width = static_cast<long long>(p.gn) * bn;
  // nv: 0 (looped) or a power of two up to kMaxVectors that covers the row
  const bool nv_ok = nv == 0 || ((nv & (nv - 1)) == 0 && nv <= kMaxVectors &&
                                 32LL * nv * V >= width);
  if (lead0 < 1 || p.lead1 < 1 || static_cast<long long>(lead0) * p.lead1 > 65535 ||
      p.n_logical < 1 || p.n_logical > width || p.bm % kRows != 0 || !nv_ok)
    return cudaErrorInvalidValue;
  const dim3 grid(p.gm * p.bm / kRows, lead0 * p.lead1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: launch<T, 8>(p, nv, grid, s); break;
    case 16: launch<T, 16>(p, nv, grid, s); break;
    case 32: launch<T, 32>(p, nv, grid, s); break;
    case 64: launch<T, 64>(p, nv, grid, s); break;
    case 128: launch<T, 128>(p, nv, grid, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x_bf16 selects x's (and out's) type; gamma_bf16 / beta_bf16 those of the
// parameters.  vectors_per_lane comes from the host's plan.
extern "C" int bwma_layernorm(const void* x, const void* gamma, const void* beta, void* out,
                              int x_bf16, int gamma_bf16, int beta_bf16, int lead0, int lead1,
                              long long x_s0, long long x_s1, int gm, int gn, int bm, int bn,
                              int n_logical, float eps, int vectors_per_lane,
                              void* stream) {
  const LnArgs p{x, gamma, beta, out, gamma_bf16 != 0, beta_bf16 != 0, lead1, x_s0, x_s1,
                 gm, gn, bm, n_logical, eps};
  return x_bf16 ? dispatch<__nv_bfloat16>(p, lead0, bn, vectors_per_lane, stream)
                : dispatch<float>(p, lead0, bn, vectors_per_lane, stream);
}

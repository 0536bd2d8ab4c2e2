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
// written once, so the bytes (3.35 TB/s HBM3 on an H100 SXM); at BERT-base
// scores (4 x 12 heads of 512 x 512 fp32) that is 100.7 MB, 30 us.
//
// Design (the LayerNorm kernel's, csrc/bwma_layernorm.cu):
// - Rows, not block-rows, set the grid.  One warp owns one logical row; a
//   CTA holds kRows rows, numbered across the whole operand (the leading
//   dims fold in, since it is contiguous), so a CTA may straddle two
//   block-rows and the last CTA guards its tail: any bm works.  At BERT-base
//   scores that is 6144 CTAs at every block size.  kRows 4 was as fast as 8
//   in fp32 and faster in bf16 on an H100 (PERF.md).
// - The row lives in registers: read once from device memory, written once.
//   A lane loads 16 bytes at a time (4 fp32 or 8 bf16), lane l taking the
//   row's vectors l, l + 32, ...; a bn-run is contiguous, so neighbouring
//   lanes read neighbouring addresses at every bn in 8..128.  Every load is
//   issued before the first reduction.  The row max and the sum of
//   exponentials are warp-shuffle reductions in a fixed order (no atomics:
//   the same bits run to run).  The exponentials stay in registers for the
//   output where they fit (every fp32 row, bf16 up to NV 8), so each is
//   computed once; the masks select on arguments, never on results, so the
//   output leaves as whole 16-byte stores.
// - NV, the 16-byte vectors a lane holds, is a template parameter (1, 2, 4,
//   8 or 16).  A row wider than 16 * 32 vectors -- 2048 fp32 or 4096 bf16
//   columns of padded width -- takes the looped path (NV = 0): one pass
//   with a running max and a rescaled running sum, kChunk vectors a lane at
//   a time, then a second pass that writes.  Two reads and one write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxVectors = 16;  // per lane on the register path
constexpr int kRows = 4;         // rows (one warp each) per CTA
constexpr int kChunk = 4;        // vectors a lane loads at once on the looped path

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

// The masks select on the arguments, never on an exponential: a masked
// column enters the max as -inf and the sum as exp(-inf) = 0, so no branch
// splits a vector and each output vector is one 16-byte store.  live: the
// columns of the vector inside n_logical (<= 0 for a vector wholly masked or
// past the row).
template <int V>
__device__ __forceinline__ float vec_max(float m, const float* f, int live) {
#pragma unroll
  for (int c = 0; c < V; ++c) m = fmaxf(m, c < live ? f[c] : -INFINITY);
  return m;
}

template <int V>
__device__ __forceinline__ void vec_exp(const float* f, int live, float m, float* e) {
#pragma unroll
  for (int c = 0; c < V; ++c) e[c] = expf(c < live ? f[c] - m : -INFINITY);
}

template <int V>
__device__ __forceinline__ float vec_sum_exp(float s, const float* f, int live, float m) {
  float e[V];
  vec_exp<V>(f, live, m, e);
#pragma unroll
  for (int c = 0; c < V; ++c) s += e[c];
  return s;
}

// The output vector: masked columns 0, the rest e / den
template <typename T, int V>
__device__ __forceinline__ uint4 normalise(const uint4& raw, int live, float m, float den) {
  float f[V];
  unpack<T>(raw, f);
  vec_exp<V>(f, live, m, f);
#pragma unroll
  for (int c = 0; c < V; ++c) f[c] /= den;
  return pack<T>(f);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const uint4& y) {
  __stwb(reinterpret_cast<uint4*>(p), y);
}

template <typename T, int BN, int NV>
__global__ void __launch_bounds__(32 * kRows)
bwma_softmax_kernel(const T* __restrict__ x, T* __restrict__ out, long long rows, int gn,
                    int bm, int n_logical, float fill) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
  constexpr int VPB = BN / V;                            // vectors per bn-run
  static_assert(VPB >= 1 && (VPB & (VPB - 1)) == 0, "bn must be a power of two >= 16 bytes");
  const long long row = static_cast<long long>(blockIdx.x) * kRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // the last CTA's tail (a whole warp)
  const int lane = threadIdx.x & 31;
  const long long br = row / bm;  // block-row (once per warp)
  const int r = static_cast<int>(row - br * bm);
  const long long base = (br * gn * bm + r) * BN;
  const T* xr = x + base;
  T* orow = out + base;
  const long long jstride = static_cast<long long>(bm) * BN;  // between a row's bn-runs
  const int nvec = gn * VPB;  // vectors in the padded row
  // a vector's offset in the row: its bn-run (a shift) and its place in it (a mask)
  auto at = [&](int v) {
    const unsigned u = static_cast<unsigned>(v);
    return (u / VPB) * jstride + (u % VPB) * V;
  };
  // the masked fill enters the max only where a masked column exists
  const float m0 = n_logical < nvec * V ? fill : -INFINITY;

  if constexpr (NV > 0) {
    uint4 raw[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      raw[k] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(xr + at(v))) : make_uint4(0, 0, 0, 0);
    }
    float m = m0;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[V];
      unpack<T>(raw[k], f);
      m = vec_max<V>(m, f, n_logical - (lane + 32 * k) * V);
    }
    m = warp_max(m);
    // the exponentials stay in registers where they fit (every fp32 row, bf16
    // up to NV 8); wider bf16 rows compute them again for the output
    constexpr bool kKeep = NV * V <= 64;
    float e[kKeep ? NV : 1][V];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float f[V];
      unpack<T>(raw[k], f);
      const int live = n_logical - (lane + 32 * k) * V;
      if constexpr (kKeep) {
        vec_exp<V>(f, live, m, e[k]);
#pragma unroll
        for (int c = 0; c < V; ++c) s += e[k][c];
      } else {
        s = vec_sum_exp<V>(s, f, live, m);
      }
    }
    const float den = fmaxf(warp_sum(s), 1e-30f);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int v = lane + 32 * k;
      if (v >= nvec) continue;
      if constexpr (kKeep) {
#pragma unroll
        for (int c = 0; c < V; ++c) e[k][c] /= den;  // masked: 0 / den = 0
        store(orow + at(v), pack<T>(e[k]));
      } else {
        store(orow + at(v), normalise<T, V>(raw[k], n_logical - v * V, m, den));
      }
    }
  } else {
    // pass 1: a lane's running max m and its sum s of exp(x - m), rescaled
    // when a chunk raises m
    float m = m0, s = 0.0f;
    for (int v0 = lane; v0 < nvec; v0 += 32 * kChunk) {
      uint4 raw[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int v = v0 + 32 * c;
        raw[c] = v < nvec ? __ldg(reinterpret_cast<const uint4*>(xr + at(v))) : make_uint4(0, 0, 0, 0);
      }
      float cm = m;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float f[V];
        unpack<T>(raw[c], f);
        cm = vec_max<V>(cm, f, n_logical - (v0 + 32 * c) * V);
      }
      if (cm > m) {
        s = s > 0.0f ? s * expf(m - cm) : 0.0f;
        m = cm;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float f[V];
        unpack<T>(raw[c], f);
        s = vec_sum_exp<V>(s, f, n_logical - (v0 + 32 * c) * V, m);
      }
    }
    const float mx = warp_max(m);
    const float den = fmaxf(warp_sum(s > 0.0f ? s * expf(m - mx) : 0.0f), 1e-30f);
    // pass 2: read the row again and write it
    for (int v0 = lane; v0 < nvec; v0 += 32 * kChunk) {
      uint4 raw[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int v = v0 + 32 * c;
        if (v < nvec) raw[c] = __ldg(reinterpret_cast<const uint4*>(xr + at(v)));
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int v = v0 + 32 * c;
        if (v < nvec)
          store(orow + at(v), normalise<T, V>(raw[c], n_logical - v * V, mx, den));
      }
    }
  }
}

template <typename T, int BN>
void launch(const T* x, T* out, long long rows, int gn, int bm, int n_logical, float fill,
            int nv, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((rows + kRows - 1) / kRows);
  switch (nv) {
    case 0: bwma_softmax_kernel<T, BN, 0><<<grid, 32 * kRows, 0, s>>>(x, out, rows, gn, bm, n_logical, fill); break;
    case 1: bwma_softmax_kernel<T, BN, 1><<<grid, 32 * kRows, 0, s>>>(x, out, rows, gn, bm, n_logical, fill); break;
    case 2: bwma_softmax_kernel<T, BN, 2><<<grid, 32 * kRows, 0, s>>>(x, out, rows, gn, bm, n_logical, fill); break;
    case 4: bwma_softmax_kernel<T, BN, 4><<<grid, 32 * kRows, 0, s>>>(x, out, rows, gn, bm, n_logical, fill); break;
    case 8: bwma_softmax_kernel<T, BN, 8><<<grid, 32 * kRows, 0, s>>>(x, out, rows, gn, bm, n_logical, fill); break;
    default: bwma_softmax_kernel<T, BN, 16><<<grid, 32 * kRows, 0, s>>>(x, out, rows, gn, bm, n_logical, fill); break;
  }
}

template <typename T>
int dispatch(const void* x, void* out, long long block_rows, int gn, int bm, int bn,
             int n_logical, int nv, float fill, void* stream) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte vector
  const long long width = static_cast<long long>(gn) * bn;
  const long long rows = block_rows * bm;
  // nv: 0 (looped) or a power of two up to kMaxVectors that covers the row
  const bool nv_ok = nv == 0 || ((nv & (nv - 1)) == 0 && nv <= kMaxVectors &&
                                 32LL * nv * V >= width);
  if (block_rows < 1 || gn < 1 || bm < 1 || n_logical < 1 || n_logical > width || !nv_ok ||
      (rows + kRows - 1) / kRows > 2147483647LL || width > 2147483647LL ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: launch<T, 8>(xt, ot, rows, gn, bm, n_logical, fill, nv, s); break;
    case 16: launch<T, 16>(xt, ot, rows, gn, bm, n_logical, fill, nv, s); break;
    case 32: launch<T, 32>(xt, ot, rows, gn, bm, n_logical, fill, nv, s); break;
    case 64: launch<T, 64>(xt, ot, rows, gn, bm, n_logical, fill, nv, s); break;
    case 128: launch<T, 128>(xt, ot, rows, gn, bm, n_logical, fill, nv, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// vectors_per_lane comes from the host's plan (0: the looped path).
extern "C" int bwma_softmax_f32(const void* x, void* out, long long block_rows, int gn,
                                int bm, int bn, int n_logical, int vectors_per_lane,
                                void* stream) {
  return dispatch<float>(x, out, block_rows, gn, bm, bn, n_logical, vectors_per_lane,
                         -FLT_MAX, stream);
}

// finfo(bfloat16).min = -(2 - 2^-7) * 2^127, exactly representable in fp32
extern "C" int bwma_softmax_bf16(const void* x, void* out, long long block_rows, int gn,
                                 int bm, int bn, int n_logical, int vectors_per_lane,
                                 void* stream) {
  return dispatch<__nv_bfloat16>(x, out, block_rows, gn, bm, bn, n_logical, vectors_per_lane,
                                 -3.3895313892515355e38f, stream);
}

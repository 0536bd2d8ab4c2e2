// The tiled fp32 GEMM loop shared by bwma_gemm.cu (blocked operands, the
// paper's BWMA arrangement) and rwma_gemm.cu (row-major operands, the
// paper's RWMA baseline), for Hopper (sm_90a).
//
// One CTA owns one bm x bn output tile and loops over the gk k-tiles, which
// takes the place of the TPU grid's sequential k axis.  The tile is staged
// into shared memory in k-slices of KS columns with 16-byte loads, and a
// thread keeps an RM x RN register tile of the accumulator, strided across
// the tile so shared-memory reads broadcast instead of conflicting.  FFMA
// only: TF32 keeps about three decimal digits and would break fp32 parity.
//
// The two arrangements differ only in where a tile's rows lie:
//   BWMA (RWMA = false): a is (..., gm, gk, bm, bk) and b (..., gk, gn, bk,
//     bn), so every operand tile is one contiguous run -- a row stride of
//     bk (a) or bn (b), and b's KS-row slice is a single run too.
//   RWMA (RWMA = true): a is (M, K) and b (K, N) row-major, so a tile is bm
//     (or bk) row segments at a stride of K (or N) elements; out (M, N) is
//     written the same way.  No lead dims.
// The CTA's work, its shared memory and its arithmetic are the same in both;
// only the addressing -- one burst or many strided segments -- differs,
// which is the paper's comparison.

#pragma once

#include <cuda_runtime.h>

namespace gemm_tile {

struct GemmArgs {
  const float* a;
  const float* b;
  const float* bias;  // (gn, bn), only read by the fused variant
  float* out;
  int lead1;                // second lead dim; gridDim.z = lead0 * lead1
  long long a_s0, a_s1;     // element strides of a along the two lead dims
  long long b_s0, b_s1;
  int gm, gn, gk, bk;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

template <int BM, int BN>
struct Tile {
  static constexpr int TY = BM < 16 ? BM : 16;  // thread rows
  static constexpr int TX = BN < 16 ? BN : 16;  // thread columns
  static constexpr int THREADS = TY * TX;
  static constexpr int RM = BM / TY;  // accumulator rows per thread
  static constexpr int RN = BN / TX;  // accumulator columns per thread
};

template <int BM, int BN, int KS, bool FUSED, bool RWMA>
__global__ void __launch_bounds__((BM < 16 ? BM : 16) * (BN < 16 ? BN : 16))
gemm_kernel(GemmArgs p) {
  using T = Tile<BM, BN>;
  constexpr int AS = KS + 4;  // padded A-slice row: 16-byte aligned, fewer conflicts
  __shared__ __align__(16) float As[BM * AS];
  __shared__ __align__(16) float Bs[KS * BN];

  const int jb = blockIdx.x;
  const int ib = blockIdx.y;
  const int z = blockIdx.z;
  const int l0 = z / p.lead1;
  const int l1 = z - l0 * p.lead1;
  const int tid = threadIdx.x;
  const int tx = tid % T::TX;
  const int ty = tid / T::TX;
  const int bk = p.bk;

  // Tile (ib, kb) of a starts at a_row + kb * a_kstep, its rows a_ld apart;
  // tile (kb, jb) of b starts at b_col + kb * b_kstep, its rows b_ld apart.
  const float* a_row;
  const float* b_col;
  long long a_kstep, b_kstep, a_ld, b_ld;
  if constexpr (RWMA) {
    const long long K = static_cast<long long>(p.gk) * bk;
    const long long N = static_cast<long long>(p.gn) * BN;
    a_row = p.a + static_cast<long long>(ib) * BM * K;
    b_col = p.b + static_cast<long long>(jb) * BN;
    a_kstep = bk;
    b_kstep = bk * N;
    a_ld = K;
    b_ld = N;
  } else {
    // successive k-blocks of a are adjacent, successive k-blocks of b are a
    // whole block-row (gn blocks) apart
    a_row = p.a + l0 * p.a_s0 + l1 * p.a_s1 +
            static_cast<long long>(ib) * p.gk * BM * bk;
    b_col = p.b + l0 * p.b_s0 + l1 * p.b_s1 + static_cast<long long>(jb) * bk * BN;
    a_kstep = static_cast<long long>(BM) * bk;
    b_kstep = static_cast<long long>(p.gn) * bk * BN;
    a_ld = bk;
    b_ld = BN;
  }

  float acc[T::RM][T::RN];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::RN; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < p.gk; ++kb) {
    const float* ablk = a_row + kb * a_kstep;
    const float* bblk = b_col + kb * b_kstep;
    for (int k0 = 0; k0 < bk; k0 += KS) {
      __syncthreads();  // the previous slice has been consumed
      // A slice: BM rows of KS contiguous floats, a_ld apart.
      for (int v = tid; v < BM * (KS / 4); v += T::THREADS) {
        const int r = v / (KS / 4);
        const int c = (v - r * (KS / 4)) * 4;
        const float4 t = *reinterpret_cast<const float4*>(ablk + r * a_ld + k0 + c);
        *reinterpret_cast<float4*>(&As[r * AS + c]) = t;
      }
      if constexpr (RWMA) {
        // B slice: KS row segments of BN floats, b_ld apart.
        for (int v = tid; v < KS * (BN / 4); v += T::THREADS) {
          const int r = v / (BN / 4);
          const int c = (v - r * (BN / 4)) * 4;
          const float4 t =
              *reinterpret_cast<const float4*>(bblk + (k0 + r) * b_ld + c);
          *reinterpret_cast<float4*>(&Bs[r * BN + c]) = t;
        }
      } else {
        // B slice: KS whole rows of the block, one contiguous run.
        const float4* bsrc = reinterpret_cast<const float4*>(bblk + k0 * b_ld);
        for (int v = tid; v < KS * BN / 4; v += T::THREADS)
          reinterpret_cast<float4*>(Bs)[v] = bsrc[v];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float av[T::RM];
        float bv[T::RN];
#pragma unroll
        for (int i = 0; i < T::RM; ++i) av[i] = As[(ty + i * T::TY) * AS + kk];
#pragma unroll
        for (int j = 0; j < T::RN; ++j) bv[j] = Bs[kk * BN + tx + j * T::TX];
#pragma unroll
        for (int i = 0; i < T::RM; ++i)
#pragma unroll
          for (int j = 0; j < T::RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  float* o;
  long long o_ld;
  if constexpr (RWMA) {
    o_ld = static_cast<long long>(p.gn) * BN;
    o = p.out + static_cast<long long>(ib) * BM * o_ld + static_cast<long long>(jb) * BN;
  } else {
    o_ld = BN;
    o = p.out + (static_cast<long long>(z) * p.gm * p.gn +
                 static_cast<long long>(ib) * p.gn + jb) * (BM * BN);
  }
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int r = ty + i * T::TY;
#pragma unroll
    for (int j = 0; j < T::RN; ++j) {
      const int c = tx + j * T::TX;
      float val = acc[i][j];
      if (FUSED) val = gelu_tanh(val + p.bias[jb * BN + c]);
      o[r * o_ld + c] = val;
    }
  }
}

template <int BM, int BN, bool FUSED, bool RWMA>
cudaError_t launch(const GemmArgs& p, int lead, cudaStream_t stream) {
  const dim3 grid(p.gn, p.gm, lead);
  const int threads = Tile<BM, BN>::THREADS;
  if (p.bk == 8) {
    gemm_kernel<BM, BN, 8, FUSED, RWMA><<<grid, threads, 0, stream>>>(p);
  } else {
    gemm_kernel<BM, BN, 16, FUSED, RWMA><<<grid, threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int BM, bool FUSED, bool RWMA>
cudaError_t dispatch_bn(int bn, const GemmArgs& p, int lead, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch<BM, 8, FUSED, RWMA>(p, lead, stream);
    case 16: return launch<BM, 16, FUSED, RWMA>(p, lead, stream);
    case 32: return launch<BM, 32, FUSED, RWMA>(p, lead, stream);
    case 64: return launch<BM, 64, FUSED, RWMA>(p, lead, stream);
    case 128: return launch<BM, 128, FUSED, RWMA>(p, lead, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED, bool RWMA>
cudaError_t dispatch(int bm, int bn, const GemmArgs& p, int lead, cudaStream_t stream) {
  switch (bm) {
    case 8: return dispatch_bn<8, FUSED, RWMA>(bn, p, lead, stream);
    case 16: return dispatch_bn<16, FUSED, RWMA>(bn, p, lead, stream);
    case 32: return dispatch_bn<32, FUSED, RWMA>(bn, p, lead, stream);
    case 64: return dispatch_bn<64, FUSED, RWMA>(bn, p, lead, stream);
    case 128: return dispatch_bn<128, FUSED, RWMA>(bn, p, lead, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED, bool RWMA>
int run(const float* a, const float* b, const float* bias, float* out,
        int lead0, int lead1, long long a_s0, long long a_s1, long long b_s0,
        long long b_s1, int gm, int gn, int gk, int bm, int bn, int bk,
        void* stream) {
  // bk is staged in slices of 8 (bk == 8) or 16 (bk in 16..128).
  if (bk != 8 && (bk % 16 != 0 || bk > 128)) return cudaErrorInvalidValue;
  if (gm > 65535 || lead0 * lead1 > 65535) return cudaErrorInvalidValue;
  const GemmArgs p{a, b, bias, out, lead1, a_s0, a_s1, b_s0, b_s1, gm, gn, gk, bk};
  return dispatch<FUSED, RWMA>(bm, bn, p, lead0 * lead1,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace gemm_tile

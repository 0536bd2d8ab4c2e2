// Blocked (BWMA) GEMM, and the same GEMM with a fused bias + tanh-GELU
// epilogue, in fp32 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/bwma_gemm.py:_gemm_kernel
// (launched by _gemm_4d from bwma_gemm) and
// repro/kernels/bwma_fused_ffn.py:_ffn_kernel (launched by _ffn_4d from
// bwma_fused_ffn).
//
//   out[l, i, j] = sum_k a[l, i, k] @ b[l, k, j]          (bwma_gemm)
//   out[l, i, j] = gelu_tanh(sum_k ... + bias[j])          (bwma_fused_ffn)
//
// with a (..., gm, gk, bm, bk), b (..., gk, gn, bk, bn), bias (gn, bn) and
// out (..., gm, gn, bm, bn); the leading dims l are folded into gridDim.z
// with per-operand strides that are 0 where an operand broadcasts, so
// shared weights are never copied per batch or head.
//
// What bounds it on this card: at the encoder's shapes every product does
// hundreds of multiply-adds per byte it must move, so it is bound by
// operations.  It runs in full fp32 on the FFMA units (67 TFLOP/s on an
// H100 SXM), because the TF32 tensor-core path keeps about three decimal
// digits and would break parity with the fp32 reference.
//
// Design: one CTA owns one output block (l, i, j) and loops over the gk
// k-blocks, which takes the place of the TPU grid's sequential k axis.
// Every operand block is one contiguous bm x bk (or bk x bn) run -- the
// paper's arrangement -- so it is staged into shared memory with coalesced
// 16-byte loads, in k-slices of KS columns so shared memory stays small
// (at most 18 KB at 128 x 128 blocks).  A thread keeps an RM x RN register
// tile of the accumulator, strided across the block so shared-memory reads
// broadcast instead of conflicting.  The epilogue applies bias + GELU to the
// accumulator in registers before the single store, as the TPU kernel does
// at its last k step.  No double buffering, no tensor cores: simple first.

#include <cuda_runtime.h>

namespace {

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

template <int BM, int BN, int KS, bool FUSED>
__global__ void __launch_bounds__((BM < 16 ? BM : 16) * (BN < 16 ? BN : 16))
bwma_gemm_kernel(GemmArgs p) {
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

  // a[l, ib, 0] and b[l, 0, jb]; successive k-blocks of a are adjacent,
  // successive k-blocks of b are a whole block-row (gn blocks) apart.
  const float* a_row = p.a + l0 * p.a_s0 + l1 * p.a_s1 +
                       static_cast<long long>(ib) * p.gk * BM * bk;
  const float* b_col = p.b + l0 * p.b_s0 + l1 * p.b_s1 +
                       static_cast<long long>(jb) * bk * BN;
  const long long b_kstep = static_cast<long long>(p.gn) * bk * BN;

  float acc[T::RM][T::RN];
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int j = 0; j < T::RN; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < p.gk; ++kb) {
    const float* ablk = a_row + static_cast<long long>(kb) * BM * bk;
    const float* bblk = b_col + kb * b_kstep;
    for (int k0 = 0; k0 < bk; k0 += KS) {
      __syncthreads();  // the previous slice has been consumed
      // A slice: BM rows of KS contiguous floats, row stride bk.
      for (int v = tid; v < BM * (KS / 4); v += T::THREADS) {
        const int r = v / (KS / 4);
        const int c = (v - r * (KS / 4)) * 4;
        const float4 t = *reinterpret_cast<const float4*>(
            ablk + static_cast<long long>(r) * bk + k0 + c);
        *reinterpret_cast<float4*>(&As[r * AS + c]) = t;
      }
      // B slice: KS whole rows of the block, one contiguous run.
      const float4* bsrc =
          reinterpret_cast<const float4*>(bblk + static_cast<long long>(k0) * BN);
      for (int v = tid; v < KS * BN / 4; v += T::THREADS)
        reinterpret_cast<float4*>(Bs)[v] = bsrc[v];
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

  float* o = p.out + (static_cast<long long>(z) * p.gm * p.gn +
                      static_cast<long long>(ib) * p.gn + jb) * (BM * BN);
#pragma unroll
  for (int i = 0; i < T::RM; ++i) {
    const int r = ty + i * T::TY;
#pragma unroll
    for (int j = 0; j < T::RN; ++j) {
      const int c = tx + j * T::TX;
      float val = acc[i][j];
      if (FUSED) val = gelu_tanh(val + p.bias[jb * BN + c]);
      o[r * BN + c] = val;
    }
  }
}

template <int BM, int BN, bool FUSED>
cudaError_t launch(const GemmArgs& p, int lead, cudaStream_t stream) {
  const dim3 grid(p.gn, p.gm, lead);
  const int threads = Tile<BM, BN>::THREADS;
  if (p.bk == 8) {
    bwma_gemm_kernel<BM, BN, 8, FUSED><<<grid, threads, 0, stream>>>(p);
  } else {
    bwma_gemm_kernel<BM, BN, 16, FUSED><<<grid, threads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int BM, bool FUSED>
cudaError_t dispatch_bn(int bn, const GemmArgs& p, int lead, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch<BM, 8, FUSED>(p, lead, stream);
    case 16: return launch<BM, 16, FUSED>(p, lead, stream);
    case 32: return launch<BM, 32, FUSED>(p, lead, stream);
    case 64: return launch<BM, 64, FUSED>(p, lead, stream);
    case 128: return launch<BM, 128, FUSED>(p, lead, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED>
cudaError_t dispatch(int bm, int bn, const GemmArgs& p, int lead, cudaStream_t stream) {
  switch (bm) {
    case 8: return dispatch_bn<8, FUSED>(bn, p, lead, stream);
    case 16: return dispatch_bn<16, FUSED>(bn, p, lead, stream);
    case 32: return dispatch_bn<32, FUSED>(bn, p, lead, stream);
    case 64: return dispatch_bn<64, FUSED>(bn, p, lead, stream);
    case 128: return dispatch_bn<128, FUSED>(bn, p, lead, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool FUSED>
int run(const float* a, const float* b, const float* bias, float* out,
        int lead0, int lead1, long long a_s0, long long a_s1, long long b_s0,
        long long b_s1, int gm, int gn, int gk, int bm, int bn, int bk,
        void* stream) {
  // bk is staged in slices of 8 (bk == 8) or 16 (bk in 16..128).
  if (bk != 8 && (bk % 16 != 0 || bk > 128)) return cudaErrorInvalidValue;
  if (gm > 65535 || lead0 * lead1 > 65535) return cudaErrorInvalidValue;
  const GemmArgs p{a, b, bias, out, lead1, a_s0, a_s1, b_s0, b_s1, gm, gn, gk, bk};
  return dispatch<FUSED>(bm, bn, p, lead0 * lead1,
                         static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int bwma_gemm_f32(const float* a, const float* b, float* out,
                             int lead0, int lead1, long long a_s0,
                             long long a_s1, long long b_s0, long long b_s1,
                             int gm, int gn, int gk, int bm, int bn, int bk,
                             void* stream) {
  return run<false>(a, b, nullptr, out, lead0, lead1, a_s0, a_s1, b_s0, b_s1,
                    gm, gn, gk, bm, bn, bk, stream);
}

extern "C" int bwma_fused_ffn_f32(const float* a, const float* b,
                                  const float* bias, float* out, int lead0,
                                  int lead1, long long a_s0, long long a_s1,
                                  long long b_s0, long long b_s1, int gm,
                                  int gn, int gk, int bm, int bn, int bk,
                                  void* stream) {
  return run<true>(a, b, bias, out, lead0, lead1, a_s0, a_s1, b_s0, b_s1, gm,
                   gn, gk, bm, bn, bk, stream);
}

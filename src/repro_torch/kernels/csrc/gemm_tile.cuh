// The fp32 GEMM tile loop shared by bwma_gemm.cu (blocked operands, the
// paper's BWMA arrangement) and rwma_gemm.cu (row-major operands, the
// paper's RWMA baseline), for Hopper (sm_90a).
//
// What bounds it: at the encoder's and the serving prefill's shapes a
// product does hundreds of multiply-adds per byte it must move, so it is
// bound by operations, on the FFMA units (67 TFLOP/s fp32 on an H100 SXM).
// FFMA only: TF32 keeps about three decimal digits and would break fp32
// parity, and wgmma takes no fp32 inputs.  Skinny products (16-24 rows
// against a weight matrix) are bound by the bytes of the weights instead.
//
// Design:
// - The CTA tile is not the data block.  A CTA computes a CM x CN output
//   super-tile, one of a few instantiations (128 x 128 down to 16 x 64),
//   which the host picks per product (kernels/bwma_gemm.py:gemm_plan): the
//   largest tile that still fills the card's SMs, narrower for the
//   per-head products (N = 64) and shorter for the serving products
//   (M = 16 or 24).  For the blocked arrangement the tile is a multiple of
//   the data block, and the CTA skips the blocks past gm and gn whole.
// - Register tiling: each of the CTA's threads keeps a TM x TN accumulator
//   (8 x 8 at 128 x 128).  A is read from shared memory as 16-byte vectors
//   along k, B as 16-byte vectors along n; at 8 x 8 that is 16 FFMAs per
//   shared-memory load instruction.
// - Staging: k-slices of KS = 16 columns go through a STAGES-deep ring in
//   shared memory with 16-byte cp.async (cp.async.cg.shared.global); the
//   next slices load while the current one is consumed.  A chunk past the
//   valid rows, columns or K is zero-filled (src-size 0), which adds exact
//   zeros to the sums.
// - Epilogue: the fused variant applies bias + tanh-GELU in registers
//   before the single store; stores are 16 bytes.
// - Numerics: no split-K, no atomics.  Each output element is summed by one
//   thread in k order, so a result is the same bits run to run.
//
// The two arrangements differ only in where an operand element lies (the
// *_offset functions below); the copies, the shared-memory layout and the
// arithmetic are the same, which is the paper's comparison:
//   BWMA (RWMA = false): a is (..., gm, gk, bm, bk), b (..., gk, gn, bk, bn)
//     and out (..., gm, gn, bm, bn); a 16-byte chunk lies inside one block
//     and a block's rows are one contiguous run.
//   RWMA (RWMA = true): a (M, K), b (K, N) and out (M, N) row-major; a
//     tile is row segments at a stride of K (or N) elements.  No lead dims.

#pragma once

#include <cuda_runtime.h>

namespace gemm_tile {

constexpr int STAGES = 4;     // depth of the cp.async ring of k-slices
static_assert(STAGES >= 2, "the ring needs two stages");
// Thread rows of one warp: 4 makes a warp 4 x 8 threads, so its 16-byte
// reads of A and of B each take one shared-memory wavefront.
constexpr int WARP_ROWS = 4;
constexpr int KS = 16;      // k-slice staged per pipeline stage
constexpr int A_PAD = 4;    // A-slice row padding: 16-byte aligned, no conflicts

struct GemmArgs {
  const float* a;
  const float* b;
  const float* bias;  // (gn, bn) / (N,), only read by the fused variant
  float* out;
  int lead1;                // second lead dim; gridDim.z = lead0 * lead1
  long long a_s0, a_s1;     // element strides of a along the two lead dims
  long long b_s0, b_s1;
  int rows, cols, K;        // valid output rows and columns, inner length
  int gm, gn, gk, bm, bn, bk;
  int lbm, lbn, lbk;        // log2 of the (power-of-two) blocks; BWMA only
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

__device__ __forceinline__ void cp_async16(void* smem, const float* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: read nothing, fill zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element offsets of a(row, k), b(k, col) and out(row, col) within one lead
// slot, each split into a part that depends on the row (or column) and one
// that depends on k, so a thread computes the first once per chunk.
template <bool RWMA>
__device__ __forceinline__ long long a_row_offset(const GemmArgs& p, int r) {
  if constexpr (RWMA) return static_cast<long long>(r) * p.K;
  return static_cast<long long>(r >> p.lbm) * p.gk * p.bm * p.bk +
         static_cast<long long>(r & (p.bm - 1)) * p.bk;
}

template <bool RWMA>
__device__ __forceinline__ long long a_k_offset(const GemmArgs& p, int k) {
  if constexpr (RWMA) return k;
  return static_cast<long long>(k >> p.lbk) * p.bm * p.bk + (k & (p.bk - 1));
}

template <bool RWMA>
__device__ __forceinline__ long long b_col_offset(const GemmArgs& p, int c) {
  if constexpr (RWMA) return c;
  return static_cast<long long>(c >> p.lbn) * p.bk * p.bn + (c & (p.bn - 1));
}

template <bool RWMA>
__device__ __forceinline__ long long b_k_offset(const GemmArgs& p, int k) {
  if constexpr (RWMA) return static_cast<long long>(k) * p.cols;
  return static_cast<long long>(k >> p.lbk) * p.gn * p.bk * p.bn +
         static_cast<long long>(k & (p.bk - 1)) * p.bn;
}

template <bool RWMA>
__device__ __forceinline__ long long out_offset(const GemmArgs& p, int r, int c) {
  if constexpr (RWMA) return static_cast<long long>(r) * p.cols + c;
  return (static_cast<long long>(r >> p.lbm) * p.gn + (c >> p.lbn)) * p.bm * p.bn +
         (r & (p.bm - 1)) * p.bn + (c & (p.bn - 1));
}

template <int CM, int CN, int TM, int TN>
struct Cta {
  static constexpr int TY = CM / TM;             // thread rows
  static constexpr int TX = CN / TN;             // thread columns
  static constexpr int THREADS = TY * TX;
  static constexpr int GROUPS = TN / 4;          // 4-column groups per thread
  static constexpr int GROUP_STRIDE = CN / GROUPS;
  static constexpr int AS = KS + A_PAD;          // A-slice row stride (floats)
  static constexpr int A_STAGE = CM * AS;        // floats per stage
  static constexpr int B_STAGE = KS * CN;
  static constexpr int A_CHUNKS = CM * KS / 4;   // 16-byte chunks per slice
  static constexpr int B_CHUNKS = KS * CN / 4;
  static constexpr int A_ITERS = (A_CHUNKS + THREADS - 1) / THREADS;
  static constexpr int B_ITERS = (B_CHUNKS + THREADS - 1) / THREADS;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // at most 128 registers a thread
  static constexpr size_t SMEM = sizeof(float) * STAGES * (A_STAGE + B_STAGE);
  static constexpr int WR = WARP_ROWS;           // thread rows of one warp
  static constexpr int WC = 32 / WR;             // thread columns of one warp
  static_assert(TY % WR == 0 && TX % WC == 0, "warps must tile the CTA");
  static_assert(TN % 4 == 0 && CM % TM == 0 && CN % TN == 0, "bad CTA tile");
  static_assert(THREADS % (CN / 4) == 0, "a thread's B chunks share one column");
};

template <int CM, int CN, int TM, int TN, bool FUSED, bool RWMA>
__global__ void __launch_bounds__(Cta<CM, CN, TM, TN>::THREADS,
                                  Cta<CM, CN, TM, TN>::MIN_BLOCKS)
gemm_kernel(GemmArgs p) {
  using T = Cta<CM, CN, TM, TN>;
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);
  float* const Bs = As + STAGES * T::A_STAGE;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // thread (ty, tx) of the TY x TX grid: warps tile it in WR x WC blocks
  const int tx = (warp % (T::TX / T::WC)) * T::WC + lane % T::WC;
  const int ty = (warp / (T::TX / T::WC)) * T::WR + lane / T::WC;
  const int row0 = blockIdx.y * CM;
  const int col0 = blockIdx.x * CN;
  const int z = blockIdx.z;
  const int l0 = z / p.lead1;
  const int l1 = z - l0 * p.lead1;
  const float* const a = p.a + l0 * p.a_s0 + l1 * p.a_s1;
  const float* const b = p.b + l0 * p.b_s0 + l1 * p.b_s1;

  // This thread's copies: the row (A) or column (B) part of each chunk's
  // source and its place in a stage are the same in every k-slice.
  const float* a_src[T::A_ITERS];
  int a_dst[T::A_ITERS], a_kc[T::A_ITERS];
  bool a_ok[T::A_ITERS];
#pragma unroll
  for (int j = 0; j < T::A_ITERS; ++j) {
    const int v = tid + j * T::THREADS;
    const int r = v / (KS / 4);
    const int c = (v % (KS / 4)) * 4;
    a_ok[j] = v < T::A_CHUNKS && row0 + r < p.rows;
    a_src[j] = a_ok[j] ? a + a_row_offset<RWMA>(p, row0 + r) : p.a;
    a_dst[j] = r * T::AS + c;
    a_kc[j] = c;
  }
  const float* b_src[T::B_ITERS];
  int b_dst[T::B_ITERS], b_kr[T::B_ITERS];
  bool b_ok[T::B_ITERS];
#pragma unroll
  for (int j = 0; j < T::B_ITERS; ++j) {
    const int v = tid + j * T::THREADS;
    const int kr = v / (CN / 4);
    const int c = (v % (CN / 4)) * 4;
    b_ok[j] = v < T::B_CHUNKS && col0 + c < p.cols;
    b_src[j] = b_ok[j] ? b + b_col_offset<RWMA>(p, col0 + c) : p.b;
    b_dst[j] = kr * CN + c;
    b_kr[j] = kr;
  }

  auto load_slice = [&](int slice, int stage) {
    const int k0 = slice * KS;
    float* as = As + stage * T::A_STAGE;
    float* bs = Bs + stage * T::B_STAGE;
#pragma unroll
    for (int j = 0; j < T::A_ITERS; ++j) {
      const int k = k0 + a_kc[j];
      const bool ok = a_ok[j] && k < p.K;
      if (tid + j * T::THREADS < T::A_CHUNKS)
        cp_async16(as + a_dst[j], ok ? a_src[j] + a_k_offset<RWMA>(p, k) : p.a, ok);
    }
#pragma unroll
    for (int j = 0; j < T::B_ITERS; ++j) {
      const int k = k0 + b_kr[j];
      const bool ok = b_ok[j] && k < p.K;
      if (tid + j * T::THREADS < T::B_CHUNKS)
        cp_async16(bs + b_dst[j], ok ? b_src[j] + b_k_offset<RWMA>(p, k) : p.b, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int n_slices = (p.K + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) load_slice(s, s);
    cp_async_commit();
  }

  for (int t = 0; t < n_slices; ++t) {
    // slice t has landed for every thread, and every thread is done with
    // the stage that slice t + STAGES - 1 overwrites (consumed at t - 1)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < n_slices) load_slice(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* as = As + (t % STAGES) * T::A_STAGE;
    const float* bs = Bs + (t % STAGES) * T::B_STAGE;
#pragma unroll
    for (int q = 0; q < KS / 4; ++q) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + i * T::TY) * T::AS + q * 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < T::GROUPS; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              bs + (q * 4 + kk) * CN + g * T::GROUP_STRIDE + tx * 4);
          bv[4 * g] = w.x;
          bv[4 * g + 1] = w.y;
          bv[4 * g + 2] = w.z;
          bv[4 * g + 3] = w.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = component(av[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing is left in flight at exit

  float* const out = p.out + (RWMA ? 0LL
                                   : static_cast<long long>(z) * p.gm * p.gn * p.bm * p.bn);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * T::TY;
    if (r >= p.rows) continue;
#pragma unroll
    for (int g = 0; g < T::GROUPS; ++g) {
      const int c = col0 + g * T::GROUP_STRIDE + tx * 4;
      if (c >= p.cols) continue;
      float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                             acc[i][4 * g + 3]);
      if constexpr (FUSED) {
        const float4 bias = *reinterpret_cast<const float4*>(p.bias + c);
        v = make_float4(gelu_tanh(v.x + bias.x), gelu_tanh(v.y + bias.y),
                        gelu_tanh(v.z + bias.z), gelu_tanh(v.w + bias.w));
      }
      *reinterpret_cast<float4*>(out + out_offset<RWMA>(p, r, c)) = v;
    }
  }
}

template <int CM, int CN, int TM, int TN, bool FUSED, bool RWMA>
cudaError_t launch(const GemmArgs& p, int lead, cudaStream_t stream) {
  using T = Cta<CM, CN, TM, TN>;
  auto* kernel = gemm_kernel<CM, CN, TM, TN, FUSED, RWMA>;
  // above 48 KB a CTA's shared memory must be asked for; the attribute is
  // per device, so it is set on every launch (a host-side call, no sync)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.cols + CN - 1) / CN, (p.rows + CM - 1) / CM, lead);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The CTA tiles, with each one's per-thread register tile.  The list must
// match kernels/bwma_gemm.py:CTA_TILES.
template <bool FUSED, bool RWMA>
cudaError_t dispatch(int cm, int cn, const GemmArgs& p, int lead, cudaStream_t stream) {
  const int key = cm * 1000 + cn;
  switch (key) {
    case 128128: return launch<128, 128, 8, 8, FUSED, RWMA>(p, lead, stream);
    case 128064: return launch<128, 64, 8, 4, FUSED, RWMA>(p, lead, stream);
    case 64128: return launch<64, 128, 4, 8, FUSED, RWMA>(p, lead, stream);
    case 64064: return launch<64, 64, 4, 4, FUSED, RWMA>(p, lead, stream);
    case 32128: return launch<32, 128, 2, 8, FUSED, RWMA>(p, lead, stream);
    case 32064: return launch<32, 64, 2, 4, FUSED, RWMA>(p, lead, stream);
    case 16128: return launch<16, 128, 2, 8, FUSED, RWMA>(p, lead, stream);
    case 16064: return launch<16, 64, 2, 4, FUSED, RWMA>(p, lead, stream);
    default: return cudaErrorInvalidValue;
  }
}

inline int log2_exact(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return (1 << l) == d ? l : -1;
}

// Blocked operands: a (lead, gm, gk, bm, bk), b (lead, gk, gn, bk, bn).
template <bool FUSED>
int run_blocked(const float* a, const float* b, const float* bias, float* out, int lead0,
                int lead1, long long a_s0, long long a_s1, long long b_s0, long long b_s1,
                int gm, int gn, int gk, int bm, int bn, int bk, int cm, int cn,
                void* stream) {
  const int lbm = log2_exact(bm), lbn = log2_exact(bn), lbk = log2_exact(bk);
  if (lbm < 3 || lbn < 3 || lbk < 3 || bm > 128 || bn > 128 || bk > 128)
    return cudaErrorInvalidValue;  // blocks of 8..128, powers of two
  if (cm % bm || cn % bn) return cudaErrorInvalidValue;  // whole blocks per CTA
  if (gm < 1 || gn < 1 || gk < 1 || gm > 65535 || lead0 * lead1 > 65535)
    return cudaErrorInvalidValue;
  const GemmArgs p{a, b, bias, out, lead1, a_s0, a_s1, b_s0, b_s1, gm * bm, gn * bn,
                   gk * bk, gm, gn, gk, bm, bn, bk, lbm, lbn, lbk};
  return dispatch<FUSED, false>(cm, cn, p, lead0 * lead1,
                                static_cast<cudaStream_t>(stream));
}

// Row-major operands: a (M, K), b (K, N); K and N multiples of 4 (16-byte
// chunks), any M.
inline int run_rowmajor(const float* a, const float* b, float* out, int M, int N, int K,
                        int cm, int cn, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 4 || K % 4 || cm < 16 || (M + cm - 1) / cm > 65535)
    return cudaErrorInvalidValue;
  const GemmArgs p{a, b, nullptr, out, 1, 0, 0, 0, 0, M, N, K, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  return dispatch<false, true>(cm, cn, p, 1, static_cast<cudaStream_t>(stream));
}

}  // namespace gemm_tile

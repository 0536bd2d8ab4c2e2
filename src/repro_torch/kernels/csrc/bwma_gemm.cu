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
// Design (the loop lives in gemm_tile.cuh, shared with rwma_gemm.cu): one
// CTA owns one output block (l, i, j) and loops over the gk k-blocks, which
// takes the place of the TPU grid's sequential k axis.  Every operand block
// is one contiguous bm x bk (or bk x bn) run -- the paper's arrangement --
// so it is staged into shared memory with coalesced 16-byte loads, in
// k-slices of KS columns so shared memory stays small (at most 18 KB at
// 128 x 128 blocks).  A thread keeps an RM x RN register tile of the
// accumulator, strided across the block so shared-memory reads broadcast
// instead of conflicting.  The epilogue applies bias + GELU to the
// accumulator in registers before the single store, as the TPU kernel does
// at its last k step.  No double buffering, no tensor cores: simple first.

#include "gemm_tile.cuh"

extern "C" int bwma_gemm_f32(const float* a, const float* b, float* out,
                             int lead0, int lead1, long long a_s0,
                             long long a_s1, long long b_s0, long long b_s1,
                             int gm, int gn, int gk, int bm, int bn, int bk,
                             void* stream) {
  return gemm_tile::run<false, false>(a, b, nullptr, out, lead0, lead1, a_s0,
                                      a_s1, b_s0, b_s1, gm, gn, gk, bm, bn,
                                      bk, stream);
}

extern "C" int bwma_fused_ffn_f32(const float* a, const float* b,
                                  const float* bias, float* out, int lead0,
                                  int lead1, long long a_s0, long long a_s1,
                                  long long b_s0, long long b_s1, int gm,
                                  int gn, int gk, int bm, int bn, int bk,
                                  void* stream) {
  return gemm_tile::run<true, false>(a, b, bias, out, lead0, lead1, a_s0,
                                     a_s1, b_s0, b_s1, gm, gn, gk, bm, bn, bk,
                                     stream);
}

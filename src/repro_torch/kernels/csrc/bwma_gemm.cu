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
// Design (the loop lives in gemm_tile.cuh, shared with rwma_gemm.cu): a CTA
// computes a CM x CN super-tile of the output that spans whole data blocks,
// the size the host's plan picks for the product (kernels/bwma_gemm.py:
// gemm_plan), and loops over K, which takes the place of the TPU grid's
// sequential k axis.  Every 16-byte chunk it stages lies inside one operand
// block, and a k-slice of B's CN / bn adjacent blocks is one contiguous run
// per block row -- the paper's arrangement -- copied with cp.async into a
// four-stage ring in shared memory while the previous slice is consumed.
// A thread keeps up to an 8 x 8 accumulator in registers, fed by 16-byte
// shared-memory reads.  The epilogue applies bias + GELU to the accumulator
// in registers before the single store, as the TPU kernel does at its last
// k step.  FFMA only, no split-K: each output is summed by one thread in k
// order.

#include "gemm_tile.cuh"

extern "C" int bwma_gemm_f32(const float* a, const float* b, float* out,
                             int lead0, int lead1, long long a_s0,
                             long long a_s1, long long b_s0, long long b_s1,
                             int gm, int gn, int gk, int bm, int bn, int bk,
                             int cm, int cn, void* stream) {
  return gemm_tile::run_blocked<false>(a, b, nullptr, out, lead0, lead1, a_s0, a_s1,
                                       b_s0, b_s1, gm, gn, gk, bm, bn, bk, cm, cn,
                                       stream);
}

extern "C" int bwma_fused_ffn_f32(const float* a, const float* b,
                                  const float* bias, float* out, int lead0,
                                  int lead1, long long a_s0, long long a_s1,
                                  long long b_s0, long long b_s1, int gm,
                                  int gn, int gk, int bm, int bn, int bk,
                                  int cm, int cn, void* stream) {
  return gemm_tile::run_blocked<true>(a, b, bias, out, lead0, lead1, a_s0, a_s1, b_s0,
                                      b_s1, gm, gn, gk, bm, bn, bk, cm, cn, stream);
}

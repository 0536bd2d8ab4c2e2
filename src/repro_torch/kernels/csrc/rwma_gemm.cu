// Row-major (RWMA) tiled GEMM in fp32 for Hopper (sm_90a): the paper's
// baseline arrangement.
//
// Replaces the Pallas TPU kernel repro/kernels/rwma_gemm.py:_gemm_kernel
// (launched by rwma_gemm).
//
//   out (M, N) = a (M, K) @ b (K, N),   f32 accumulate,
//
// with every shape a multiple of its tile (bm, bk, bn); the wrapper raises
// otherwise, as the TPU kernel does.  Like the TPU kernel it takes any tile
// that divides the shapes.
//
// What bounds it on this card: at the encoder's projection shapes a product
// does hundreds of multiply-adds per byte it must move, so it is bound by
// operations, on the FFMA units (67 TFLOP/s fp32 on an H100 SXM; no TF32,
// which would break fp32 parity).
//
// Design: when K and N are multiples of 4 (16-byte rows) it runs the
// blocked GEMM's loop (gemm_tile.cuh, RWMA = true): the same CTA super-tile
// for the same tiling (the host's plan, kernels/bwma_gemm.py:gemm_plan), the
// same cp.async ring, register tile and epilogue, so the two differ only in
// the addressing of a chunk: here a k-slice of the CTA's rows is CM row
// segments of 16 floats at a stride of K, a slice of b is 16 segments at a
// stride of N, and the output is written the same way -- where the blocked
// arrangement reads each block row as one contiguous run.  Timing the two at
// equal tiling is the paper's BWMA-vs-RWMA comparison on this card.  The
// row-major addressing does not depend on the tile, so any tile that divides
// the shapes (24, 96, 192 ... : the model's `dense` clips its tile to the
// token count) takes this loop too, with rows past M skipped.
//
// Any other shape (K or N not a multiple of 4, as at tile 9 over 45
// columns) runs rwma_any_tile_kernel below: one CTA per bm x bn output tile,
// walking the k-tiles in order, with runtime tile sizes, scalar loads and
// guarded 128 x 128 sub-tiles.  It is correct for every tile, and slow; the
// host picks the route (kernels/rwma_gemm.py:rwma_route).

#include "gemm_tile.cuh"

namespace {

constexpr int kT = 16;              // 16 x 16 threads
constexpr int kR = 8;               // an 8 x 8 register tile each
constexpr int kSub = kT * kR;       // 128 x 128 output sub-tile
constexpr int kKs = 16;             // k-slice staged in shared memory

__global__ void __launch_bounds__(kT * kT)
rwma_any_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int K, int N, int gk, int bm, int bn,
                     int bk) {
  __shared__ float As[kSub][kKs + 1];
  __shared__ float Bs[kKs][kSub];
  const int tid = threadIdx.x;
  const int tx = tid % kT;
  const int ty = tid / kT;
  const long long row0 = static_cast<long long>(blockIdx.y) * bm;
  const long long col0 = static_cast<long long>(blockIdx.x) * bn;

  for (int sr = 0; sr < bm; sr += kSub) {
    const int rows = min(kSub, bm - sr);
    for (int sc = 0; sc < bn; sc += kSub) {
      const int cols = min(kSub, bn - sc);
      float acc[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] = 0.0f;
      for (int kb = 0; kb < gk; ++kb) {
        const long long kt = static_cast<long long>(kb) * bk;
        for (int k0 = 0; k0 < bk; k0 += kKs) {
          const int ks = min(kKs, bk - k0);
          __syncthreads();  // the previous slice has been consumed
          // rows segments of a (ks floats each, K apart), ks segments of b
          // (cols floats each, N apart)
          for (int v = tid; v < rows * ks; v += kT * kT) {
            const int r = v / ks;
            const int c = v - r * ks;
            As[r][c] = a[(row0 + sr + r) * K + kt + k0 + c];
          }
          for (int v = tid; v < ks * cols; v += kT * kT) {
            const int r = v / cols;
            const int c = v - r * cols;
            Bs[r][c] = b[(kt + k0 + r) * N + col0 + sc + c];
          }
          __syncthreads();
          for (int kk = 0; kk < ks; ++kk) {
            float av[kR];
            float bv[kR];
#pragma unroll
            for (int i = 0; i < kR; ++i) av[i] = As[ty + i * kT][kk];
#pragma unroll
            for (int j = 0; j < kR; ++j) bv[j] = Bs[kk][tx + j * kT];
            // entries past rows / cols read stale shared memory into
            // accumulators that are never written out
#pragma unroll
            for (int i = 0; i < kR; ++i)
#pragma unroll
              for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = ty + i * kT;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int c = tx + j * kT;
          if (c < cols) out[(row0 + sr + r) * N + col0 + sc + c] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" int rwma_gemm_f32(const float* a, const float* b, float* out, int M, int N,
                             int K, int cm, int cn, void* stream) {
  return gemm_tile::run_rowmajor(a, b, out, M, N, K, cm, cn, stream);
}

extern "C" int rwma_any_tile_f32(const float* a, const float* b, float* out, int gm,
                                 int gn, int gk, int bm, int bn, int bk, void* stream) {
  if (gm < 1 || gn < 1 || gk < 1 || bm < 1 || bn < 1 || bk < 1 || gm > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid(gn, gm);
  rwma_any_tile_kernel<<<grid, kT * kT, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, gk * bk, gn * bn, gk, bm, bn, bk);
  return cudaGetLastError();
}

// Blocked transpose for Hopper (sm_90a): the paper's section 3.2 Transpose
// on the BWMA layout.
//
// Replaces the Pallas TPU kernel
// repro/kernels/bwma_transpose.py:_transpose_kernel (launched by
// bwma_transpose).
//
// x (..., gm, gn, bm, bn) -> out (..., gn, gm, bn, bm) with
// out[..., j, i] = x[..., i, j]^T: the block grid swaps and so does each
// block's interior.  Pure data movement, bit-exact for any element type:
// the elements move as opaque 1-, 2-, 4-, 8- or 16-byte words.
//
// What bounds it on this card: the bytes, each read once and written once
// (3.35 TB/s HBM3 on an H100 SXM).
//
// Design.  The TPU kernel swaps the grid coordinates in its output index map
// and transposes each block in VMEM.  Here one CTA owns one source block:
// it reads the block as one contiguous run (consecutive threads on
// consecutive words) into shared memory, with rows padded by one word so
// that the transposed read does not hit one bank 32 times, and writes the
// transposed block to its place (j, i) in the output, again as one
// contiguous run -- the paper's Fig. 5b argument: in BWMA both directions
// stay contiguous, where a row-major transpose gathers strided columns.  A
// block too large for shared memory (16-byte elements at block 128) moves
// in chunks of source rows, each written as contiguous segments.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
bwma_transpose_kernel(const W* x, W* out, int gm, int gn, int bm, int bn, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* tile = reinterpret_cast<W*>(smem_raw);
  const long long blk = blockIdx.x;  // source block (lead, i, j), row-major
  const long long per_lead = static_cast<long long>(gm) * gn;
  const long long lead = blk / per_lead;
  const int ij = static_cast<int>(blk - lead * per_lead);
  const int i = ij / gn;
  const int j = ij - i * gn;
  const int ts = bn + 1;
  const W* src = x + blk * bm * bn;
  W* dst = out + ((lead * gn + j) * gm + i) * bm * bn;
  // `rows` source rows at a time: the whole block unless it does not fit in
  // shared memory (16-byte elements at block 128)
  for (int r0 = 0; r0 < bm; r0 += rows) {
    const int nr = bm - r0 < rows ? bm - r0 : rows;
    if (r0) __syncthreads();  // the previous chunk's readers are done
    for (int e = threadIdx.x; e < nr * bn; e += kThreads) {
      const int r = e / bn;
      tile[r * ts + (e - r * bn)] = src[static_cast<long long>(r0) * bn + e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < bn * nr; e += kThreads) {
      const int c = e / nr;  // the output row is the source column
      const int r = e - c * nr;
      dst[static_cast<long long>(c) * bm + r0 + r] = tile[r * ts + c];
    }
  }
}

template <typename W>
int launch(const void* x, void* out, long long blocks, int gm, int gn, int bm, int bn,
           void* stream) {
  const long long row_bytes = static_cast<long long>(bn + 1) * sizeof(W);
  long long rows = 232448 / row_bytes;
  if (rows > bm) rows = bm;
  if (rows < 1) return cudaErrorInvalidValue;
  const long long smem = rows * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwma_transpose_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bwma_transpose_kernel<W><<<static_cast<unsigned>(blocks), kThreads,
                             static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const W*>(x), static_cast<W*>(out), gm, gn, bm, bn, static_cast<int>(rows));
  return cudaGetLastError();
}

}  // namespace

// elem_size: bytes per element (1, 2, 4, 8 or 16); blocks: the number of
// source blocks, lead * gm * gn.
extern "C" int bwma_transpose(const void* x, void* out, int elem_size, long long blocks,
                              int gm, int gn, int bm, int bn, void* stream) {
  if (blocks < 1 || blocks > 2147483647LL || gm < 1 || gn < 1 || bm < 1 || bn < 1 ||
      blocks % (static_cast<long long>(gm) * gn) != 0)
    return cudaErrorInvalidValue;
  switch (elem_size) {
    case 1: return launch<uint8_t>(x, out, blocks, gm, gn, bm, bn, stream);
    case 2: return launch<uint16_t>(x, out, blocks, gm, gn, bm, bn, stream);
    case 4: return launch<uint32_t>(x, out, blocks, gm, gn, bm, bn, stream);
    case 8: return launch<uint64_t>(x, out, blocks, gm, gn, bm, bn, stream);
    case 16: return launch<uint4>(x, out, blocks, gm, gn, bm, bn, stream);
    default: return cudaErrorInvalidValue;
  }
}

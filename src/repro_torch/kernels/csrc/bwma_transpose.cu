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
// the elements move as opaque 1-, 2-, 4-, 8- or 16-byte values.
//
// What bounds it on this card: the bytes, each read once and written once
// (3.35 TB/s HBM3 on an H100 SXM).
//
// Design.  The TPU kernel swaps the grid coordinates in its output index map
// and transposes each block in VMEM.  Here:
// - A CTA moves a fixed tile of kTileBytes, whatever the block.  Where
//   blocks are small (1 KB at block 16 in fp32) it moves tile_blocks whole
//   source blocks, consecutive in x (8 in fp32); where a block exceeds the
//   tile (64 KB at block 128 in fp32) it moves a sub-tile of one block (64
//   rows x 32 columns in fp32).  The host's plan
//   (bwma_transpose.py:transpose_plan) picks it.  8 KB was faster than 4,
//   16 and 32 KB at the BERT-base K shapes on an H100 (PERF.md).
// - Words.  Every load and store moves a word of W bytes, the widest of 16,
//   8, 4, 2 or 1 that divides a source row (bn elements), an output row (bm
//   elements) and both pointers: 16 for every supported block in fp32 and
//   bf16.  V = W / elem_size elements make a word.
// - Micro-tiles in registers, no shared memory.  A thread loads a V x V
//   micro-tile as V words, one from each of V source rows, transposes it in
//   registers (moves for 4-, 8- and 16-byte elements, __byte_perm for 1- and
//   2-byte ones) and stores V words, one to each of V output rows.  Nothing
//   passes through shared memory, so there is no transposed shared-memory
//   read to pad or swizzle against bank conflicts, no __syncthreads and no
//   shared-memory attribute to set.
// - Coalescing on both sides.  Within a tile, neighbouring threads take
//   neighbouring micro-tile rows of one micro-tile column, at most
//   kMaxTileRows of them (then the next column), so a warp's load touches
//   at least two words of each source row it reads and its store at least
//   two words of each output row it writes: whole 32-byte sectors whenever
//   W is 16.  Each source block is read as one contiguous run by its CTA
//   and written to its place (j, i) as one contiguous run: the paper's
//   Fig. 5b argument, at every block size.
// - A thread loads up to kBatch micro-tiles before it stores the first, so
//   each thread has several independent loads in flight.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;       // threads per CTA
constexpr int kTileBytes = 8192;    // bytes a CTA moves
constexpr int kMaxTileRows = 16;    // micro-tile rows of a tile (its column of a warp)
constexpr int kBatch = 8;           // micro-tiles a thread loads before it stores

struct TArgs {
  unsigned blocks;       // source blocks, lead * gm * gn
  int gm, gn, bm, bn;    // elements
  int mr_n, mc_n;        // micro-tiles of a block: bm / V rows, bn / V columns
  int nb;                // whole blocks per CTA (1 for a sub-tile)
  int sr, sc;            // micro-tiles of a tile in each of its blocks
  int st_c, st_n;        // sub-tiles of a block: along its columns, in all
};

template <int W>
__device__ __forceinline__ void load_word(const unsigned char* p, uint32_t* r) {
  if constexpr (W == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = v.x;
    r[1] = v.y;
  } else if constexpr (W == 4) {
    r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (W == 2) {
    r[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store_word(unsigned char* p, const uint32_t* r) {
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<unsigned int*>(p) = r[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(r[0]);
  } else {
    *p = static_cast<unsigned char>(r[0]);
  }
}

// o[c] element r = in[r] element c: a V x V transpose of ESZ-byte elements
// held as V words of R 32-bit registers (a word under 4 bytes in the low
// bits of one register)
template <int ESZ, int V, int R>
__device__ __forceinline__ void transpose_words(const uint32_t (&in)[V][R], uint32_t (&o)[V][R]) {
  if constexpr (V == 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) o[0][q] = in[0][q];
  } else if constexpr (ESZ >= 4) {
    constexpr int E = ESZ / 4;  // registers per element
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < V; ++r)
#pragma unroll
        for (int q = 0; q < E; ++q) o[c][r * E + q] = in[r][c * E + q];
  } else if constexpr (ESZ == 2) {  // register j of a word: elements 2j, 2j + 1
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int j = 0; j < R; ++j)
        o[c][j] = __byte_perm(in[2 * j][c / 2], in[2 * j + 1][c / 2], c & 1 ? 0x7632 : 0x5410);
  } else if constexpr (V == 2) {  // 1-byte elements in 2-byte words
#pragma unroll
    for (int c = 0; c < 2; ++c) o[c][0] = __byte_perm(in[0][0], in[1][0], c | (c + 4) << 4);
  } else {  // 1-byte elements, register j of a word: elements 4j .. 4j + 3
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int b = c & 3, sel = b | (b + 4) << 4;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const uint32_t lo = __byte_perm(in[4 * j][c / 4], in[4 * j + 1][c / 4], sel);
        const uint32_t hi = __byte_perm(in[4 * j + 2][c / 4], in[4 * j + 3][c / 4], sel);
        o[c][j] = __byte_perm(lo, hi, 0x5410);
      }
    }
  }
}

template <int ESZ, int W>
__global__ void __launch_bounds__(kThreads)
bwma_transpose_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                      TArgs a) {
  constexpr int V = W / ESZ;                     // elements per word
  constexpr int R = (W + 3) / 4;                 // registers per word
  constexpr int kTile = kTileBytes / (V * W);    // micro-tiles a CTA moves at most
  constexpr int kPer = (kTile + kThreads - 1) / kThreads < kBatch
                           ? (kTile + kThreads - 1) / kThreads : kBatch;
  const unsigned g = blockIdx.x / a.st_n;  // the tile's group of blocks
  const int st = static_cast<int>(blockIdx.x - g * a.st_n);
  const int sr0 = st / a.st_c * a.sr, sc0 = st % a.st_c * a.sc;
  const int per_block = a.sr * a.sc;
  const int tile = a.nb * per_block;
  const unsigned per_lead = static_cast<unsigned>(a.gm) * a.gn;
  const long long bsz = static_cast<long long>(a.bm) * a.bn;  // elements per block
  for (int base = 0; base < tile; base += kThreads * kPer) {
    uint32_t w[kPer][V][R];
    long long dst[kPer];
    bool ok[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int u = base + p * kThreads + static_cast<int>(threadIdx.x);
      const int bl = u / per_block, q = u - bl * per_block;
      const int mr = sr0 + q % a.sr, mc = sc0 + q / a.sr;
      const unsigned blk = g * a.nb + bl;
      ok[p] = u < tile && blk < a.blocks && mr < a.mr_n && mc < a.mc_n;
      if (ok[p]) {
        const unsigned lead = blk / per_lead, ij = blk - lead * per_lead;
        const unsigned i = ij / a.gn, j = ij - i * a.gn;
        const unsigned char* src =
            x + (blk * bsz + static_cast<long long>(mr) * V * a.bn + mc * V) * ESZ;
#pragma unroll
        for (int k = 0; k < V; ++k)
          load_word<W>(src + static_cast<long long>(k) * a.bn * ESZ, w[p][k]);
        const unsigned ob = (lead * a.gn + j) * a.gm + i;  // the block's place (j, i)
        dst[p] = (ob * bsz + static_cast<long long>(mc) * V * a.bm + mr * V) * ESZ;
      }
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (!ok[p]) continue;
      uint32_t t[V][R];
      transpose_words<ESZ, V, R>(w[p], t);
#pragma unroll
      for (int k = 0; k < V; ++k)
        store_word<W>(out + dst[p] + static_cast<long long>(k) * a.bm * ESZ, t[k]);
    }
  }
}

template <int ESZ, int W>
int launch(const void* x, void* out, const TArgs& a, unsigned ctas, cudaStream_t s) {
  bwma_transpose_kernel<ESZ, W><<<ctas, kThreads, 0, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), a);
  return cudaGetLastError();
}

// the word widths an element of ESZ bytes may move in
template <int ESZ>
int by_word(int word, const void* x, void* out, const TArgs& a, unsigned ctas,
            cudaStream_t s) {
  switch (word) {
    case 1: if constexpr (ESZ <= 1) return launch<ESZ, 1>(x, out, a, ctas, s); break;
    case 2: if constexpr (ESZ <= 2) return launch<ESZ, 2>(x, out, a, ctas, s); break;
    case 4: if constexpr (ESZ <= 4) return launch<ESZ, 4>(x, out, a, ctas, s); break;
    case 8: if constexpr (ESZ <= 8) return launch<ESZ, 8>(x, out, a, ctas, s); break;
    case 16: return launch<ESZ, 16>(x, out, a, ctas, s);
  }
  return cudaErrorInvalidValue;
}

long long ceil_div(long long n, long long d) { return (n + d - 1) / d; }

}  // namespace

// elem_size: bytes per element (1, 2, 4, 8 or 16); word: bytes per load and
// store; blocks: the number of source blocks, lead * gm * gn; the tile, from
// the host's plan: tile_blocks whole blocks, or one tile_rows x tile_cols
// sub-tile of a block (tile_blocks 1).
extern "C" int bwma_transpose(const void* x, void* out, int elem_size, int word,
                              long long blocks, int gm, int gn, int bm, int bn,
                              int tile_blocks, int tile_rows, int tile_cols, void* stream) {
  const bool esz_ok = elem_size == 1 || elem_size == 2 || elem_size == 4 || elem_size == 8 ||
                      elem_size == 16;
  if (!esz_ok || word < elem_size || word > 16 || (word & (word - 1)) || blocks < 1 ||
      blocks > 2147483647LL || gm < 1 || gn < 1 || bm < 1 || bn < 1 ||
      blocks % (static_cast<long long>(gm) * gn) != 0 ||
      (static_cast<long long>(bm) * elem_size) % word ||
      (static_cast<long long>(bn) * elem_size) % word ||
      reinterpret_cast<uintptr_t>(x) % word || reinterpret_cast<uintptr_t>(out) % word)
    return cudaErrorInvalidValue;
  const int v = word / elem_size;
  if (tile_blocks < 1 || tile_rows < 1 || tile_cols < 1 || tile_rows > bm || tile_cols > bn ||
      tile_rows % v || tile_cols % v || tile_rows / v > kMaxTileRows ||
      (tile_blocks > 1 && (tile_rows != bm || tile_cols != bn)) ||
      static_cast<long long>(tile_blocks) * tile_rows * tile_cols * elem_size > kTileBytes)
    return cudaErrorInvalidValue;
  TArgs a{static_cast<unsigned>(blocks), gm, gn, bm, bn, bm / v, bn / v, tile_blocks,
          tile_rows / v, tile_cols / v, 0, 0};
  a.st_c = static_cast<int>(ceil_div(a.mc_n, a.sc));
  a.st_n = static_cast<int>(ceil_div(a.mr_n, a.sr)) * a.st_c;
  const long long ctas = ceil_div(blocks, tile_blocks) * a.st_n;
  if (ctas > 2147483647LL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(ctas);
  switch (elem_size) {
    case 1: return by_word<1>(word, x, out, a, n, s);
    case 2: return by_word<2>(word, x, out, a, n, s);
    case 4: return by_word<4>(word, x, out, a, n, s);
    case 8: return by_word<8>(word, x, out, a, n, s);
    default: return by_word<16>(word, x, out, a, n, s);
  }
}

// Fused blocked (BWMA) attention, softmax(q k^T * scale) v, in fp32 for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bwma_attention.py:
// _attention_kernel (launched by _attention_4d from bwma_attention).
//
// q, k, v and out are (..., gs, gd, bm, bd) blocked matrices of logical
// shape (S, d_head); the leading (batch, head) dims fold into gridDim.y with
// per-operand strides (0 where K/V broadcast over query heads).  Keys at or
// past s_logical get probability exactly 0; padded d_head columns of q, k
// and v are 0, so they stay 0 in out; padded query rows are finite garbage,
// cropped when the result is unblocked.
//
// Why it cannot copy the TPU design: the Pallas kernel holds all of K and V
// on chip for one query block-row.  At BERT-base in fp32 that is 256 KB at
// block 16 and 512 KB at block 128 (d_head 64 pads to 128), more than the
// 227 KB of shared memory a CTA may use.  So K and V stream through shared
// memory with an online softmax.
//
// What bounds it on this card: operations.  Per (sequence, head) it does
// 2 * S^2 * D multiply-adds against 4 * S * D floats moved, so FFMA at
// 67 TFLOP/s is the limit.  FFMA only: TF32 keeps about three decimal
// digits and would break fp32 parity.
//
// Design:
// - The CTA tile is not the data block.  A CTA owns BQ query rows of one
//   (batch, head) -- several query block-rows at block 16, part of one at
//   block 128 -- one tile per padded width, 64 x 64 up to 128 columns
//   (kernels/bwma_attention.py:ATTN_TILES).  Its Q tile is staged once.
// - K and V stream in tiles of BKV keys through a two-stage cp.async ring
//   of 16-byte chunks; the next tile loads while the current one is
//   consumed.  A chunk is 4 columns of one row inside one data block, and
//   at block 16 a tile of four key block-rows is one contiguous run of
//   BKV * D floats -- the paper's arrangement working for the copy.  Key
//   tiles wholly at or past s_logical are not loaded at all.
// - Register tiling in both products, on 256 threads as a 16 x 16 grid:
//   thread (ty, tx) keeps the scores of rows ty + 16 i against keys
//   tx + 16 j, and the output of the same rows in columns tx * 4 + 64 g.
//   Q and K rows are read along D as 16-byte vectors (the rows are padded
//   so eight lanes' reads fall in distinct banks); the probabilities go
//   through shared memory once per tile and are read back as 16-byte
//   vectors beside 16-byte reads of V.  Each shared-memory load feeds 8 or
//   more FFMAs.
// - Online softmax: the 16 threads of a row are 16 lanes of one warp, so
//   the row max is reduced with shuffles; each thread keeps a partial row
//   sum, reduced once at the end.  The running output is rescaled by
//   exp(m_old - m_new) per tile.  Masked keys are filled with -FLT_MAX
//   (finfo(float32).min) before the max and given weight exactly 0.  The
//   result is o / max(l, 1e-30), as the reference does.
// - Padded width: D = gd * bd is staged at DP = 64, 128 or 256 columns
//   (zero-filled past D), so the loops over D unroll at compile time.
// - Numerics: no split over keys, no atomics: each output is summed by one
//   thread in key order, so a result is the same bits run to run.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kSide = 16;
constexpr int STAGES = 2;      // depth of the cp.async ring of K/V tiles
constexpr int kSmemPerSM = 228 * 1024;

struct AttnArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int lead1;
  long long q_s0, q_s1, k_s0, k_s1, v_s0, v_s1;
  int rows;       // gs * bm: query and key rows held in memory
  int D;          // gd * bd: the head width as stored
  int gd, lbm, lbd;
  int s_logical;
  float scale;
};

template <int BQ, int BKV, int DP>
struct Tile {
  static constexpr int TM = BQ / kSide;     // query rows per thread
  static constexpr int TN = BKV / kSide;    // key columns per thread
  static constexpr int G = DP / 64;         // 4-column output groups per thread
  static constexpr int RS = DP + 4;         // Q/K/V row stride in shared memory
  static constexpr int PS = BKV + 16;       // probability row stride
  static constexpr int KV_STAGE = 2 * BKV * RS;  // K then V of one tile
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(BQ) * RS + STAGES * KV_STAGE + BQ * PS);
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= kSmemPerSM ? 2 : 1;
  static_assert(BQ % kSide == 0 && BKV % kSide == 0 && DP % 64 == 0, "bad tile");
  static_assert(BKV % 4 == 0, "probabilities are read as 16-byte vectors");
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
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

// Element offset of row r, columns d..d+3 of a blocked (gs, gd, bm, bd)
// matrix: the 4 columns lie in one data block (bd is a multiple of 4).
__device__ __forceinline__ long long blocked_offset(const AttnArgs& p, int r, int d) {
  const int bm = 1 << p.lbm, bd = 1 << p.lbd;
  return (static_cast<long long>(r >> p.lbm) * p.gd + (d >> p.lbd)) * bm * bd +
         static_cast<long long>(r & (bm - 1)) * bd + (d & (bd - 1));
}

// Stage `n_rows` rows starting at row0 of a blocked matrix into shared
// memory (row stride RS); rows at or past `valid_rows` and columns past D
// are zero-filled.
template <int DP, int N_ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, const AttnArgs& p,
                                           int row0, int valid_rows) {
  constexpr int CH = DP / 4;
  constexpr int RS = DP + 4;
  constexpr int ITERS = (N_ROWS * CH + kThreads - 1) / kThreads;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c = threadIdx.x + it * kThreads;
    if (N_ROWS * CH % kThreads == 0 || c < N_ROWS * CH) {
      const int r = c / CH;
      const int d = (c - r * CH) * 4;
      const bool ok = row0 + r < valid_rows && d < p.D;
      cp_async16(dst + r * RS + d, ok ? src + blocked_offset(p, row0 + r, d) : src, ok);
    }
  }
}

template <int BQ, int BKV, int DP>
__global__ void __launch_bounds__(kThreads, (Tile<BQ, BKV, DP>::MIN_BLOCKS))
bwma_attention_kernel(AttnArgs p) {
  using T = Tile<BQ, BKV, DP>;
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);   // BQ x RS
  float* const KVs = Qs + BQ * T::RS;                   // STAGES x (K, V): BKV x RS each
  float* const Ps = KVs + STAGES * T::KV_STAGE;         // BQ x PS probabilities

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 15;                 // the 16 threads of a row: one half-warp
  const int ty = (tid >> 5) * 2 + (lane >> 4);
  const int q0 = blockIdx.x * BQ;
  const int z = blockIdx.y;
  const int l0 = z / p.lead1;
  const int l1 = z - l0 * p.lead1;
  const float* const q = p.q + l0 * p.q_s0 + l1 * p.q_s1;
  const float* const k = p.k + l0 * p.k_s0 + l1 * p.k_s1;
  const float* const v = p.v + l0 * p.v_s0 + l1 * p.v_s1;
  const int key_rows = min(p.s_logical, p.rows);  // keys past these are never read
  const int n_tiles = (p.s_logical + BKV - 1) / BKV;

  auto load_kv = [&](int t, int stage) {
    float* ks = KVs + stage * T::KV_STAGE;
    stage_rows<DP, BKV>(ks, k, p, t * BKV, key_rows);
    stage_rows<DP, BKV>(ks + BKV * T::RS, v, p, t * BKV, key_rows);
  };

  stage_rows<DP, BQ>(Qs, q, p, q0, p.rows);
  load_kv(0, 0);
  cp_async_commit();

  float o[T::TM][4 * T::G];
  float m[T::TM], l[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    m[i] = -FLT_MAX;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4 * T::G; ++e) o[i][e] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // tile t has landed for every thread, and every thread is done with the
    // stage that tile t + 1 overwrites (consumed at t - 1)
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) % STAGES);
    cp_async_commit();

    const float* const Ks = KVs + (t % STAGES) * T::KV_STAGE;
    const float* const Vs = Ks + BKV * T::RS;

    // scores: s[i][j] = q[ty + 16 i] . k[tx + 16 j]
    float s[T::TM][T::TN];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[T::TM], kb[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + kSide * i) * T::RS + d);
#pragma unroll
      for (int j = 0; j < T::TN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + kSide * j) * T::RS + d);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax over this tile; the row max across the row's 16 lanes
    bool valid[T::TN];
#pragma unroll
    for (int j = 0; j < T::TN; ++j) valid[j] = t * BKV + tx + kSide * j < p.s_logical;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        s[i][j] = valid[j] ? s[i][j] * p.scale : -FLT_MAX;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < kSide; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const float e = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty + kSide * i) * T::PS + tx + kSide * j] = e;
        sum += e;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 4 * T::G; ++e) o[i][e] *= alpha;
    }
    __syncthreads();

    // o += P V: rows ty + 16 i, columns tx * 4 + 64 g
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float4 pa[T::TM];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + kSide * i) * T::PS + c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 vb[T::G];
#pragma unroll
        for (int g = 0; g < T::G; ++g)
          vb[g] = *reinterpret_cast<const float4*>(Vs + (c + kk) * T::RS + tx * 4 + 64 * g);
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
          const float x = component(pa[i], kk);
#pragma unroll
          for (int g = 0; g < T::G; ++g) {
            o[i][4 * g + 0] = fmaf(x, vb[g].x, o[i][4 * g + 0]);
            o[i][4 * g + 1] = fmaf(x, vb[g].y, o[i][4 * g + 1]);
            o[i][4 * g + 2] = fmaf(x, vb[g].z, o[i][4 * g + 2]);
            o[i][4 * g + 3] = fmaf(x, vb[g].w, o[i][4 * g + 3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // nothing is left in flight at exit

  // the row sum across the row's 16 lanes, then o / max(l, 1e-30)
  float* const out = p.out + static_cast<long long>(z) * p.rows * p.D;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < kSide; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float den = fmaxf(sum, 1e-30f);
    const int r = q0 + ty + kSide * i;
    if (r >= p.rows) continue;
#pragma unroll
    for (int g = 0; g < T::G; ++g) {
      const int d = tx * 4 + 64 * g;
      if (d >= p.D) continue;
      *reinterpret_cast<float4*>(out + blocked_offset(p, r, d)) =
          make_float4(o[i][4 * g] / den, o[i][4 * g + 1] / den, o[i][4 * g + 2] / den,
                      o[i][4 * g + 3] / den);
    }
  }
}

template <int BQ, int BKV, int DP>
cudaError_t launch(const AttnArgs& p, int lead, cudaStream_t stream) {
  using T = Tile<BQ, BKV, DP>;
  auto* kernel = bwma_attention_kernel<BQ, BKV, DP>;
  // above 48 KB a CTA's shared memory must be asked for; the attribute is
  // per device, so it is set on every launch (a host-side call, no sync)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::SMEM));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.rows + BQ - 1) / BQ, lead);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The CTA tile (BQ, BKV) of each padded width.  The list must match
// kernels/bwma_attention.py:ATTN_TILES.
template <typename F>
cudaError_t dispatch(int dp, int bq, int bkv, F&& run) {
  const int key = dp * 1000000 + bq * 1000 + bkv;
  switch (key) {
    case 64064064: return run(Tile<64, 64, 64>{});
    case 128064064: return run(Tile<64, 64, 128>{});
    case 256032032: return run(Tile<32, 32, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

inline int log2_exact(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return (1 << l) == d ? l : -1;
}

}  // namespace

// Shared memory one CTA of tile (bq, bkv) at padded width dp needs, in
// bytes, or -1 for a tile the kernel does not instantiate; the Python
// wrapper checks it against the card's limit before launching.
extern "C" long long bwma_attention_smem_bytes(int dp, int bq, int bkv) {
  long long bytes = -1;
  dispatch(dp, bq, bkv, [&](auto tile) {
    bytes = static_cast<long long>(decltype(tile)::SMEM);
    return cudaSuccess;
  });
  return bytes;
}

extern "C" int bwma_attention_f32(const float* q, const float* k, const float* v,
                                  float* out, int lead0, int lead1,
                                  long long q_s0, long long q_s1, long long k_s0,
                                  long long k_s1, long long v_s0, long long v_s1,
                                  int gs, int gd, int bm, int bd, int dp, int bq,
                                  int bkv, int s_logical, float scale, void* stream) {
  const int lbm = log2_exact(bm), lbd = log2_exact(bd);
  const int D = gd * bd;
  if (lead0 < 1 || lead1 < 1 || lead0 * lead1 > 65535 || lbm < 0 || lbd < 2 || D > dp ||
      gs < 1 || s_logical < 1 || s_logical > gs * bm)
    return cudaErrorInvalidValue;
  const AttnArgs p{q, k, v, out, lead1, q_s0, q_s1, k_s0, k_s1, v_s0, v_s1,
                   gs * bm, D, gd, lbm, lbd, s_logical, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dp, bq, bkv, [&](auto tile) {
    using T = decltype(tile);
    return launch<T::TM * kSide, T::TN * kSide, T::G * 64>(p, lead0 * lead1, st);
  });
}

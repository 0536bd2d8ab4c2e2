// Paged one-token GQA decode, paged one-token MLA decode over latent pages,
// and the copy-on-write page copy, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
// repro/kernels/paged_attention.py:_gqa_decode_kernel (launched by
// paged_attention_decode), repro/kernels/paged_attention.py:_mla_decode_kernel
// (launched by mla_paged_attention_decode) and
// repro/kernels/paged_attention.py:_copy_kernel (launched by paged_copy).
//
// paged_attention_decode:
//   out[b, 0, h] = softmax_k(q[b, 0, h] . K[b, k] * scale) @ V[b, k]
// over the keys k <= seq_pos[b] of slot b, where logical key k lives in
// physical page table[b, k / page] at offset k % page, and query head h
// reads kv head h / (H / Hkv).  q (B, 1, H, dh); pools (num_pages, page,
// Hkv, dh) in fp32 or bf16 (the same type as q); table (B, maxp) and
// seq_pos (B,) int32; out (B, 1, H, dh) in q's type; math in fp32.
//
// What bounds it on this card: every key and value it reads is used by the
// G = H / Hkv query heads of its group once each -- 2 G multiply-adds per
// element loaded, 9 flop per bf16 byte at G = 9 against the card's ~20 fp32
// flop per HBM byte -- so it is bound by the bytes of the slot's K/V history
// (3.35 TB/s HBM3 on an H100 SXM), and the card must keep enough of them in
// flight.
//
// Design.  The TPU grid (B, maxp) walks a slot's pages in order and carries
// the online-softmax state in VMEM scratch from one grid step to the next.
// Hopper runs blocks in no order, on 132 SMs, so the history is split:
// - paged_decode_kernel, grid (B, Hkv x head chunks, splits): a CTA owns the
//   kSplitKeys keys [z kSplitKeys, (z + 1) kSplitKeys) of one slot and the
//   query heads (at most kHeadsPerCta) of one kv head.  The partition is
//   fixed in keys, not derived from B, maxp or the SM count, so a slot's
//   output depends only on its own q, keys and seq_pos; the grid's splits
//   past a slot's last key return at once.  The split's keys stream in
//   tiles of kTileKeys through a two-stage cp.async ring (16-byte copies
//   where dh and the pools' addresses allow, else 8 or 4, else plain 2-byte
//   copies), each key's page looked up once in the slot's table row.  Warp
//   w of 8 owns the heads w and w + 8 (two warps per scheduler, so one
//   hides the other's latency): lane t scores key t of the tile against
//   them (q in shared memory as fp32, zero-padded like the rows), the warp
//   updates each head's running max and denominator with shuffles, and the
//   fp32 probabilities go through shared memory to P @ V, where lane l
//   holds the columns 2l, 2l + 1 (+ 64 j) of the warp's heads in registers.
//   The CTA writes its partial -- running max m, denominator l and
//   unnormalised accumulator, all fp32 -- to a workspace.
// - paged_decode_combine_kernel, grid (B, H): merges a head's partials in
//   ascending split order with the online softmax's rescale (m = max m_i,
//   l = sum l_i e^(m_i - m), acc likewise), divides and rounds once.  One
//   split is exact: e^0 = 1.
// Keys past seq_pos are never read, which is exact against the TPU kernel's
// finfo(float32).min mask: a masked key adds exp(min - m) = 0 to every sum.
// No tensor cores: P stays fp32 for P @ V, as in the TPU kernel.  No atomics.

// mla_paged_attention_decode (DeepSeek-V3's absorbed-matmul MLA read):
//   o_lat[b, 0, h] = softmax_k(scale * (q_lat[b, 0, h] . c_kv[b, k] +
//                                       q_rope[b, 0, h] . k_rope[b, k])) @ c_kv[b, k]
// over the keys k <= seq_pos[b], paged like the GQA decode.  q_lat (B, 1, H,
// r), q_rope (B, 1, H, dr); pools c_kv (num_pages, page, r) and k_rope
// (num_pages, page, dr), fp32 or bf16 (all four of one type); out (B, 1, H,
// r) in the pools' type.  The scores, running max, probabilities and rescale
// factors are fp32 values and the probabilities keep fp32 precision for the
// p @ c_kv product, as in the TPU kernel; the dot products and the sums over
// keys accumulate in a wider type (fp64 for fp32 pools, see MlaMath) and
// round once.
//
// What bounds it on this card: MLA decode is multi-query -- every query head
// reads the same latent row (r + dr values) -- so the scores are a small
// GEMM [heads x (r + dr)] @ [(r + dr) x keys] and the output another,
// [heads x keys] @ [keys x r]: about 120 flop per fp32 byte at H = 128, so
// it is bound by operations, not by the bytes of the latent history.
//
// Design.  The TPU grid (B, maxp) keeps an (H, r) fp32 accumulator for all
// heads in VMEM and walks a slot's pages in order.  Here, as in the GQA
// decode, the history is split:
// - mla_decode_kernel, grid (ceil(H / kMlaHeads), B, splits): a CTA owns the
//   kSplitKeys keys [z kSplitKeys, (z + 1) kSplitKeys) of one slot (256 for
//   fp32 pools, 128 for bf16; MlaMath) and kMlaHeads query heads.  The
//   partition is fixed in keys, so a slot's output depends on its own q,
//   keys and seq_pos alone; CTAs past a slot's last key return at once.  The
//   CTA loads seq_pos and its keys' table entries together, then stages the
//   query in the ring's last stage behind the first tiles' copies.  Latent +
//   rope rows stream in tiles of kTileKeys through a ring of kStages stages
//   in the pools' own type, each completing an mbarrier: one bulk copy (the
//   Tensor Memory Accelerator) a row part where r, dr and the pools allow
//   16-byte words, else cp.async words of 8, 4 or 2 bytes that arrive on
//   it; rows past the split's end repeat its last key, which the softmax
//   gives p = 0.  Each tile: (1) the warps split the dimensions kDimGroups
//   ways (and the keys the rest) and compute partial scores on the tensor
//   cores, the query fragments held in registers for the whole split; (2) a
//   thread per (head, key) sums the partials in a fixed order, scales,
//   masks, and updates the head's running max and denominator with shuffles
//   over the head's 16 threads; (3) warp w owns the latent columns [64 w,
//   64 w + 64) of every head and adds P @ c_kv on the tensor cores after
//   rescaling.  The CTA writes its partial (m, l, acc) to a workspace.
//   fp32 pools: mma.sync m16n8k8 in fp64 (the FP64 tensor cores, at the
//   fp32 FFMA rate; fp32 inputs widen exactly, each product is exact and
//   each sum is an fp64 sum), 16-key tiles, P in fp64.  bf16 pools: mma.sync
//   m16n8k16 bf16 with fp32 accumulators (products of bf16 inputs are exact
//   in fp32), 32-key tiles through ldmatrix; P is split into kMlaPParts
//   bf16 parts (hi + mid + lo keeps 24 of its bits), each a product of its
//   own: with two parts, outputs near zero can miss the bf16 gate.
// - mla_decode_combine_kernel, grid (H, B): merges a head's partials in
//   ascending split order (m = max m_i, l = sum l_i e^(m_i - m), acc
//   likewise, in the accumulation type), divides and rounds once.
// Keys past seq_pos are never read.  No atomics.
//
// paged_copy: copy page src -> dst in every layer of one stacked pool
// (L, num_pages, page, ...) in place, whatever its element type: 16-byte
// words where the page and layer sizes allow, else 4-byte words, else
// bytes.  Bit-exact; src == dst leaves the pool unchanged (each thread reads
// and writes its own word).  Bound by bytes: 2 * L * page_bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileKeys = 32;       // keys per stage of the ring: one per lane when scoring
constexpr int kStages = 2;          // depth of the cp.async ring
constexpr int kSplitKeys = 128;     // keys per CTA: the fixed partition of a slot's history
constexpr int kHeadsPerWarp = 2;    // query heads a warp owns: head w + kWarps j
constexpr int kHeadsPerCta = kWarps * kHeadsPerWarp;
constexpr int kMaxDimChunks = 4;    // dh <= 64 kMaxDimChunks: lane l holds 2l, 2l+1 (+ 64 j)
constexpr float kMask = -FLT_MAX;   // finfo(float32).min, the TPU kernel's fill
static_assert(kSplitKeys % kTileKeys == 0, "a split is whole tiles");
static_assert(kTileKeys == 32, "lane t scores key t of a tile");
static_assert(kHeadsPerWarp == 2, "a key's probabilities for a warp's heads are one float2");
static_assert(kSplitKeys <= kThreads, "one thread looks up each key of a split");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes of a K or V row in shared memory as fp32 values, and the pair of
// values at an even column.  bf16 widens exactly: its bits are the top half
// of the fp32 value's.
template <typename T>
struct Row;
template <>
struct Row<float> {
  static constexpr int kElems = 4;
  __device__ static void load(const unsigned char* s, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ static float2 pair(const unsigned char* s) {
    return *reinterpret_cast<const float2*>(s);
  }
};
template <>
struct Row<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static void load(const unsigned char* s, float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float2 pair(const unsigned char* s) {
    const unsigned w = *reinterpret_cast<const unsigned*>(s);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  }
};

// One word of a K/V row, global -> shared: cp.async of 16, 8 or 4 bytes, or
// a plain 2-byte copy (a bf16 row whose address is only 2-byte aligned).
__device__ __forceinline__ void copy_word(unsigned char* smem, const unsigned char* gmem,
                                          int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
                 : "memory");
  else
    *reinterpret_cast<unsigned short*>(smem) = *reinterpret_cast<const unsigned short*>(gmem);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* seq_pos;
  void* out;
  float* ws;  // partials: acc (B, H, splits, dh), then (m, l) (B, H, splits, 2)
  int B, H, hkv, dh, page, maxp, splits;
  int chunks;      // head chunks per kv head: ceil(G / kHeadsPerCta)
  int copy_bytes;  // 16, 8, 4 or 2: the widest word every K/V row is aligned to
  float scale;
};

// The keys of slot b that count: 0 .. seq_pos[b] (inclusive), within the
// table's reach.
__device__ __forceinline__ long long slot_keys(const DecodeArgs& p, int b) {
  const long long n = static_cast<long long>(p.seq_pos[b]) + 1;
  const long long reach = static_cast<long long>(p.maxp) * p.page;
  return n < reach ? n : reach;
}

// A K or V row in shared memory: its 16-byte chunks, zero-padded past dh,
// and an odd count of them, so that the 8 lanes of a quarter warp reading
// 16 bytes of 8 different rows hit different banks.
__host__ __device__ inline int row_chunks(int dh, int esz) { return (dh * esz + 15) / 16; }
__host__ __device__ inline int row_bytes(int dh, int esz) {
  return (row_chunks(dh, esz) | 1) * 16;
}

// Shared memory: the K/V ring (stages x {K, V} x kTileKeys rows), the byte
// offset of each of the split's keys in the pools, kHeadsPerCta q rows in
// fp32 (zero past the CTA's heads and past dh), and each warp's
// probabilities of a tile (keys x kHeadsPerWarp).
__host__ __device__ inline long long decode_smem_bytes(int dh, int esz) {
  return static_cast<long long>(kStages) * 2 * kTileKeys * row_bytes(dh, esz) +
         8LL * kSplitKeys + 4LL * kHeadsPerCta * row_chunks(dh, esz) * (16 / esz) +
         4LL * kWarps * kTileKeys * kHeadsPerWarp;
}

// Loads a thread issues before it uses the first of them: global loads in
// a loop whose next load waits on the last one would pay the memory's
// latency once per iteration.
constexpr int kBatch = 8;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(DecodeArgs p) {
  constexpr int E = Row<T>::kElems;
  const int b = blockIdx.x;
  const long long n_keys = slot_keys(p, b);
  const long long key0 = static_cast<long long>(blockIdx.z) * kSplitKeys;
  if (key0 >= n_keys) return;  // past the slot's last key
  const int n_split =
      static_cast<int>(n_keys - key0 < kSplitKeys ? n_keys - key0 : kSplitKeys);
  const int G = p.H / p.hkv;
  const int kvh = blockIdx.y / p.chunks;
  const int per_chunk = (G + p.chunks - 1) / p.chunks;
  const int g0 = (blockIdx.y - kvh * p.chunks) * per_chunk;  // first head within the group
  const int heads = G - g0 < per_chunk ? G - g0 : per_chunk;
  if (heads <= 0) return;
  const int dh = p.dh;
  const int esz = static_cast<int>(sizeof(T));
  const int chunks = row_chunks(dh, esz);
  const int rb = row_bytes(dh, esz);
  const int qs = chunks * E;  // q row stride in floats

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  long long* off_s = reinterpret_cast<long long*>(smem + kStages * 2 * kTileKeys * rb);
  float* q_s = reinterpret_cast<float*>(off_s + kSplitKeys);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* pw = q_s + kHeadsPerCta * qs + warp * kTileKeys * kHeadsPerWarp;

  // each key's row: its page from the slot's table row, one load per key,
  // all in flight at once
  const int data = dh * esz;
  const long long key_bytes = static_cast<long long>(p.hkv) * data;
  const int* row = p.table + static_cast<long long>(b) * p.maxp;
  if (tid < n_split) {
    const long long key = key0 + tid;
    const long long j = key / p.page;
    off_s[tid] = (static_cast<long long>(row[j]) * p.page + (key - j * p.page)) * key_bytes;
  }
  // the rows' padding past dh: zero once, no copy writes it
  const int tail = chunks * 16 - data;
  for (int e = tid; e < kStages * 2 * kTileKeys * tail; e += kThreads) {
    const int r = e / tail;
    ring[r * rb + data + (e - r * tail)] = 0;
  }
  __syncthreads();

  const int W = p.copy_bytes;
  const int words = data / W;
  const unsigned char* kpool = static_cast<const unsigned char*>(p.k) + kvh * data;
  const unsigned char* vpool = static_cast<const unsigned char*>(p.v) + kvh * data;
  auto load_tile = [&](int tile) {
    unsigned char* ks = ring + (tile % kStages) * 2 * kTileKeys * rb;
    unsigned char* vs = ks + kTileKeys * rb;
    const long long* offs = off_s + tile * kTileKeys;
    const int n = n_split - tile * kTileKeys < kTileKeys ? n_split - tile * kTileKeys
                                                         : kTileKeys;
    for (int e = tid; e < n * words; e += kThreads) {
      const int r = e / words;
      const int w = e - r * words;
      const long long off = offs[r] + static_cast<long long>(w) * W;
      copy_word(ks + r * rb + w * W, kpool + off, W);
      copy_word(vs + r * rb + w * W, vpool + off, W);
    }
  };

  // the warp's heads: local w + kWarps j for j < nh (warp-uniform)
  const int nh = warp < heads ? (heads - warp + kWarps - 1) / kWarps : 0;
  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp], acc[kHeadsPerWarp][DC][2];
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    m_run[j] = kMask;
    l_run[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[j][c][0] = acc[j][c][1] = 0.0f;
  }

  const int tiles = (n_split + kTileKeys - 1) / kTileKeys;
  load_tile(0);
  cp_async_commit();
  if (tiles > 1) load_tile(1);
  cp_async_commit();

  // q, while the first tiles are in flight: kBatch loads before their stores
  const int h0 = kvh * G + g0;  // the CTA's first query head
  const T* q = static_cast<const T*>(p.q) + (static_cast<long long>(b) * p.H + h0) * dh;
  for (int e0 = 0; e0 < kHeadsPerCta * qs; e0 += kBatch * kThreads) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + tid;
      const int g = e / qs;
      const int d = e - g * qs;
      x[u] = g < heads && d < dh ? to_f32(q[g * dh + d]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads + tid;
      if (e < kHeadsPerCta * qs) q_s[e] = x[u];
    }
  }
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kStages - 1>();  // tile i has landed (this thread's words)
    __syncthreads();               // ... everyone's, and q and the padding
    const unsigned char* ks = ring + (i % kStages) * 2 * kTileKeys * rb;
    const unsigned char* vs = ks + kTileKeys * rb;
    const int n = n_split - i * kTileKeys < kTileKeys ? n_split - i * kTileKeys : kTileKeys;
    if (nh > 0) {
      // scores: lane t, key t, against the warp's heads.  A head slot past
      // nh computes too (on q rows of zeros, never written), here and
      // below, so that the loops run without branches and the heads'
      // chains interleave; each head sums even and odd columns apart.
      float s[kHeadsPerWarp][2] = {};
      if (lane < n) {
        const unsigned char* kr = ks + lane * rb;
#pragma unroll 4
        for (int c = 0; c < chunks; ++c) {
          float kv[E];
          Row<T>::load(kr + c * 16, kv);
#pragma unroll
          for (int j = 0; j < kHeadsPerWarp; ++j) {
            const float* qg = q_s + (warp + kWarps * j) * qs + c * E;
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + e);
              s[j][0] = fmaf(qv.x, kv[e], s[j][0]);
              s[j][1] = fmaf(qv.y, kv[e + 1], s[j][1]);
              s[j][0] = fmaf(qv.z, kv[e + 2], s[j][0]);
              s[j][1] = fmaf(qv.w, kv[e + 3], s[j][1]);
            }
          }
        }
      }
      // the online softmax of each head over the tile, reduced across lanes
      float alpha[kHeadsPerWarp];
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j) {
        const float sc = lane < n ? (s[j][0] + s[j][1]) * p.scale : kMask;
        const float m_new = fmaxf(m_run[j], warp_max(sc));
        alpha[j] = expf(m_run[j] - m_new);
        const float pt = lane < n ? expf(sc - m_new) : 0.0f;
        l_run[j] = l_run[j] * alpha[j] + warp_sum(pt);
        m_run[j] = m_new;
        pw[lane * kHeadsPerWarp + j] = pt;
      }
      __syncwarp();
      // acc = acc * alpha + P @ V, P in fp32
#pragma unroll
      for (int j = 0; j < kHeadsPerWarp; ++j)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[j][c][0] *= alpha[j];
          acc[j][c][1] *= alpha[j];
        }
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float2 pv = *reinterpret_cast<const float2*>(pw + t * kHeadsPerWarp);
        const float pr[kHeadsPerWarp] = {pv.x, pv.y};
        const unsigned char* vr = vs + t * rb;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = 2 * lane + 64 * c;
          if (d < dh) {
            const float2 v2 = Row<T>::pair(vr + d * esz);
#pragma unroll
            for (int j = 0; j < kHeadsPerWarp; ++j) {
              acc[j][c][0] = fmaf(pr[j], v2.x, acc[j][c][0]);
              acc[j][c][1] = fmaf(pr[j], v2.y, acc[j][c][1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the tile two ahead
    if (i + kStages < tiles) load_tile(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();  // nothing is left in flight at exit

  // the partial of each of the warp's heads for this split
  float* ml = p.ws + static_cast<long long>(p.B) * p.H * p.splits * dh;
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    if (j < nh) {
      const long long slot =
          (static_cast<long long>(b) * p.H + h0 + warp + kWarps * j) * p.splits + blockIdx.z;
      float* pa = p.ws + slot * dh;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < dh) pa[d] = acc[j][c][0];
        if (d + 1 < dh) pa[d + 1] = acc[j][c][1];
      }
      if (lane == 0) {
        ml[2 * slot] = m_run[j];
        ml[2 * slot + 1] = l_run[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(DecodeArgs p) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const long long n_keys = slot_keys(p, b);
  const int used = n_keys > 0 ? static_cast<int>((n_keys + kSplitKeys - 1) / kSplitKeys) : 0;
  const long long slot0 = (static_cast<long long>(b) * p.H + h) * p.splits;
  const float* ml = p.ws + static_cast<long long>(p.B) * p.H * p.splits * p.dh + 2 * slot0;
  const float* pa = p.ws + slot0 * p.dh;
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h) * p.dh;
  // kBatch splits' loads at a time, then their sums in ascending order
  float m = kMask;
  for (int i0 = 0; i0 < used; i0 += kBatch) {
    float mi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) mi[u] = i0 + u < used ? ml[2 * (i0 + u)] : kMask;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) m = fmaxf(m, mi[u]);
  }
  for (int d = threadIdx.x; d < p.dh; d += kThreads) {
    float l = 0.0f, acc = 0.0f;
    for (int i0 = 0; i0 < used; i0 += kBatch) {
      float mi[kBatch], li[kBatch], ai[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool ok = i0 + u < used;
        mi[u] = ok ? ml[2 * (i0 + u)] : kMask;
        li[u] = ok ? ml[2 * (i0 + u) + 1] : 0.0f;
        ai[u] = ok ? pa[static_cast<long long>(i0 + u) * p.dh + d] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0 + u < used) {
          const float f = expf(mi[u] - m);
          l += li[u] * f;
          acc += ai[u] * f;
        }
      }
    }
    if (l == 0.0f) l = 1.0f;  // no key (seq_pos < 0): zeros, as before the split
    out[d] = from_f32<T>(acc / l);
  }
}

// Shared memory above 48 KB is an attribute of the function on each
// device: set it once per device for the largest size asked so far, not on
// every launch of the host-bound decode step.
constexpr int kMaxDevices = 64;

template <typename T, int DC>
cudaError_t allow_smem(long long smem) {
  static long long allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_decode_kernel<T, DC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return e;
}

template <typename T, int DC>
int launch_decode_dc(const DecodeArgs& p, cudaStream_t stream) {
  const long long smem = decode_smem_bytes(p.dh, sizeof(T));
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<T, DC>(smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B, p.hkv * p.chunks, p.splits);
  paged_decode_kernel<T, DC><<<grid, kThreads, static_cast<size_t>(smem), stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_decode_combine_kernel<T><<<dim3(p.B, p.H), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, const int* table,
                  const int* seq_pos, void* out, float* ws, int B, int H, int hkv, int dh,
                  int page, int maxp, int splits, float scale, void* stream) {
  if (B < 1 || hkv < 1 || H % hkv != 0 || H > 65535 || dh < 1 ||
      dh > 64 * kMaxDimChunks || page < 1 || maxp < 1)
    return cudaErrorInvalidValue;
  // the wrapper sized the workspace for this many splits
  const long long reach = static_cast<long long>(maxp) * page;
  if (splits != (reach + kSplitKeys - 1) / kSplitKeys || splits > 65535)
    return cudaErrorInvalidValue;
  const int G = H / hkv;
  const int chunks = (G + kHeadsPerCta - 1) / kHeadsPerCta;
  if (static_cast<long long>(hkv) * chunks > 65535) return cudaErrorInvalidValue;
  const int data = dh * static_cast<int>(sizeof(T));
  const unsigned long long align = reinterpret_cast<unsigned long long>(k) |
                                   reinterpret_cast<unsigned long long>(v) |
                                   static_cast<unsigned long long>(data);
  const int copy = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 2;
  const DecodeArgs p{q,    k,    v,    table,  seq_pos, out,  ws,   B,    H,
                     hkv,  dh,   page, maxp,   splits,  chunks, copy, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 64) return launch_decode_dc<T, 1>(p, s);
  if (dh <= 128) return launch_decode_dc<T, 2>(p, s);
  return launch_decode_dc<T, 4>(p, s);
}

constexpr int kMlaThreads = 256;
constexpr int kMlaWarps = kMlaThreads / 32;
constexpr int kMlaHeads = 16;         // query heads per CTA: one m16 tile
constexpr int kMlaMaxLatent = 512;    // r: kMlaWarps warps x 64 output columns
constexpr int kMlaMaxDims = 576;      // r + dr: the query fragments a warp holds in registers
constexpr int kMlaColsPerWarp = kMlaMaxLatent / kMlaWarps;
constexpr int kMlaPParts = 3;         // bf16 parts of each probability in P @ V (bf16 pools)
constexpr int kMlaCombineThreads = 128;
static_assert(kMlaHeads == 16, "a head's softmax runs on 16 threads; one m16 tile of heads");
static_assert(kMlaColsPerWarp == 64, "warp w owns the latent columns [64 w, 64 w + 64)");

// The math of each pool type.  Acc: the accumulation type, fp64 for fp32
// pools -- at DeepSeek-V3 width an fp32 sum over 1901 keys (and a 576-term
// score) in another order than the plain version's drifts by tens of
// half-ulps, past the 1e-6 the fp32 comparison allows; a wider sum rounds
// once, where the plain version rounds too.  kDimGroups: the warps that
// split a tile's dimensions in the score phase (the others split its keys);
// kStep: the depth of one mma, in dimensions (scores) or keys (P @ V).
// kStages >= 2: the query is staged in the ring's last stage.  kSplitKeys:
// the fixed partition of a slot's history, keys per CTA (at most one a
// thread: each looks up one key's page).
template <typename T>
struct MlaMath;
template <>
struct MlaMath<float> {
  using Acc = double;
  static constexpr int kSplitKeys = 256;  // one CTA a SM: 112 CTAs, one round, at the phase-7 shape
  static constexpr int kTileKeys = 16;
  static constexpr int kStages = 3;       // depth of the ring
  static constexpr int kDimGroups = 8;
  static constexpr int kStep = 8;         // mma m16n8k8 f64
  static constexpr int kProbStride = 17;  // doubles a head's probabilities take
  static constexpr int kMinBlocks = 1;
};
template <>
struct MlaMath<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kSplitKeys = 128;  // two CTAs a SM: all 200 at once
  static constexpr int kTileKeys = 32;
  static constexpr int kStages = 2;       // two CTAs a SM keep two rings in flight
  static constexpr int kDimGroups = 4;
  static constexpr int kStep = 16;        // mma m16n8k16 bf16
  static constexpr int kProbStride = 40;  // bf16 a head's probabilities take: rows 80 bytes apart
  static constexpr int kMinBlocks = 2;
};

// Shared memory of the split kernel, in bytes from the start: the ring
// (kStages x kTileKeys rows of dp values in the pools' type, dp = r + dr
// rounded up to whole mma steps of every dimension group, zero past r + dr,
// 16 bytes of padding a row: ldmatrix and the fp32 fragment loads then hit
// distinct banks; the last stage holds the query until the loop starts);
// each key's row index in the pools; the partial scores (dim groups x heads
// x keys, Acc); the tile's probabilities (fp64 for fp32 pools, kMlaPParts
// bf16 planes for bf16 pools); each head's rescale factor.
template <typename T>
struct MlaLayout {
  int dp, row_bytes;
  long long rows, part, prob, alpha, bytes;
  __host__ __device__ explicit MlaLayout(int dims) {
    using M = MlaMath<T>;
    constexpr int q = M::kStep * M::kDimGroups;
    dp = (dims + q - 1) / q * q;
    row_bytes = dp * static_cast<int>(sizeof(T)) + 16;
    rows = static_cast<long long>(M::kStages) * M::kTileKeys * row_bytes;
    part = rows + 8LL * M::kSplitKeys;
    prob = part + static_cast<long long>(sizeof(typename M::Acc)) * M::kDimGroups * kMlaHeads *
                      M::kTileKeys;
    const long long prob_bytes =
        sizeof(T) == 4 ? 8LL * kMlaHeads * M::kProbStride
                       : 2LL * kMlaPParts * kMlaHeads * M::kProbStride;
    alpha = prob + (prob_bytes + 15) / 16 * 16;
    bytes = alpha + 4LL * kMlaHeads;
  }
};

struct MlaArgs {
  const void* q_lat;
  const void* q_rope;
  const void* ckv;
  const void* krope;
  const int* table;
  const int* seq_pos;
  void* out;
  // partials: l (B, H, splits) in Acc, then m (B, H, splits) and acc (B, H,
  // splits, r) in fp32 (an fp32 acc of one split adds at most an ulp)
  void* ws;
  int B, H, r, dr, page, maxp, splits;
  int copy_bytes;    // 16, 8, 4 or 2: the widest word every latent and rope row is aligned to
  int q_copy_bytes;  // ... and every q_lat and q_rope row
  float scale;
};

// D (16 x 8, fp64) += A (16 x 8) B (8 x 8): a0..a3 = A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]; b0, b1 = B[t][g], B[t + 4][g]; d0..d3 =
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1] (g = lane / 4,
// t = lane % 4).  Not volatile, here and below: the compiler may then
// interleave the products of independent accumulators.
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4], double b0,
                                        double b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// D (16 x 8, fp32) += A (16 x 16, bf16) B (16 x 8, bf16); fragments as
// ldmatrix gives them, D as above.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&x)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_u32(smem))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&x)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(smem_u32(smem))
               : "memory");
}

// The keys of slot b that count: 0 .. seq_pos (inclusive), within the
// table's reach.
__device__ __forceinline__ long long mla_slot_keys(const MlaArgs& p, int pos) {
  const long long n = static_cast<long long>(pos) + 1;
  const long long reach = static_cast<long long>(p.maxp) * p.page;
  return n < reach ? n : reach;
}

// The ring's barriers: one mbarrier a stage (and one for the query) that
// completes when the stage's rows have landed.  With 16-byte rows (r and dr
// in whole 16-byte words at 16-byte aligned pools) one thread arms it with
// the stage's bytes and warp 0 copies each row with one bulk copy (the
// Tensor Memory Accelerator); else every thread copies words with cp.async
// and arrives when its copies land.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The two parts of one row to copy: a latent (or q_lat) row and a rope (or
// q_rope) row, which lands right after it.
struct RowSrc {
  const unsigned char* a;
  const unsigned char* b;
};

// Copy n_rows rows (row i from src(i), a_bytes then row_data - a_bytes)
// into ring rows of row_bytes and complete `bar` when they land: bulk
// copies issued by warp 0 (n_rows <= 32) where W is 16, else cp.async
// words of W from every thread (warp w takes the rows w, w + kMlaWarps, ...,
// its lanes the words).
template <typename Src>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int row_bytes, int n_rows,
                                          int a_bytes, int row_data, int W, Src src,
                                          unsigned long long* bar) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (W == 16) {
    if (warp == 0) {
      if (lane == 0) mbar_expect_bytes(bar, static_cast<unsigned>(n_rows * row_data));
      __syncwarp();
      if (lane < n_rows) {
        const RowSrc from = src(lane);
        unsigned char* d = dst + lane * row_bytes;
        bulk_copy(d, from.a, a_bytes, bar);
        if (row_data > a_bytes) bulk_copy(d + a_bytes, from.b, row_data - a_bytes, bar);
      }
    }
    return;
  }
  const int wa = a_bytes / W;
  const int wrow = row_data / W;
  for (int i = warp; i < n_rows; i += kMlaWarps) {
    const RowSrc from = src(i);
    unsigned char* d = dst + i * row_bytes;
    for (int w = lane; w < wrow; w += 32)
      copy_word(d + w * W, w < wa ? from.a + w * W : from.b + (w - wa) * W, W);
  }
  mbar_arrive_on_copies(bar);
}

template <typename T>
__global__ void __launch_bounds__(kMlaThreads, MlaMath<T>::kMinBlocks)
    mla_decode_kernel(MlaArgs p) {
  using M = MlaMath<T>;
  using A = typename M::Acc;
  constexpr bool kF64 = sizeof(T) == 4;
  constexpr int SK = M::kSplitKeys;
  constexpr int TK = M::kTileKeys;
  constexpr int kS = M::kStages;
  static_assert(SK <= kMlaThreads && SK % TK == 0, "a thread a key; whole tiles");
  constexpr int DG = M::kDimGroups;
  constexpr int KS_MAX = kMlaMaxDims / (M::kStep * DG);  // mma steps a dim group takes
  constexpr int esz = static_cast<int>(sizeof(T));
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int h0 = blockIdx.x * kMlaHeads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // an mma fragment's row group
  const int t = lane & 3;    // ... and its column pair
  const int i8 = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int r8 = lane & 7;   // ... and its row
  const int r = p.r;
  const int D = r + p.dr;
  const MlaLayout<T> L(D);
  extern __shared__ __align__(16) unsigned char mla_smem[];
  unsigned char* ring = mla_smem;
  long long* rows_s = reinterpret_cast<long long*>(mla_smem + L.rows);
  A* part = reinterpret_cast<A*>(mla_smem + L.part);
  float* alpha_s = reinterpret_cast<float*>(mla_smem + L.alpha);

  // seq_pos and this thread's key's table entry, in flight together
  const long long reach = static_cast<long long>(p.maxp) * p.page;
  const long long key0 = static_cast<long long>(z) * SK;
  const long long my_key = key0 + tid;
  const int pos = p.seq_pos[b];
  int phys = 0;
  if (tid < SK && my_key < reach)
    phys = p.table[static_cast<long long>(b) * p.maxp + my_key / p.page];
  const long long n_keys = mla_slot_keys(p, pos);
  if (key0 >= n_keys) return;  // past the slot's last key
  const int n = static_cast<int>(n_keys - key0 < SK ? n_keys - key0 : SK);
  // the ring's barriers (the query's last), before anything arrives on them
  __shared__ unsigned long long full_s[kS + 1];
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) mbar_init(full_s + s, p.copy_bytes == 16 ? 1 : kMlaThreads);
    mbar_init(full_s + kS, p.q_copy_bytes == 16 ? 1 : kMlaThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query, into the ring's last stage: row hl is head h0 + hl (rows past
  // H repeat head H - 1; their outputs are dropped).  Bulk copies leave from
  // warp 0 at once (the warp of the thread that set up the barriers), words
  // from every thread after the barrier below.
  const int data = D * esz;
  const long long c_bytes = static_cast<long long>(r) * esz;
  const long long r_bytes = static_cast<long long>(p.dr) * esz;
  unsigned char* q_s = ring + (kS - 1) * TK * L.row_bytes;
  auto stage_query = [&] {
    copy_rows(
        q_s, L.row_bytes, kMlaHeads, r * esz, data, p.q_copy_bytes,
        [&](int hl) {
          const long long h =
              static_cast<long long>(b) * p.H + (h0 + hl < p.H ? h0 + hl : p.H - 1);
          return RowSrc{static_cast<const unsigned char*>(p.q_lat) + h * c_bytes,
                        static_cast<const unsigned char*>(p.q_rope) + h * r_bytes};
        },
        full_s + kS);
  };
  if (p.q_copy_bytes == 16) {
    __syncwarp();
    stage_query();
  }
  if (tid < n) rows_s[tid] = static_cast<long long>(phys) * p.page + my_key % p.page;
  // the rows' padding past r + dr: zero once, no copy writes it
  const int tail = L.dp * esz - data;
  for (int e = tid; e < kS * TK * tail; e += kMlaThreads) {
    const int i = e / tail;
    ring[i * L.row_bytes + data + (e - i * tail)] = 0;
  }
  __syncthreads();
  if (p.q_copy_bytes != 16) stage_query();

  const unsigned char* cpool = static_cast<const unsigned char*>(p.ckv);
  const unsigned char* rpool = static_cast<const unsigned char*>(p.krope);
  auto load_tile = [&](int tile) {
    // rows past the split's end repeat its last key: finite, and p = 0
    const int k0 = tile * TK;
    copy_rows(
        ring + (tile % kS) * TK * L.row_bytes, L.row_bytes, TK, r * esz, data, p.copy_bytes,
        [&](int i) {
          const long long row = rows_s[k0 + i < n ? k0 + i : n - 1];
          return RowSrc{cpool + row * c_bytes, rpool + row * r_bytes};
        },
        full_s + tile % kS);
  };
  const int tiles = (n + TK - 1) / TK;
#pragma unroll
  for (int s = 0; s < kS - 1; ++s)
    if (s < tiles) load_tile(s);

  // the query fragments of the warp's dimension group, in registers for the
  // whole split: dims [dg dpg, (dg + 1) dpg) of q_lat | q_rope (zero past)
  const int dg = warp % DG;
  const int kg = warp / DG;  // the warp's 16 keys of a tile in the score phase
  const int dpg = L.dp / DG;
  const int ks = dpg / M::kStep;
  using QFrag = typename std::conditional<kF64, double[4], unsigned[4]>::type;
  QFrag qf[KS_MAX];
  mbar_wait(full_s + kS, 0);  // the query has landed; the first tiles may not have
#pragma unroll
  for (int j = 0; j < KS_MAX; ++j) {
    if (j < ks) {
      const int d = dg * dpg + j * M::kStep;
      if constexpr (kF64) {
        const float* qr = reinterpret_cast<const float*>(q_s);
        const int S = L.row_bytes / 4;
        qf[j][0] = qr[g * S + d + t];
        qf[j][1] = qr[(8 + g) * S + d + t];
        qf[j][2] = qr[g * S + d + t + 4];
        qf[j][3] = qr[(8 + g) * S + d + t + 4];
      } else {
        ldmatrix_x4(qf[j], q_s + (r8 + 8 * (i8 & 1)) * L.row_bytes + (d + 8 * (i8 >> 1)) * 2);
      }
    }
  }
  __syncthreads();  // the last stage is the ring's again

  // the warp's latent columns of every head: acc[j] for heads g, g + 8,
  // columns c0 + 8 j + 2 t (+1)
  const int c0 = warp * kMlaColsPerWarp;
  constexpr int NT = kMlaColsPerWarp / 8;
  A acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  // the softmax phase: thread (head hs, keys sub + 16 u); the head's running
  // max (the same on its 16 threads) and this thread's share of its
  // denominator
  const int hs = tid >> 4;
  const int sub = tid & 15;
  float m_run = kMask;
  A l_part = 0;

  for (int i = 0; i < tiles; ++i) {
    // the stage of tile i - 1 is free (the loop's last barrier): fill it
    if (i + kS - 1 < tiles) load_tile(i + kS - 1);
    mbar_wait(full_s + i % kS, (i / kS) & 1);  // tile i has landed
    const unsigned char* st = ring + (i % kS) * TK * L.row_bytes;
    const int nt = n - i * TK < TK ? n - i * TK : TK;  // live keys of the tile

    // 1. partial scores: the warp's dims, its 16 keys (two n8 tiles), 16
    // heads; even and odd steps in separate accumulators, for more mma in
    // flight
    A sc[2][2][4] = {};
    if constexpr (kF64) {
      const float* kt = reinterpret_cast<const float*>(st);
      const int S = L.row_bytes / 4;
#pragma unroll
      for (int j = 0; j < KS_MAX; ++j) {
        if (j < ks) {
          const int d = dg * dpg + j * M::kStep + t;
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const float* kr = kt + (kg * 16 + nn * 8 + g) * S + d;
            mma_f64(sc[j & 1][nn], qf[j], kr[0], kr[4]);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < KS_MAX; ++j) {
        if (j < ks) {
          unsigned bf[4];  // b0, b1 of keys kg*16 + [0, 8), then of [8, 16)
          ldmatrix_x4(bf, st + (kg * 16 + r8 + 8 * (i8 >> 1)) * L.row_bytes +
                              (dg * dpg + j * M::kStep + 8 * (i8 & 1)) * 2);
          mma_bf16(sc[j & 1][0], qf[j], bf[0], bf[1]);
          mma_bf16(sc[j & 1][1], qf[j], bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      A* dst = part + (dg * kMlaHeads + g) * TK + kg * 16 + nn * 8 + 2 * t;
      dst[0] = sc[0][nn][0] + sc[1][nn][0];
      dst[1] = sc[0][nn][1] + sc[1][nn][1];
      dst[8 * TK] = sc[0][nn][2] + sc[1][nn][2];
      dst[8 * TK + 1] = sc[0][nn][3] + sc[1][nn][3];
    }
    __syncthreads();

    // 2. the online softmax of head hs over the tile
    {
      constexpr int U = TK / 16;
      float s[U];
      float tmax = kMask;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = sub + 16 * u;
        A sum = 0;
#pragma unroll
        for (int d2 = 0; d2 < DG; ++d2) sum += part[(d2 * kMlaHeads + hs) * TK + k];
        s[u] = k < nt ? static_cast<float>(sum * static_cast<A>(p.scale)) : kMask;
        tmax = fmaxf(tmax, s[u]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_run, tmax);
      const float alpha = expf(m_run - m_new);
      A psum = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = sub + 16 * u;
        const float pr = expf(s[u] - m_new);  // 0 for a masked key
        psum += static_cast<A>(pr);
        if constexpr (kF64) {
          reinterpret_cast<double*>(mla_smem + L.prob)[hs * M::kProbStride + k] = pr;
        } else {
          // hi + mid + lo: each part rounds the remainder, which is exact in fp32
          __nv_bfloat16* pl = reinterpret_cast<__nv_bfloat16*>(mla_smem + L.prob);
          float rest = pr;
#pragma unroll
          for (int q = 0; q < kMlaPParts; ++q) {
            const __nv_bfloat16 x = __float2bfloat16(rest);
            pl[(q * kMlaHeads + hs) * M::kProbStride + k] = x;
            rest -= __bfloat162float(x);
          }
        }
      }
      l_part = l_part * static_cast<A>(alpha) + psum;
      m_run = m_new;
      if (sub == 0) alpha_s[hs] = alpha;
    }
    __syncthreads();

    // 3. acc = acc * alpha + P @ c_kv over the warp's columns
    const A a0 = alpha_s[g], a1 = alpha_s[8 + g];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    if constexpr (kF64) {
      const double* pd = reinterpret_cast<const double*>(mla_smem + L.prob);
      const float* vt = reinterpret_cast<const float*>(st);
      const int S = L.row_bytes / 4;
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        // step j's k-indices t and t + 4 are the keys 8 j + 2 t and 8 j + 2 t
        // + 1: a step's keys for one k-index sit 2 rows apart, so with a row
        // stride of 4 (mod 32) words the 32 lanes' c_kv loads hit 32 banks
        const int key = 8 * j + 2 * t;
        const double pa[4] = {pd[g * M::kProbStride + key], pd[(8 + g) * M::kProbStride + key],
                              pd[g * M::kProbStride + key + 1],
                              pd[(8 + g) * M::kProbStride + key + 1]};
        const float* vr = vt + key * S + c0 + g;
#pragma unroll
        for (int nn = 0; nn < NT; ++nn)
          if (c0 + nn * 8 < r) mma_f64(acc[nn], pa, vr[nn * 8], vr[S + nn * 8]);
      }
    } else {
      const unsigned char* pl = mla_smem + L.prob;
#pragma unroll
      for (int j = 0; j < TK / 16; ++j) {
        unsigned pa[kMlaPParts][4];
#pragma unroll
        for (int q = 0; q < kMlaPParts; ++q)
          ldmatrix_x4(pa[q], pl + ((q * kMlaHeads + r8 + 8 * (i8 & 1)) * M::kProbStride +
                                   16 * j + 8 * (i8 >> 1)) * 2);
        // the V fragments of half the warp's columns, then their products
        // part by part (the smallest first), so that consecutive products go
        // to different accumulators
#pragma unroll
        for (int h2 = 0; h2 < NT; h2 += NT / 2) {
          unsigned vb[NT / 4][4];  // b0, b1 of columns n0 + [0, 8), then of n0 + [8, 16)
#pragma unroll
          for (int nn = 0; nn < NT / 2; nn += 2) {
            const int n0 = c0 + (h2 + nn) * 8;
            if (n0 < r)
              ldmatrix_x4_trans(vb[nn / 2], st + (16 * j + r8 + 8 * (i8 & 1)) * L.row_bytes +
                                                (n0 + 8 * (i8 >> 1)) * 2);
          }
#pragma unroll
          for (int q = kMlaPParts - 1; q >= 0; --q)
#pragma unroll
            for (int nn = 0; nn < NT / 2; ++nn)
              if (c0 + (h2 + nn) * 8 < r)
                mma_bf16(acc[h2 + nn], pa[q], vb[nn / 2][2 * (nn & 1)],
                         vb[nn / 2][2 * (nn & 1) + 1]);
        }
      }
    }
    __syncthreads();  // the stage, the partial scores and P are free
  }

  // the partial of each head for this split
  A l = l_part;
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const long long N = static_cast<long long>(p.B) * p.H * p.splits;
  A* ws_l = static_cast<A*>(p.ws);
  float* ws_m = reinterpret_cast<float*>(ws_l + N);
  float* ws_acc = ws_m + N;
  const long long slot0 = static_cast<long long>(b) * p.H * p.splits + z;
  if (sub == 0 && h0 + hs < p.H) {
    ws_l[slot0 + static_cast<long long>(h0 + hs) * p.splits] = l;
    ws_m[slot0 + static_cast<long long>(h0 + hs) * p.splits] = m_run;
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int h = h0 + m * 8 + g;
    if (h >= p.H) continue;
    float* dst = ws_acc + (slot0 + static_cast<long long>(h) * p.splits) * r;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = c0 + j * 8 + 2 * t;
      if (c < r) dst[c] = static_cast<float>(acc[j][2 * m]);
      if (c + 1 < r) dst[c + 1] = static_cast<float>(acc[j][2 * m + 1]);
    }
  }
}

// One CTA per (head, slot): merges the head's partials in ascending split
// order, kBatch splits' loads in flight at a time, each thread kMlaCombine
// latent columns.
constexpr int kMlaCombine = kMlaMaxLatent / kMlaCombineThreads;

template <typename T>
__global__ void __launch_bounds__(kMlaCombineThreads) mla_decode_combine_kernel(MlaArgs p) {
  using A = typename MlaMath<T>::Acc;
  constexpr int SK = MlaMath<T>::kSplitKeys;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const long long n_keys = mla_slot_keys(p, p.seq_pos[b]);
  const int used =
      n_keys > 0 ? static_cast<int>((n_keys + SK - 1) / SK) : 0;
  const long long N = static_cast<long long>(p.B) * p.H * p.splits;
  const long long slot0 = (static_cast<long long>(b) * p.H + h) * p.splits;
  const A* ls = static_cast<const A*>(p.ws) + slot0;
  const float* ms = reinterpret_cast<const float*>(static_cast<const A*>(p.ws) + N) + slot0;
  const float* pa = reinterpret_cast<const float*>(static_cast<const A*>(p.ws) + N) + N +
                    slot0 * p.r;
  float m = kMask;
  for (int i0 = 0; i0 < used; i0 += kBatch) {
    float mi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) mi[u] = i0 + u < used ? ms[i0 + u] : kMask;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) m = fmaxf(m, mi[u]);
  }
  A l = 0;
  A a[kMlaCombine] = {};
  for (int i0 = 0; i0 < used; i0 += kBatch) {
    float mi[kBatch];
    A li[kBatch];
    float x[kBatch][kMlaCombine];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = i0 + u < used;
      mi[u] = ok ? ms[i0 + u] : kMask;
      li[u] = ok ? ls[i0 + u] : 0;
#pragma unroll
      for (int c = 0; c < kMlaCombine; ++c) {
        const int col = threadIdx.x + c * kMlaCombineThreads;
        x[u][c] = ok && col < p.r ? pa[static_cast<long long>(i0 + u) * p.r + col] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u < used) {
        const A f = static_cast<A>(expf(mi[u] - m));
        l += li[u] * f;
#pragma unroll
        for (int c = 0; c < kMlaCombine; ++c) a[c] += static_cast<A>(x[u][c]) * f;
      }
    }
  }
  if (l == 0) l = 1;  // no key (seq_pos < 0): zeros
  T* out = static_cast<T*>(p.out) + (static_cast<long long>(b) * p.H + h) * p.r;
#pragma unroll
  for (int c = 0; c < kMlaCombine; ++c) {
    const int col = threadIdx.x + c * kMlaCombineThreads;
    if (col < p.r) out[col] = from_f32<T>(static_cast<float>(a[c] / l));
  }
}

// the widest word (16, 8, 4 or 2 bytes) two rows of bytes and their bases allow
__host__ inline int copy_width(const void* a, int a_bytes, const void* b, int b_bytes) {
  unsigned long long align = reinterpret_cast<unsigned long long>(a) |
                             static_cast<unsigned long long>(a_bytes);
  if (b_bytes > 0)
    align |= reinterpret_cast<unsigned long long>(b) | static_cast<unsigned long long>(b_bytes);
  return align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : align % 4 == 0 ? 4 : 2;
}

template <typename T>
int launch_mla_decode(const void* q_lat, const void* q_rope, const void* ckv,
                      const void* krope, const int* table, const int* seq_pos, void* out,
                      void* ws, int B, int H, int r, int dr, int page, int maxp, int splits,
                      float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || r < 1 || r > kMlaMaxLatent || dr < 0 ||
      r + dr > kMlaMaxDims || page < 1 || maxp < 1)
    return cudaErrorInvalidValue;
  // the wrapper sized the workspace for this many splits
  const long long reach = static_cast<long long>(maxp) * page;
  constexpr int SK = MlaMath<T>::kSplitKeys;
  if (splits != (reach + SK - 1) / SK || splits > 65535)
    return cudaErrorInvalidValue;
  const long long smem = MlaLayout<T>(r + dr).bytes;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    static long long allowed[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices || allowed[dev] < smem) {
      e = cudaFuncSetAttribute(mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return e;
      if (dev < kMaxDevices) allowed[dev] = smem;
    }
  }
  const int esz = static_cast<int>(sizeof(T));
  const MlaArgs p{q_lat, q_rope, ckv,  krope, table,  seq_pos,
                  out,   ws,     B,    H,     r,      dr,
                  page,  maxp,   splits, copy_width(ckv, r * esz, krope, dr * esz),
                  copy_width(q_lat, r * esz, q_rope, dr * esz), scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((H + kMlaHeads - 1) / kMlaHeads, B, splits);
  mla_decode_kernel<T><<<grid, kMlaThreads, static_cast<size_t>(smem), s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mla_decode_combine_kernel<T><<<dim3(H, B), kMlaCombineThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename W>
__global__ void __launch_bounds__(256)
paged_copy_kernel(char* pool, long long layer_bytes, long long page_bytes,
                  long long src, long long dst, long long words) {
  char* layer = pool + static_cast<long long>(blockIdx.y) * layer_bytes;
  const W* s = reinterpret_cast<const W*>(layer + src * page_bytes);
  W* d = reinterpret_cast<W*>(layer + dst * page_bytes);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < words; i += static_cast<long long>(gridDim.x) * blockDim.x)
    d[i] = s[i];
}

template <typename W>
int launch_copy(void* pool, int layers, long long layer_bytes, long long page_bytes,
                int src, int dst, void* stream) {
  const long long words = page_bytes / static_cast<long long>(sizeof(W));
  long long blocks = (words + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), layers);
  paged_copy_kernel<W><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), layer_bytes, page_bytes, src, dst, words);
  return cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_decode_f32(const void* q, const void* k, const void* v,
                                          const int* table, const int* seq_pos, void* out,
                                          float* ws, int B, int H, int hkv, int dh, int page,
                                          int maxp, int splits, float scale, void* stream) {
  return launch_decode<float>(q, k, v, table, seq_pos, out, ws, B, H, hkv, dh, page, maxp,
                              splits, scale, stream);
}

extern "C" int paged_attention_decode_bf16(const void* q, const void* k, const void* v,
                                           const int* table, const int* seq_pos, void* out,
                                           float* ws, int B, int H, int hkv, int dh,
                                           int page, int maxp, int splits, float scale,
                                           void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, table, seq_pos, out, ws, B, H, hkv, dh, page,
                                      maxp, splits, scale, stream);
}

extern "C" int mla_paged_attention_decode_f32(const void* q_lat, const void* q_rope,
                                              const void* ckv, const void* krope,
                                              const int* table, const int* seq_pos,
                                              void* out, void* ws, int B, int H, int r, int dr,
                                              int page, int maxp, int splits, float scale,
                                              void* stream) {
  return launch_mla_decode<float>(q_lat, q_rope, ckv, krope, table, seq_pos, out, ws, B, H, r,
                                  dr, page, maxp, splits, scale, stream);
}

extern "C" int mla_paged_attention_decode_bf16(const void* q_lat, const void* q_rope,
                                               const void* ckv, const void* krope,
                                               const int* table, const int* seq_pos,
                                               void* out, void* ws, int B, int H, int r,
                                               int dr, int page, int maxp, int splits,
                                               float scale, void* stream) {
  return launch_mla_decode<__nv_bfloat16>(q_lat, q_rope, ckv, krope, table, seq_pos, out, ws,
                                          B, H, r, dr, page, maxp, splits, scale, stream);
}

extern "C" int paged_copy(void* pool, int layers, long long layer_bytes,
                          long long page_bytes, int src, int dst, void* stream) {
  if (layers < 1 || layers > 65535 || page_bytes < 1) return cudaErrorInvalidValue;
  const unsigned long long base = reinterpret_cast<unsigned long long>(pool);
  if (base % 16 == 0 && layer_bytes % 16 == 0 && page_bytes % 16 == 0)
    return launch_copy<uint4>(pool, layers, layer_bytes, page_bytes, src, dst, stream);
  if (base % 4 == 0 && layer_bytes % 4 == 0 && page_bytes % 4 == 0)
    return launch_copy<unsigned int>(pool, layers, layer_bytes, page_bytes, src, dst,
                                     stream);
  return launch_copy<unsigned char>(pool, layers, layer_bytes, page_bytes, src, dst,
                                    stream);
}

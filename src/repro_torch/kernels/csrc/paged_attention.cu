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
// factors are fp32 values and the probabilities stay fp32 for the p @ c_kv
// product, as in the TPU kernel; the dot products and the sums over keys
// accumulate in a wider type (fp64 for fp32 pools, see MlaAcc) and round
// once.
//
// What bounds it on this card: one latent row (r + dr values) serves every
// query head, so each element loaded feeds 2 H multiply-adds (scores) plus
// H (the latent-space output) -- about 120 flop per fp32 byte at H = 128 --
// so with fp32 pools it is bound by operations (67 TFLOP/s fp32 outside the
// tensor cores; this kernel's fp64 accumulation runs at half that), not by
// the bytes of the latent history.  With bf16 pools the bf16 tensor-core
// rate makes the bytes the bound.
//
// Design.  The TPU grid (B, maxp) keeps an (H, r) fp32 accumulator for all
// heads in VMEM; at DeepSeek-V3 width that is 256 KB, more than a block's
// 227 KB of shared memory, and one fp32 page of 128 latents is 288 KB.  So
// one CTA owns one (slot, group of kMlaHeads query heads) and walks the
// slot's whole page-table row, stopping at the page that holds seq_pos
// (exact for the same reason as the GQA decode), and streams each page in tiles
// of kMlaKeys keys.  A tile of latent + rope rows is loaded once into shared
// memory (fp32, odd row stride) and serves the group's heads: in the score
// phase lane t scores key t and warp w sums the dimensions d = w (mod 8), for
// all heads of the group at once, then the partial sums meet in shared
// memory; warp g then holds head g's scores of the tile, one per lane, and
// updates that head's running max and denominator with warp shuffles; in the
// output phase each thread owns latent columns c = tid + 256 j of every head
// of the group in registers, so the accumulator never touches shared memory.
// Heads past H (a partial last group) compute on zeros and are not written.
// No tensor cores, no split over the keys: simple first.
//
// paged_copy: copy page src -> dst in every layer of one stacked pool
// (L, num_pages, page, ...) in place, whatever its element type: 16-byte
// words where the page and layer sizes allow, else 4-byte words, else
// bytes.  Bit-exact; src == dst leaves the pool unchanged (each thread reads
// and writes its own word).  Bound by bytes: 2 * L * page_bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>

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
constexpr int kMlaHeads = 8;     // query heads per CTA
constexpr int kMlaKeys = 32;     // keys per tile: one per lane in the score phase
constexpr int kMlaMaxCols = 4;   // latent columns per thread: r <= 4 * kMlaThreads
static_assert(kMlaWarps == kMlaHeads, "warp g updates head g's softmax state");

// The accumulation type: fp64 for fp32 pools, fp32 for bf16 pools.  At
// DeepSeek-V3 width an fp32 sum over 1901 keys (and a 576-term score) in
// another order than the plain version's drifts by tens of half-ulps, past
// the 1e-6 the fp32 comparison allows; a wider sum rounds once, where the
// plain version rounds too.
template <typename T>
struct MlaAcc;
template <>
struct MlaAcc<float> {
  using type = double;
};
template <>
struct MlaAcc<__nv_bfloat16> {
  using type = float;
};

struct MlaArgs {
  const void* q_lat;
  const void* q_rope;
  const void* ckv;
  const void* krope;
  const int* table;
  const int* seq_pos;
  void* out;
  int H, r, dr, page, maxp;
  float scale;
};

// An odd row stride: lanes reading the same column of 32 consecutive rows
// hit 32 different banks.
__host__ __device__ inline int mla_row_stride(int D) { return D | 1; }

// Shared memory: in the accumulation type, the group's queries (kMlaHeads x
// D, latent then rope), the score phase's partial sums (warps x heads x
// keys) and each head's final denominator; in fp32, a tile of latent + rope
// rows (kMlaKeys x stride), the tile's probabilities (keys x heads, 16-byte
// aligned) and each head's rescale factor.
__host__ __device__ inline long long mla_smem_bytes(int D, int acc_bytes) {
  return static_cast<long long>(acc_bytes) *
             (static_cast<long long>(kMlaHeads) * D + kMlaWarps * kMlaHeads * kMlaKeys +
              kMlaHeads) +
         4LL * (static_cast<long long>(kMlaKeys) * mla_row_stride(D) + kMlaKeys * kMlaHeads +
                kMlaHeads);
}

template <typename T>
__global__ void __launch_bounds__(kMlaThreads) mla_decode_kernel(MlaArgs p) {
  using A = typename MlaAcc<T>::type;
  extern __shared__ __align__(16) unsigned char mla_smem[];
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kMlaHeads;
  const int r = p.r;
  const int dr = p.dr;
  const int D = r + dr;
  const int ks = mla_row_stride(D);
  A* q_s = reinterpret_cast<A*>(mla_smem);
  A* part_s = q_s + kMlaHeads * D;
  A* l_s = part_s + kMlaWarps * kMlaHeads * kMlaKeys;
  float* kv_s = reinterpret_cast<float*>(l_s + kMlaHeads);
  float* p_s = kv_s + kMlaKeys * ks;  // 16-byte aligned: every region above is
  float* a_s = p_s + kMlaKeys * kMlaHeads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* ql = static_cast<const T*>(p.q_lat) + static_cast<long long>(b) * p.H * r;
  const T* qr = static_cast<const T*>(p.q_rope) + static_cast<long long>(b) * p.H * dr;
  for (int e = tid; e < kMlaHeads * D; e += kMlaThreads) {
    const int g = e / D;
    const int d = e - g * D;
    const int h = h0 + g;
    float v = 0.0f;
    if (h < p.H)
      v = d < r ? to_f32(ql[static_cast<long long>(h) * r + d])
                : to_f32(qr[static_cast<long long>(h) * dr + (d - r)]);
    q_s[e] = static_cast<A>(v);
  }

  A acc[kMlaMaxCols][kMlaHeads];
#pragma unroll
  for (int j = 0; j < kMlaMaxCols; ++j)
#pragma unroll
    for (int g = 0; g < kMlaHeads; ++g) acc[j][g] = 0;
  // head h0 + warp's running max and denominator, the same on every lane
  float m_run = kMask;
  A l_run = 0;

  const int* row = p.table + static_cast<long long>(b) * p.maxp;
  long long n_keys = static_cast<long long>(p.seq_pos[b]) + 1;
  const long long reach = static_cast<long long>(p.maxp) * p.page;
  if (n_keys > reach) n_keys = reach;
  const int n_pages = static_cast<int>((n_keys + p.page - 1) / p.page);

  for (int j = 0; j < n_pages; ++j) {
    const long long phys = row[j];
    const T* cpage = static_cast<const T*>(p.ckv) + phys * p.page * r;
    const T* rpage = static_cast<const T*>(p.krope) + phys * p.page * dr;
    for (int t0 = 0; t0 < p.page; t0 += kMlaKeys) {
      const long long key0 = static_cast<long long>(j) * p.page + t0;
      if (key0 >= n_keys) break;
      int n = p.page - t0;
      if (n > kMlaKeys) n = kMlaKeys;
      if (n_keys - key0 < n) n = static_cast<int>(n_keys - key0);

      __syncthreads();  // the previous tile's readers (and the q load) are done
      for (int t = warp; t < n; t += kMlaWarps) {
        const T* c = cpage + static_cast<long long>(t0 + t) * r;
        const T* kr = rpage + static_cast<long long>(t0 + t) * dr;
        float* dst = kv_s + t * ks;
        for (int d = lane; d < r; d += 32) dst[d] = to_f32(c[d]);
        for (int d = lane; d < dr; d += 32) dst[r + d] = to_f32(kr[d]);
      }
      __syncthreads();

      // partial scores: key `lane`, dimensions d = warp (mod kMlaWarps)
      A part[kMlaHeads];
#pragma unroll
      for (int g = 0; g < kMlaHeads; ++g) part[g] = 0;
      if (lane < n) {
        const float* kt = kv_s + lane * ks;
        for (int d = warp; d < D; d += kMlaWarps) {
          const A kv = static_cast<A>(kt[d]);
#pragma unroll
          for (int g = 0; g < kMlaHeads; ++g) part[g] = fma(q_s[g * D + d], kv, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMlaHeads; ++g)
        part_s[(warp * kMlaHeads + g) * kMlaKeys + lane] = part[g];
      __syncthreads();

      // head `warp`, key `lane`: the fp32 score, then the online-softmax update
      A sa = 0;
#pragma unroll
      for (int w = 0; w < kMlaWarps; ++w) sa += part_s[(w * kMlaHeads + warp) * kMlaKeys + lane];
      const float s = lane < n ? static_cast<float>(sa * static_cast<A>(p.scale)) : kMask;
      const float m_new = fmaxf(m_run, warp_max(s));
      const float alpha = expf(m_run - m_new);
      const float pt = expf(s - m_new);
      l_run = l_run * static_cast<A>(alpha) + warp_sum(static_cast<A>(pt));
      m_run = m_new;
      p_s[lane * kMlaHeads + warp] = pt;
      if (lane == 0) a_s[warp] = alpha;
      __syncthreads();

      // acc = acc * alpha + p @ c_kv, latent columns c = tid + kMlaThreads * jc
#pragma unroll
      for (int g = 0; g < kMlaHeads; ++g) {
        const A alpha_g = static_cast<A>(a_s[g]);
#pragma unroll
        for (int jc = 0; jc < kMlaMaxCols; ++jc) acc[jc][g] *= alpha_g;
      }
      for (int t = 0; t < n; ++t) {
        const float4 pa = *reinterpret_cast<const float4*>(p_s + t * kMlaHeads);
        const float4 pb = *reinterpret_cast<const float4*>(p_s + t * kMlaHeads + 4);
        const A pg[kMlaHeads] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float* kt = kv_s + t * ks;
#pragma unroll
        for (int jc = 0; jc < kMlaMaxCols; ++jc) {
          const int c = tid + jc * kMlaThreads;
          if (c < r) {
            const A v = static_cast<A>(kt[c]);
#pragma unroll
            for (int g = 0; g < kMlaHeads; ++g) acc[jc][g] = fma(pg[g], v, acc[jc][g]);
          }
        }
      }
    }
  }
  if (lane == 0) l_s[warp] = l_run;
  __syncthreads();

  T* out = static_cast<T*>(p.out) + static_cast<long long>(b) * p.H * r;
#pragma unroll
  for (int g = 0; g < kMlaHeads; ++g) {
    const int h = h0 + g;
    if (h >= p.H) break;
    A l = l_s[g];
    if (l == 0) l = 1;  // unreachable: key 0 is always valid
#pragma unroll
    for (int jc = 0; jc < kMlaMaxCols; ++jc) {
      const int c = tid + jc * kMlaThreads;
      if (c < r)
        out[static_cast<long long>(h) * r + c] = from_f32<T>(static_cast<float>(acc[jc][g] / l));
    }
  }
}

template <typename T>
int launch_mla_decode(const void* q_lat, const void* q_rope, const void* ckv,
                      const void* krope, const int* table, const int* seq_pos, void* out,
                      int B, int H, int r, int dr, int page, int maxp, float scale,
                      void* stream) {
  if (B < 1 || H < 1 || r < 1 || r > kMlaMaxCols * kMlaThreads || dr < 0 || page < 1 ||
      maxp < 1)
    return cudaErrorInvalidValue;
  const int groups = (H + kMlaHeads - 1) / kMlaHeads;
  if (groups > 65535) return cudaErrorInvalidValue;
  const long long smem = mla_smem_bytes(r + dr, sizeof(typename MlaAcc<T>::type));
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const MlaArgs p{q_lat, q_rope, ckv, krope, table, seq_pos, out, H, r, dr, page, maxp,
                  scale};
  const dim3 grid(B, groups);
  mla_decode_kernel<T><<<grid, kMlaThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(p);
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
                                              void* out, int B, int H, int r, int dr,
                                              int page, int maxp, float scale,
                                              void* stream) {
  return launch_mla_decode<float>(q_lat, q_rope, ckv, krope, table, seq_pos, out, B, H, r,
                                  dr, page, maxp, scale, stream);
}

extern "C" int mla_paged_attention_decode_bf16(const void* q_lat, const void* q_rope,
                                               const void* ckv, const void* krope,
                                               const int* table, const int* seq_pos,
                                               void* out, int B, int H, int r, int dr,
                                               int page, int maxp, float scale,
                                               void* stream) {
  return launch_mla_decode<__nv_bfloat16>(q_lat, q_rope, ckv, krope, table, seq_pos, out,
                                          B, H, r, dr, page, maxp, scale, stream);
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

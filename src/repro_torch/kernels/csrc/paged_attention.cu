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
// element loaded -- so it is bound by the bytes of the slot's K/V history
// (3.35 TB/s HBM3 on an H100 SXM), not by operations.
//
// Design.  The TPU grid (B, maxp) walks a slot's pages in order and carries
// the online-softmax state in VMEM scratch from one grid step to the next.
// Hopper runs blocks in no order, so one CTA owns one (slot, kv head) and
// walks the slot's page-table row in a loop, reading table[b, j] itself
// (there is no scalar prefetch), with the running max, denominator and
// weighted-value accumulator of its G query heads in shared memory.  Each
// page is consumed in tiles of kTileKeys keys: a K/V tile is loaded once,
// converted to fp32, and serves all G query heads of the group (at G = 9
// the tile is read once instead of nine times).  The walk stops at the
// page holding seq_pos[b]; keys past seq_pos are never read.  That is exact
// against the TPU kernel, which masks them with finfo(float32).min: a
// masked key adds exp(min - m) = 0 to every sum, and key 0 is always valid,
// so the running max is a real score from the first tile on.  K rows are
// padded by one float in shared memory so that threads scoring different
// keys read different banks.  No tensor cores, one CTA per (slot, kv head),
// no split over the keys: simple first.
//
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
// slot's page-table row as the GQA kernel does, stopping at the page that
// holds seq_pos (exact for the same reason), and streams each page in tiles
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

constexpr int kThreads = 128;
constexpr int kTileKeys = 32;
constexpr float kMask = -FLT_MAX;  // finfo(float32).min, the TPU kernel's fill

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

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* seq_pos;
  void* out;
  int H, hkv, dh, page, maxp;
  float scale;
};

// Shared memory, in floats: q and the accumulator (G x dh each), a K tile
// (kTileKeys x (dh + 1)), a V tile (kTileKeys x dh), the tile's scores /
// probabilities (G x kTileKeys), and the running max, denominator and
// rescale factor (G each).
__host__ __device__ inline long long decode_smem_floats(int G, int dh) {
  return 2LL * G * dh + static_cast<long long>(kTileKeys) * (dh + 1) +
         static_cast<long long>(kTileKeys) * dh + static_cast<long long>(G) * kTileKeys +
         3LL * G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(DecodeArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = p.H / p.hkv;
  const int dh = p.dh;
  const int ks = dh + 1;
  float* q_s = smem;
  float* acc_s = q_s + G * dh;
  float* k_s = acc_s + G * dh;
  float* v_s = k_s + kTileKeys * ks;
  float* s_s = v_s + kTileKeys * dh;
  float* m_s = s_s + G * kTileKeys;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  const int tid = threadIdx.x;

  // query heads kvh * G .. kvh * G + G - 1 of slot b: G * dh contiguous values
  const T* q = static_cast<const T*>(p.q) +
               (static_cast<long long>(b) * p.H + static_cast<long long>(kvh) * G) * dh;
  for (int e = tid; e < G * dh; e += kThreads) {
    q_s[e] = to_f32(q[e]);
    acc_s[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMask;
    l_s[g] = 0.0f;
  }

  const long long tok_stride = static_cast<long long>(p.hkv) * dh;
  const long long page_stride = static_cast<long long>(p.page) * tok_stride;
  const T* kbase = static_cast<const T*>(p.k) + static_cast<long long>(kvh) * dh;
  const T* vbase = static_cast<const T*>(p.v) + static_cast<long long>(kvh) * dh;
  const int* row = p.table + static_cast<long long>(b) * p.maxp;
  // keys 0 .. seq_pos[b] are valid (inclusive), within the table's reach
  long long n_keys = static_cast<long long>(p.seq_pos[b]) + 1;
  const long long reach = static_cast<long long>(p.maxp) * p.page;
  if (n_keys > reach) n_keys = reach;
  const int n_pages = static_cast<int>((n_keys + p.page - 1) / p.page);

  for (int j = 0; j < n_pages; ++j) {
    const long long phys = row[j];
    const T* kpage = kbase + phys * page_stride;
    const T* vpage = vbase + phys * page_stride;
    for (int t0 = 0; t0 < p.page; t0 += kTileKeys) {
      const long long key0 = static_cast<long long>(j) * p.page + t0;
      if (key0 >= n_keys) break;
      int n = p.page - t0;
      if (n > kTileKeys) n = kTileKeys;
      if (n_keys - key0 < n) n = static_cast<int>(n_keys - key0);

      __syncthreads();  // the previous tile (and the q/acc init) is done
      for (int e = tid; e < n * dh; e += kThreads) {
        const int t = e / dh;
        const int d = e - t * dh;
        const long long off = static_cast<long long>(t0 + t) * tok_stride + d;
        k_s[t * ks + d] = to_f32(kpage[off]);
        v_s[t * dh + d] = to_f32(vpage[off]);
      }
      __syncthreads();

      // scores of the group's G query heads against the tile's n keys
      for (int e = tid; e < G * n; e += kThreads) {
        const int g = e / n;
        const int t = e - g * n;
        const float* qg = q_s + g * dh;
        const float* kt = k_s + t * ks;
        float dot = 0.0f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qg[d], kt[d], dot);
        s_s[g * kTileKeys + t] = dot * p.scale;
      }
      __syncthreads();

      // online-softmax update, one thread per query head
      for (int g = tid; g < G; g += kThreads) {
        float* sg = s_s + g * kTileKeys;
        const float m_prev = m_s[g];
        float m_new = m_prev;
        for (int t = 0; t < n; ++t) m_new = fmaxf(m_new, sg[t]);
        const float alpha = expf(m_prev - m_new);
        float sum = 0.0f;
        for (int t = 0; t < n; ++t) {
          const float pt = expf(sg[t] - m_new);
          sg[t] = pt;
          sum += pt;
        }
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
      __syncthreads();

      // acc = acc * alpha + p @ V, one (head, column) per thread at a time
      for (int e = tid; e < G * dh; e += kThreads) {
        const int g = e / dh;
        const int d = e - g * dh;
        const float* pg = s_s + g * kTileKeys;
        float acc = acc_s[e] * a_s[g];
        for (int t = 0; t < n; ++t) acc = fmaf(pg[t], v_s[t * dh + d], acc);
        acc_s[e] = acc;
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out) +
           (static_cast<long long>(b) * p.H + static_cast<long long>(kvh) * G) * dh;
  for (int e = tid; e < G * dh; e += kThreads) {
    float l = l_s[e / dh];
    if (l == 0.0f) l = 1.0f;  // unreachable: key 0 is always valid
    out[e] = from_f32<T>(acc_s[e] / l);
  }
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, const int* table,
                  const int* seq_pos, void* out, int B, int H, int hkv, int dh,
                  int page, int maxp, float scale, void* stream) {
  if (B < 1 || hkv < 1 || H % hkv != 0 || dh < 1 || page < 1 || maxp < 1 ||
      hkv > 65535)
    return cudaErrorInvalidValue;
  const long long smem = decode_smem_floats(H / hkv, dh) * 4;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const DecodeArgs p{q, k, v, table, seq_pos, out, H, hkv, dh, page, maxp, scale};
  const dim3 grid(B, hkv);
  paged_decode_kernel<T><<<grid, kThreads, static_cast<size_t>(smem),
                           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
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
                                          int B, int H, int hkv, int dh, int page,
                                          int maxp, float scale, void* stream) {
  return launch_decode<float>(q, k, v, table, seq_pos, out, B, H, hkv, dh, page, maxp,
                              scale, stream);
}

extern "C" int paged_attention_decode_bf16(const void* q, const void* k, const void* v,
                                           const int* table, const int* seq_pos,
                                           void* out, int B, int H, int hkv, int dh,
                                           int page, int maxp, float scale,
                                           void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, table, seq_pos, out, B, H, hkv, dh, page,
                                      maxp, scale, stream);
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

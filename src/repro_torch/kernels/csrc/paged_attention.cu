// Paged one-token GQA decode, and the copy-on-write page copy, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels
// repro/kernels/paged_attention.py:_gqa_decode_kernel (launched by
// paged_attention_decode) and repro/kernels/paged_attention.py:_copy_kernel
// (launched by paged_copy).
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

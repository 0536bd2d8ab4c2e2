// Fused blocked (BWMA) attention, softmax(q k^T * scale) v, in fp32 for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/bwma_attention.py:
// _attention_kernel (launched by _attention_4d from bwma_attention).
//
// q, k, v and out are (..., gs, gd, bm, bd) blocked matrices of logical
// shape (S, d_head); the leading (batch, head) dims fold into gridDim.y with
// per-operand strides.  Keys at or past s_logical get probability exactly 0;
// padded d_head columns of q, k and v are 0, so they stay 0 in out; padded
// query rows are finite garbage, cropped when the result is unblocked.
//
// Why it cannot copy the TPU design: the Pallas kernel holds all of K and V
// on chip for one query block-row.  At BERT-base in fp32 that is 256 KB at
// block 16 and 512 KB at block 128 (d_head 64 pads to 128), more than the
// 227 KB of shared memory a CTA may use.
//
// What bounds it on this card: operations.  Per (sequence, head) it does
// 4 * S^2 * D multiply-adds against 4 * S * D floats moved, so FFMA at
// 67 TFLOP/s is the limit once K/V come from L2.
//
// Design: one CTA per (lead, query block-row i, group of RQ query rows).  It
// streams K and V one key block at a time -- each is one contiguous run of
// bm * D floats in the blocked layout -- through shared memory, and keeps
// an online softmax: a running max m and sum l per query row, rescaling the
// running output by exp(m_old - m_new) whenever the max grows.  Masked keys
// are filled with -FLT_MAX (finfo(float32).min) before the max and their
// weight is set to exactly 0.  The result is finalised as o / max(l, 1e-30),
// as the reference does.  The query block-row is split into groups of RQ
// rows across CTAs so that the Q tile, one K block (stored transposed, so
// score reads do not conflict), one V block and the score tile fit; above
// 48 KB the kernel opts in to more dynamic shared memory.  Each thread keeps
// up to MAXO output elements in registers.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct AttnArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int lead1;
  long long q_s0, q_s1, k_s0, k_s1, v_s0, v_s1;
  int gs, gd, bm, bd, rq, s_logical;
  float scale;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int MAXO>
__global__ void __launch_bounds__(kThreads) bwma_attention_kernel(AttnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int bm = p.bm;
  const int bd = p.bd;
  const int rq = p.rq;
  const int D = p.gd * bd;  // padded head width
  float* Vs = smem;                 // bm * D: one V block-row, as stored (gd, bm, bd)
  float* Kt = Vs + bm * D;          // D x (bm + 1): one K block-row, transposed
  float* Qs = Kt + D * (bm + 1);    // rq x D: this CTA's query rows
  float* Ss = Qs + rq * D;          // rq x bm: scores, then probabilities
  float* m_s = Ss + rq * bm;        // running max per query row
  float* l_s = m_s + rq;            // running sum per query row
  float* a_s = l_s + rq;            // this step's rescale factor per row

  const int groups = bm / rq;
  const int i = blockIdx.x / groups;
  const int r0 = (blockIdx.x - i * groups) * rq;
  const int z = blockIdx.y;
  const int l0 = z / p.lead1;
  const int l1 = z - l0 * p.lead1;
  const long long rowblk = static_cast<long long>(bm) * D;  // one block-row
  const float* q = p.q + l0 * p.q_s0 + l1 * p.q_s1 + i * rowblk;
  const float* kbase = p.k + l0 * p.k_s0 + l1 * p.k_s1;
  const float* vbase = p.v + l0 * p.v_s0 + l1 * p.v_s1;
  float* o = p.out + (static_cast<long long>(z) * p.gs + i) * rowblk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nout = rq * D;

  for (int idx = tid; idx < nout; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int db = d / bd;
    Qs[idx] = q[(static_cast<long long>(db) * bm + r0 + r) * bd + (d - db * bd)];
  }
  for (int r = tid; r < rq; r += kThreads) {
    m_s[r] = -FLT_MAX;
    l_s[r] = 0.0f;
  }

  float acc[MAXO];
#pragma unroll
  for (int u = 0; u < MAXO; ++u) acc[u] = 0.0f;

  for (int j = 0; j < p.gs; ++j) {
    __syncthreads();  // the previous key block has been consumed
    const float4* kblk = reinterpret_cast<const float4*>(kbase + j * rowblk);
    const float4* vblk = reinterpret_cast<const float4*>(vbase + j * rowblk);
    for (int t = tid; t < bm * D / 4; t += kThreads) {
      reinterpret_cast<float4*>(Vs)[t] = vblk[t];
      const float4 kv = kblk[t];
      // element 4t of the block-row: column block db, key c, columns dd..dd+3
      const int e = 4 * t;
      const int db = e / (bm * bd);
      const int rem = e - db * bm * bd;
      const int c = rem / bd;
      const int d = db * bd + (rem - c * bd);
      Kt[(d + 0) * (bm + 1) + c] = kv.x;
      Kt[(d + 1) * (bm + 1) + c] = kv.y;
      Kt[(d + 2) * (bm + 1) + c] = kv.z;
      Kt[(d + 3) * (bm + 1) + c] = kv.w;
    }
    __syncthreads();

    // scores of this CTA's query rows against the key block, masked
    for (int idx = tid; idx < rq * bm; idx += kThreads) {
      const int r = idx / bm;
      const int c = idx - r * bm;
      float s = -FLT_MAX;
      if (j * bm + c < p.s_logical) {
        const float* qr = Qs + r * D;
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Kt[d * (bm + 1) + c], dot);
        s = dot * p.scale;
      }
      Ss[idx] = s;
    }
    __syncthreads();

    // online softmax statistics: one warp per query row
    for (int r = warp; r < rq; r += kThreads / 32) {
      float* sr = Ss + r * bm;
      float mx = -FLT_MAX;
      for (int c = lane; c < bm; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < bm; c += 32) {
        const float e = (j * bm + c < p.s_logical) ? expf(sr[c] - m_new) : 0.0f;
        sr[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + P @ V_j
#pragma unroll
    for (int u = 0; u < MAXO; ++u) {
      const int idx = tid + u * kThreads;
      if (idx < nout) {
        const int r = idx / D;
        const int d = idx - r * D;
        const int db = d / bd;
        const float* pr = Ss + r * bm;
        const float* vc = Vs + db * bm * bd + (d - db * bd);
        float t = acc[u] * a_s[r];
        for (int c = 0; c < bm; ++c) t = fmaf(pr[c], vc[c * bd], t);
        acc[u] = t;
      }
    }
  }

#pragma unroll
  for (int u = 0; u < MAXO; ++u) {
    const int idx = tid + u * kThreads;
    if (idx < nout) {
      const int r = idx / D;
      const int d = idx - r * D;
      const int db = d / bd;
      o[(static_cast<long long>(db) * bm + r0 + r) * bd + (d - db * bd)] =
          acc[u] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <int MAXO>
cudaError_t launch(const AttnArgs& p, int lead, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwma_attention_kernel<MAXO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.gs * (p.bm / p.rq), lead);
  bwma_attention_kernel<MAXO><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one CTA needs, in bytes; the Python wrapper checks it
// against the card's limit before launching.
extern "C" long long bwma_attention_smem_bytes(int gd, int bm, int bd, int rq) {
  const long long D = static_cast<long long>(gd) * bd;
  return 4 * (bm * D + D * (bm + 1) + rq * D + static_cast<long long>(rq) * bm + 3LL * rq);
}

extern "C" int bwma_attention_f32(const float* q, const float* k, const float* v,
                                  float* out, int lead0, int lead1,
                                  long long q_s0, long long q_s1, long long k_s0,
                                  long long k_s1, long long v_s0, long long v_s1,
                                  int gs, int gd, int bm, int bd, int rq,
                                  int s_logical, float scale, void* stream) {
  if (lead0 * lead1 > 65535 || rq < 1 || bm % rq != 0 || bd % 4 != 0 ||
      s_logical < 1 || s_logical > gs * bm)
    return cudaErrorInvalidValue;
  const AttnArgs p{q, k, v, out, lead1, q_s0, q_s1, k_s0, k_s1, v_s0, v_s1,
                   gs, gd, bm, bd, rq, s_logical, scale};
  const size_t smem = static_cast<size_t>(bwma_attention_smem_bytes(gd, bm, bd, rq));
  const int per_thread = (rq * gd * bd + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (per_thread <= 1) return launch<1>(p, lead0 * lead1, smem, st);
  if (per_thread <= 2) return launch<2>(p, lead0 * lead1, smem, st);
  if (per_thread <= 4) return launch<4>(p, lead0 * lead1, smem, st);
  if (per_thread <= 8) return launch<8>(p, lead0 * lead1, smem, st);
  if (per_thread <= 16) return launch<16>(p, lead0 * lead1, smem, st);
  return cudaErrorInvalidValue;
}

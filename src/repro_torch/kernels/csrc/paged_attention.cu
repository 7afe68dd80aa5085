// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _pa_kernel): one-token GQA attention through a
// page table, out[b, h] = softmax(q[b, h] . K[b]^T * scale) V[b] over the
// first lengths[b] tokens of the row's pages.
//
// What bounds it on the card: bytes.  Each live K/V page is read once and
// used for G = H / KV dot products per token, about G flops per byte, far
// below the ~295 flop/byte at which an H100 stops being memory-bound.  The
// least time is the live K/V bytes over 3.35 TB/s.
//
// Design: one block per (b, kv_head), like the TPU grid (B, KV).  The
// block reads its own page-table row and length (no scalar prefetch) and
// walks its live pages; each page's K and V tiles [T, hd] are staged in
// shared memory as f32 (K rows padded by one word, so the score loop that
// gives each thread a token is free of bank conflicts).  The G query heads'
// running max, sum and accumulator stay in f32 shared memory: an online
// softmax, as in the TPU kernel.  Page, token and head strides come from
// the caller, so a per-layer view pool[:, l, 0] of the serving pool
// [P, L, 2, T, KV, hd] is read in place.  Unmapped (-1) pages are skipped:
// their probability mass is exactly zero, and nothing is read from them.
// Rows of length 0 return zeros.  Known limit: B * KV blocks (16 at decode
// batch 8 with 2 KV heads) leave most of the 132 SMs idle; splitting each
// row's pages over several blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const scalar_t* __restrict__ q, const scalar_t* __restrict__ k_pages,
    const scalar_t* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, scalar_t* __restrict__ out, int H,
    int KV, int hd, int T, int MP, int64_t k_sp, int64_t k_st, int64_t k_sh,
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* k_s = smem;                 // [T, hd + 1]
  float* v_s = k_s + T * kstride;    // [T, hd]
  float* q_s = v_s + T * hd;         // [G, hd]
  float* acc = q_s + G * hd;         // [G, hd]
  float* s_s = acc + G * hd;         // [G, T] scores, then probabilities
  float* m_s = s_s + G * T;          // [G] running max
  float* l_s = m_s + G;              // [G] running sum
  float* a_s = l_s + G;              // [G] this page's rescale factor

  const int length = lengths[b];
  int n_pages = length > 0 ? (length + T - 1) / T : 0;
  if (n_pages > MP) n_pages = MP;

  const scalar_t* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    q_s[i] = to_f32(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int ip = 0; ip < n_pages; ++ip) {
    const int page = page_table[(int64_t)b * MP + ip];
    if (page < 0) continue;  // the same for every thread of the block
    const scalar_t* kp = k_pages + page * k_sp + kvh * k_sh;
    const scalar_t* vp = v_pages + page * v_sp + kvh * v_sh;
    for (int i = tid; i < T * hd; i += blockDim.x) {
      const int t = i / hd;
      const int d = i - t * hd;
      k_s[t * kstride + d] = to_f32(kp[t * k_st + d]);
      v_s[i] = to_f32(vp[t * v_st + d]);
    }
    __syncthreads();

    const int base = ip * T;
    for (int i = tid; i < G * T; i += blockDim.x) {
      const int g = i / T;
      const int t = i - g * T;
      float s = kNegInf;
      if (base + t < length) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + t * kstride;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float* sg = s_s + g * T;
      float mx = kNegInf;
      for (int t = lane; t < T; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < T; t += 32) {
        // masked lanes contribute exactly zero, even on a page that is
        // masked whole (where m_new is still kNegInf)
        const float p = (base + t < length) ? expf(sg[t] - m_new) : 0.f;
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += blockDim.x) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pg = s_s + g * T;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < T; ++t) a = fmaf(pg[t], v_s[t * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  scalar_t* ob = out + ((int64_t)b * H + (int64_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const float l = fmaxf(l_s[i / hd], 1e-20f);  // length-0 rows -> 0
    ob[i] = from_f32<scalar_t>(acc[i] / l);
  }
}

template <typename scalar_t>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths, void* out,
                   int B, int H, int KV, int hd, int T, int MP, int64_t k_sp,
                   int64_t k_st, int64_t k_sh, int64_t v_sp, int64_t v_st,
                   int64_t v_sh, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) *
      ((size_t)T * (hd + 1) + (size_t)T * hd + 2 * (size_t)G * hd +
       (size_t)G * T + 3 * (size_t)G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<scalar_t>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, KV);
  paged_attention_kernel<scalar_t><<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k_pages),
      static_cast<const scalar_t*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<scalar_t*>(out), H, KV, hd, T, MP, k_sp, k_st, k_sh, v_sp,
      v_st, v_sh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns a
// cudaError_t (0 on success).
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int KV, int hd, int T, int MP, int64_t k_sp, int64_t k_st, int64_t k_sh,
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, page_table, lengths, out, B, H,
                         KV, hd, T, MP, k_sp, k_st, k_sh, v_sp, v_st, v_sh,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths,
                                 out, B, H, KV, hd, T, MP, k_sp, k_st, k_sh,
                                 v_sp, v_st, v_sh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _fa_kernel): blocked online-softmax attention on
// q [B, S, H, hd] and k, v [B, S, KV, hd], causal with an optional sliding
// window, GQA head h reading kv head h / G, ragged tails masked by S.
//
// What bounds it on the card: causal attention does about 2 * S^2 * hd * H
// flops on 2 * S * hd * (H + KV) bf16 elements, about S * H / (2 (H + KV))
// flops per byte.  With qwen2's H = 12, KV = 2 that passes the H100's ~295
// flop/byte ridge near S = 700: longer prompts are bound by operations
// (the causal flops over the 989 TFLOP/s bf16 tensor-core peak), the
// prompts of this slice (S <= 256) by bytes.  In practice this simple
// kernel is far from both: it is latency-bound.
//
// Design: one block per (b, h, q-tile of 32 rows).  The loop over K tiles
// of 32 stops at the causal edge and starts at the window's edge, which
// stands in for the TPU kernel's pl.when skip of fully masked blocks.  Each
// K/V tile is staged in shared memory as f32 (K rows padded by one word);
// a warp owns a query row for the score and softmax steps, so the row's
// max and sum are warp shuffles, and the f32 accumulator [32, hd] stays in
// shared memory.  Plain FMA on CUDA cores, no tensor cores yet: simple and
// right first, wgmma later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 32;  // query rows per block
constexpr int kBK = 32;  // key rows per tile (== warp size, see row step)

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

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  return kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

template <typename scalar_t>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
    const scalar_t* __restrict__ v, scalar_t* __restrict__ out, int S, int H,
    int KV, int hd, int causal, int window, float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [BQ, hd]
  float* k_s = q_s + kBQ * hd;       // [BK, hd + 1]
  float* v_s = k_s + kBK * kstride;  // [BK, hd]
  float* acc = v_s + kBK * hd;       // [BQ, hd]
  float* p_s = acc + kBQ * hd;       // [BQ, BK] scores, then probabilities
  float* m_s = p_s + kBQ * kBK;      // [BQ] running max
  float* l_s = m_s + kBQ;            // [BQ] running sum
  float* a_s = l_s + kBQ;            // [BQ] this tile's rescale factor

  const int64_t q_row = (int64_t)H * hd;   // stride of one token in q/out
  const int64_t kv_row = (int64_t)KV * hd; // stride of one token in k/v
  const scalar_t* qb = q + (int64_t)b * S * q_row + (int64_t)h * hd;
  const scalar_t* kb = k + (int64_t)b * S * kv_row + (int64_t)kvh * hd;
  const scalar_t* vb = v + (int64_t)b * S * kv_row + (int64_t)kvh * hd;

  for (int i = tid; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int qpos = q0 + r;
    q_s[i] = qpos < S ? to_f32(qb[qpos * q_row + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // K tiles that hold any visible key for this q tile
  int kt_end = (S + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kBQ, S) - 1;
    kt_end = min(kt_end, last_q / kBK + 1);
  }
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int kpos = k0 + j;
      const bool in = kpos < S;
      k_s[j * kstride + d] = in ? to_f32(kb[kpos * kv_row + d]) : 0.f;
      v_s[i] = in ? to_f32(vb[kpos * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores: thread -> (row r, key j) with j fastest, so a warp owns a row
    for (int i = tid; i < kBQ * kBK; i += blockDim.x) {
      const int r = i / kBK;
      const int j = i - r * kBK;
      float s = kNegInf;
      if (visible(q0 + r, k0 + j, S, causal, window)) {
        const float* qr = q_s + r * hd;
        const float* kr = k_s + j * kstride;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key
    for (int r = warp; r < kBQ; r += nwarps) {
      const float s = p_s[r * kBK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p =
          visible(q0 + r, k0 + lane, S, causal, window) ? expf(s - m_new)
                                                        : 0.f;
      p_s[r * kBK + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBQ * hd; i += blockDim.x) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* pr = p_s + r * kBK;
      float a = acc[i] * a_s[r];
      for (int j = 0; j < kBK; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  scalar_t* ob = out + (int64_t)b * S * q_row + (int64_t)h * hd;
  for (int i = tid; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int qpos = q0 + r;
    if (qpos < S)
      ob[qpos * q_row + d] = from_f32<scalar_t>(acc[i] / fmaxf(l_s[r], 1e-20f));
  }
}

template <typename scalar_t>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int hd, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kBQ * hd + (size_t)kBK * (hd + 1) +
                       (size_t)kBK * hd + (size_t)kBQ * hd +
                       (size_t)kBQ * kBK + 3 * (size_t)kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<scalar_t>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<scalar_t><<<grid, kThreads, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<scalar_t*>(out), S, H, KV,
      hd, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q/out [B, S, H, hd] and k/v
// [B, S, KV, hd], all contiguous.  window <= 0 means no window.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, S, H, KV, hd, causal, window, scale,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, hd, causal,
                                 window, scale, s);
  return (int)cudaErrorInvalidValue;
}

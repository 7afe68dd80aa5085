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
// prompts of the serving path (S <= 256) by bytes.  At S <= 256 a launch
// moves under 2 MB and does under 0.2 GFLOP, so what is left is latency:
// the few serial tiles of the longest q tile.
//
// Two kernels, chosen by dtype (an explicit route, not a fallback: neither
// catches a failure of the other):
//
// * bf16: FA2-style on tensor cores.  One block of 4 warps per (q tile
//   of 32 rows, head, batch): 96 blocks at B 1, S 256, H 12, where 64-row
//   tiles would give 48 on 132 SMs.  q tiles launch longest first (the
//   causal tail is the longest).  The warps form two pairs; each pair
//   covers the tile's 32 rows (16 per warp) over every other K tile, so
//   the longest tile's serial walk halves and all four of an SM's
//   schedulers have a warp; the pairs merge their (m, l, O) once at the
//   end, through shared memory.  A warp's Q stays in registers as mma A
//   fragments for the whole K loop (hd <= 128; at hd 256 it is re-read
//   from shared memory, to leave registers for the 128-float O
//   accumulator).  K and V tiles (64 keys, 32 at hd 256) stay bf16 in
//   shared memory, loaded by 16-byte cp.async into each pair's ring of two
//   stages, so a pair's next tile loads while it computes this one; rows
//   are padded by 16 bytes so every ldmatrix is free of bank conflicts.
//   S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//   accumulators in registers (ldmatrix for K, ldmatrix.trans for V).  The
//   online softmax runs in registers: a row's max and sum are shuffles
//   within the four lanes that hold it.  P is rounded to bf16 in registers
//   and becomes the A operand of P V directly, and the row sum adds the
//   rounded values, so the weights still sum to one; against the plain
//   version's f32 P this is within the bf16 tolerance of 2e-2 for
//   unit-variance inputs.
//   head_dim is a template parameter, instantiated at 16, 64, 128 and 256;
//   any other multiple of 8 runs in the next one up (h2o-danube's 120 in
//   128), zero-padded inside the kernel: a row of hd values is hd / 8
//   whole 16-byte chunks, the Q, K and V loaders copy those and zero-fill
//   the rest of the tile's row (cp.async with a source size of 0, so no
//   chunk index reaches into the next row), which is exact for Q K^T and
//   P V, and the store skips the padded columns.  The scale is the
//   caller's 1 / sqrt(hd), not the tile's width.  K/V
//   rows past S are zero-filled by the copies, so masked lanes never
//   multiply garbage; the causal and window masks are applied only on
//   tiles that straddle an edge, and the loop over K tiles starts at the
//   window's edge and stops at the causal edge (the TPU kernel's pl.when
//   skip of fully masked blocks).
// * f32: the CUDA-core kernel of the first port (FMA from f32 tiles in
//   shared memory).  Tensor cores would mean TF32, which keeps about three
//   decimal digits and would break the f32 card-against-CPU check at 1e-4.
//
// Not yet wgmma and TMA: those pay where the kernel is bound by
// operations, past S ~ 700; at the serving path's S <= 256 mma.sync with
// cp.async reaches the latency floor of a few serial tiles.

#include <math.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int window) {
  return kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// ------------------------------------------------------------- f32 kernel
constexpr int kF32Threads = 128;
constexpr int kF32BQ = 32;  // query rows per block
constexpr int kF32BK = 32;  // key rows per tile (== warp size, see row step)
constexpr int kF32MaxHd = 256;

constexpr size_t f32_smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)kF32BQ * hd + (size_t)kF32BK * (hd + 1) +
          (size_t)kF32BK * hd + (size_t)kF32BQ * hd +
          (size_t)kF32BQ * kF32BK + 3 * (size_t)kF32BQ);
}

// One block per (b, h, q tile of 32 rows); each K/V tile of 32 is staged
// in shared memory (K rows padded by one word); a warp owns a query row
// for the score and softmax steps, and the f32 accumulator [32, hd] stays
// in shared memory.
__global__ void __launch_bounds__(kF32Threads) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int H,
    int KV, int hd, int causal, int window, float scale) {
  const int q0 = blockIdx.x * kF32BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int kstride = hd + 1;

  extern __shared__ float smem[];
  float* q_s = smem;                    // [BQ, hd]
  float* k_s = q_s + kF32BQ * hd;       // [BK, hd + 1]
  float* v_s = k_s + kF32BK * kstride;  // [BK, hd]
  float* acc = v_s + kF32BK * hd;       // [BQ, hd]
  float* p_s = acc + kF32BQ * hd;       // [BQ, BK] scores, then probabilities
  float* m_s = p_s + kF32BQ * kF32BK;   // [BQ] running max
  float* l_s = m_s + kF32BQ;            // [BQ] running sum
  float* a_s = l_s + kF32BQ;            // [BQ] this tile's rescale factor

  const int64_t q_row = (int64_t)H * hd;    // stride of one token in q/out
  const int64_t kv_row = (int64_t)KV * hd;  // stride of one token in k/v
  const float* qb = q + (int64_t)b * S * q_row + (int64_t)h * hd;
  const float* kb = k + (int64_t)b * S * kv_row + (int64_t)kvh * hd;
  const float* vb = v + (int64_t)b * S * kv_row + (int64_t)kvh * hd;

  for (int i = tid; i < kF32BQ * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int qpos = q0 + r;
    q_s[i] = qpos < S ? qb[qpos * q_row + d] : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kF32BQ; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // K tiles that hold any visible key for this q tile
  int kt_end = (S + kF32BK - 1) / kF32BK;
  if (causal) {
    const int last_q = min(q0 + kF32BQ, S) - 1;
    kt_end = min(kt_end, last_q / kF32BK + 1);
  }
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kF32BK;
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kF32BK;
    for (int i = tid; i < kF32BK * hd; i += blockDim.x) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int kpos = k0 + j;
      const bool in = kpos < S;
      k_s[j * kstride + d] = in ? kb[kpos * kv_row + d] : 0.f;
      v_s[i] = in ? vb[kpos * kv_row + d] : 0.f;
    }
    __syncthreads();

    // scores: thread -> (row r, key j) with j fastest, so a warp owns a row
    for (int i = tid; i < kF32BQ * kF32BK; i += blockDim.x) {
      const int r = i / kF32BK;
      const int j = i - r * kF32BK;
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
    for (int r = warp; r < kF32BQ; r += nwarps) {
      const float s = p_s[r * kF32BK + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p =
          visible(q0 + r, k0 + lane, S, causal, window) ? expf(s - m_new)
                                                        : 0.f;
      p_s[r * kF32BK + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < kF32BQ * hd; i += blockDim.x) {
      const int r = i / hd;
      const int d = i - r * hd;
      const float* pr = p_s + r * kF32BK;
      float a = acc[i] * a_s[r];
      for (int j = 0; j < kF32BK; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  float* ob = out + (int64_t)b * S * q_row + (int64_t)h * hd;
  for (int i = tid; i < kF32BQ * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int qpos = q0 + r;
    if (qpos < S) ob[qpos * q_row + d] = acc[i] / fmaxf(l_s[r], 1e-20f);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int H, int KV, int hd,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  // once: the cap for the largest head_dim the wrapper takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_smem_bytes(kF32MaxHd));
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + kF32BQ - 1) / kF32BQ, H, B);
  flash_attention_f32_kernel<<<grid, kF32Threads, f32_smem_bytes(hd),
                               stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV, hd,
      causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 kernel
using bf16 = __nv_bfloat16;

// A block is two warp pairs.  Each pair covers the block's 32 query rows
// (16 per warp) over every other K tile (pair 0 the even ones from the
// window's edge, pair 1 the odd ones), with its own ring of K/V tiles and
// its own barrier; the two meet once at the end.
constexpr int kPairs = 2;
constexpr int kPairThreads = 64;
constexpr int kThreads = kPairs * kPairThreads;
constexpr int kBQ = 32;  // query rows per block: 16 per warp of a pair

template <int HD>
struct TileCfg {
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr int kLd = HD + 8;  // row pitch (elements): +16 bytes
  static constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  static constexpr bool kQInRegs = HD <= 128;
  // Q, then per pair two stages of K and two of V
  static constexpr size_t kSmem =
      sizeof(bf16) * (kBQ + kPairs * 4 * kBK) * kLd;
  // what pair 1 hands to pair 0 per lane: O, then m and l of two rows
  static constexpr int kHandoff = HD / 8 * 4 + 4;
  static_assert(2 * kHandoff * 32 * sizeof(float) <=
                    kPairs * 4 * kBK * kLd * sizeof(bf16),
                "the hand-off must fit in the K/V rings");
};

// a barrier for the 64 threads of one warp pair (ids 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(pair + 1), "r"(kPairThreads));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half); the rounded
// values are returned through lo and hi
__device__ __forceinline__ uint32_t pack_bf16(float& lo, float& hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  lo = __low2float(p);
  hi = __high2float(p);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Fragment layout of mma m16n8k16 (lane = 4 g + t): an accumulator
// c[0..1] holds row g, columns 2t and 2t + 1 of its 16 x 8 tile, c[2..3]
// row g + 8.  An A fragment a[0..3] holds (row g, k 2t..), (row g + 8,
// k 2t..), (row g, k 2t + 8..), (row g + 8, k 2t + 8..).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H, int KV,
    int hd, int causal, int window, float scale_log2) {
  using Cfg = TileCfg<HD>;
  constexpr int kBK = Cfg::kBK;
  constexpr int kLd = Cfg::kLd;
  constexpr int kChunks = Cfg::kChunks;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest q tile first
  const int q0 = qt * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pair = warp >> 1;
  const int ptid = tid & (kPairThreads - 1);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BQ][Ld]
  bf16* ring = q_s + kBQ * kLd;  // per pair: K [2][BK][Ld], V [2][BK][Ld]
  bf16* k_s = ring + pair * 4 * kBK * kLd;
  bf16* v_s = k_s + 2 * kBK * kLd;

  const int64_t q_row = (int64_t)H * hd;
  const int64_t kv_row = (int64_t)KV * hd;
  const bf16* qb = q + (int64_t)b * S * q_row + (int64_t)h * hd;
  const bf16* kb = k + (int64_t)b * S * kv_row + (int64_t)kvh * hd;
  const bf16* vb = v + (int64_t)b * S * kv_row + (int64_t)kvh * hd;

  // Q tile, by the whole block; rows past S and columns past hd are zero
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int d = (i % kChunks) * 8;
    const int qpos = q0 + r;
    const bool in = qpos < S && d < hd;
    cp_async16(smem_addr(q_s + r * kLd + d), in ? qb + qpos * q_row + d : qb,
               in);
  }
  cp_async_commit();

  auto load_kv = [&](int kt, int stage) {  // by this pair's 64 threads
    const int k0 = kt * kBK;
    bf16* ks = k_s + stage * kBK * kLd;
    bf16* vs = v_s + stage * kBK * kLd;
    for (int i = ptid; i < kBK * kChunks; i += kPairThreads) {
      const int j = i / kChunks;
      const int d = (i % kChunks) * 8;
      const int kpos = k0 + j;
      const bool in = kpos < S && d < hd;
      const int64_t off = in ? kpos * kv_row + d : 0;
      cp_async16(smem_addr(ks + j * kLd + d), kb + off, in);
      cp_async16(smem_addr(vs + j * kLd + d), vb + off, in);
    }
  };

  // K tiles that hold any visible key for this q tile; this pair takes
  // every other one
  int kt_end = (S + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (min(q0 + kBQ, S) - 1) / kBK + 1);
  const int kt_first =
      (window > 0 ? max(0, q0 - window + 1) / kBK : 0) + pair;

  if (kt_first < kt_end) load_kv(kt_first, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const int row0 = (warp & 1) * 16;
  uint32_t qf[Cfg::kQInRegs ? HD / 16 : 1][4];
  if constexpr (Cfg::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      ldmatrix_x4(qf[kk], smem_addr(q_s + (row0 + (lane & 15)) * kLd +
                                    kk * 16 + (lane >> 4) * 8));
  }

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  const int r_lo = q0 + row0 + (lane >> 2);
  const int r_hi = r_lo + 8;
  const int warp_first = q0 + row0;
  const int warp_last = warp_first + 15;

  for (int kt = kt_first, it = 0; kt < kt_end; kt += kPairs, ++it) {
    const int stage = it & 1;
    if (kt + kPairs < kt_end) {
      load_kv(kt + kPairs, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    pair_sync(pair);
    const bf16* ks = k_s + stage * kBK * kLd;
    const bf16* vs = v_s + stage * kBK * kLd;
    const int k0 = kt * kBK;

    // S = Q K^T: per 16-deep slice, one ldmatrix.x4 feeds two 8-key blocks
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Cfg::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, smem_addr(q_s + (row0 + (lane & 15)) * kLd + kk * 16 +
                                 (lane >> 4) * 8));
      }
#pragma unroll
      for (int nb = 0; nb < kBK / 16; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(ks + (nb * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * kLd +
                                  kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * nb], a, bk[0], bk[1]);
        mma_bf16(s[2 * nb + 1], a, bk[2], bk[3]);
      }
    }

    // scale into log2 units; mask only on tiles that cross an edge
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > warp_first) ||
                      (window > 0 && k0 <= warp_last - window);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!visible(e < 2 ? r_lo : r_hi, key, S, causal, window))
            s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax over the two rows this lane holds
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with nothing visible yet keeps exp2(-inf - 0) = 0 everywhere
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      const float alpha = exp2f(m[i] - base[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

    // P in bf16 registers, laid out as the A fragments of P V
    uint32_t pf[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p0 = exp2f(s[j][0] - base[0]);
      float p1 = exp2f(s[j][1] - base[0]);
      float p2 = exp2f(s[j][2] - base[1]);
      float p3 = exp2f(s[j][3] - base[1]);
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
    }

    // O += P V: per 16 keys, one ldmatrix.x4.trans feeds two 8-column blocks
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int db = 0; db < HD / 16; ++db) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(vs + (kk * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * kLd +
                                        db * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * db], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * db + 1], pf[kk], bv[2], bv[3]);
      }
    }
    pair_sync(pair);  // this stage is free for the load two tiles on
  }

  // pair 1 hands its O, m and l to pair 0 through the (now idle) rings,
  // lane-major so neither side has bank conflicts
  constexpr int kHandoff = Cfg::kHandoff;
  float* xs = reinterpret_cast<float*>(ring) + (warp & 1) * kHandoff * 32;
  __syncthreads();
  if (pair == 1) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(j * 4 + e) * 32 + lane] = o[j][e];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[(HD / 2 + i) * 32 + lane] = m[i];
      xs[(HD / 2 + 2 + i) * 32 + lane] = l[i];
    }
  }
  __syncthreads();
  if (pair == 1) return;

  float w0[2], w1[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xs[(HD / 2 + i) * 32 + lane];
    const float M = fmaxf(m[i], m1);
    w0[i] = m[i] == -INFINITY ? 0.f : exp2f(m[i] - M);
    w1[i] = m1 == -INFINITY ? 0.f : exp2f(m1 - M);
    float lt = l[i] * w0[i] + xs[(HD / 2 + 2 + i) * 32 + lane] * w1[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[i] = lt > 0.f ? 1.f / lt : 0.f;
  }
  bf16* ob = out + (int64_t)b * S * q_row + (int64_t)h * hd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e] = (o[j][e] * w0[e >> 1] + xs[(j * 4 + e) * 32 + lane] *
              w1[e >> 1]) * inv[e >> 1];
    const int d = j * 8 + 2 * (lane & 3);
    if (d >= hd) continue;  // zero-padded head_dim columns
    if (r_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_lo * q_row + d) =
          __floats2bfloat162_rn(r[0], r[1]);
    if (r_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_hi * q_row + d) =
          __floats2bfloat162_rn(r[2], r[3]);
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int KV, int hd,
                        int causal, int window, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = TileCfg<HD>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_bf16_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV, hd,
      causal, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel).  q/out [B, S, H, hd] and k/v [B, S, KV, hd], all contiguous,
// hd a multiple of 8 in 16..256.  window <= 0 means no window.  Returns
// a cudaError_t (0 on success).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd, int causal,
                                      int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 16 || hd > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, S, H, KV, hd, causal, window, scale,
                      s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (hd <= 16)
    return launch_bf16<16>(q, k, v, out, B, S, H, KV, hd, causal, window,
                           scale, s);
  if (hd <= 64)
    return launch_bf16<64>(q, k, v, out, B, S, H, KV, hd, causal, window,
                           scale, s);
  if (hd <= 128)
    return launch_bf16<128>(q, k, v, out, B, S, H, KV, hd, causal, window,
                            scale, s);
  return launch_bf16<256>(q, k, v, out, B, S, H, KV, hd, causal, window,
                          scale, s);
}

// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _pa_kernel): one-token GQA attention through a
// page table, out[b, h] = softmax(q[b, h] . K[b]^T * scale) V[b] over the
// first lengths[b] tokens of the row's pages.
//
// What bounds it on the card: bytes.  Each live K/V page is read once and
// used for G = H / KV dot products per token, about G flops per byte, far
// below the ~295 flop/byte at which an H100 stops being memory-bound, so
// tensor cores would not help.  The least time is the live K/V bytes over
// 3.35 TB/s: under a microsecond at the decode batch, less than a launch.
// What a kernel can do is spread those bytes over all 132 SMs and keep
// many loads in flight.
//
// Design: split and combine (split-K over the page table).
// * Split kernel, grid (B, KV * head chunks, n_splits).  The TPU grid is
//   (B, KV) with a sequential walk over pages; here each block takes a
//   contiguous range of the row's page-table columns, chosen on the host
//   by split_plan() in paged_attention.py from B, KV and MP alone (the
//   plan never reads lengths, which live on the card).  At the decode
//   batch (B 8, KV 2, MP 16) that is one page per block, 256 blocks.  A
//   block scores up to 8 query heads of one kv head.  Its 128 threads form
//   groups of `lpt` lanes, one token per group at a time: each lane reads
//   16 bytes of the token's K and V row straight into registers (no
//   shared-memory staging), holds the matching slice of every head's q in
//   registers, and the group's dot products meet in warp shuffles.  `lpt`
//   is the row's chunk count C rounded up to a power of two, so a head_dim
//   whose C is not one leaves lanes idle (hd 120: C 15 of lpt 16 in bf16,
//   30 of 32 in f32): an idle lane loads nothing, keeps zeros for its q, K
//   and V, so it adds 0 to every shuffle sum, and stores nothing.  Each
//   group keeps an online softmax per head in registers, updated once per
//   batch of 4 tokens (scores in log2 units, so each exponential is one
//   exp2f); at the end the groups merge in shared memory by log-sum-exp
//   and the block writes an f32 partial (m, l, acc[hd]) per head.  The
//   loads of lengths, the page table and q do not wait on one another.
//   A split with no live token (past lengths[b], or all its pages
//   unmapped) writes m = -inf, l = 0 and reads no K/V.  Unmapped (-1)
//   pages are never read.
// * Combine kernel, one block per (b, head): computes the n_splits
//   weights 2^(m_s - M) once, in parallel, then merges the partials and
//   writes out in q's dtype; a row of length 0 (every split empty) gives
//   exact zeros.  Two kernels rather than one whose last block per row
//   merges through an atomic counter: no counter to zero between calls,
//   no fence, and the second launch costs a few microseconds at most.
// Page, token and head strides come from the caller, so a per-layer view
// pool[:, l, 0] of the serving pool [P, L, 2, T, KV, hd] is read in place
// (its base and strides must be multiples of 16 bytes).  Both dtypes run
// on CUDA cores and accumulate in f32.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;          // query heads one block scores
constexpr int kMaxGroups = 64;    // kThreads / the smallest lpt (2)
// groups * hd <= 1024 for any hd the launcher takes: groups = 128 / lpt
// and hd <= lpt * (16 B / element) while C <= 32 (8 groups x 120 = 960 at
// hd 120 in bf16); past 32 chunks (f32, hd > 128) 4 groups x 256
constexpr int kAccFloats = 1024;
constexpr int kMaxSplits = 512;   // the combine kernel's weights in smem
constexpr float kLog2e = 1.4426950408889634f;

// NC: 16-byte chunks of a head row per lane (2 only for f32 at hd > 128).
// Scores are kept in log2 units (scale * log2 e folded in), so every
// exponential is one exp2f; the partial's m is in those units too.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int H, int KV, int hd, int T_, int MP,
    int pages_per_split, int lpt, int64_t k_sp, int64_t k_st, int64_t k_sh,
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale_log2) {
  constexpr int E = Vec16<T>::kElems;
  constexpr int kUnroll = 4 / NC;  // tokens a group loads before computing
  const int b = blockIdx.x;
  const int G = H / KV;
  const int n_hc = (G + kMaxG - 1) / kMaxG;
  const int kvh = blockIdx.y / n_hc;
  const int hc = blockIdx.y - kvh * n_hc;
  const int h0 = kvh * G + hc * kMaxG;
  const int Gc = min(kMaxG, G - hc * kMaxG);
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int ngr = kThreads / lpt;
  const int grp = tid / lpt;
  const int sub = tid - grp * lpt;
  const int C = hd / E;  // chunks per head row

  __shared__ float m_s[kMaxGroups][kMaxG];
  __shared__ float l_s[kMaxGroups][kMaxG];
  __shared__ float w_s[kMaxGroups][kMaxG];
  __shared__ __align__(16) float acc_s[kMaxG * kAccFloats];

  // lengths, the page table and q are read side by side: none waits on
  // another
  const int c0 = split * pages_per_split;
  const int c1 = min(c0 + pages_per_split, MP);
  const int start = c0 * T_;
  const int end = min(c1 * T_, lengths[b]);
  const int* row = page_table + (int64_t)b * MP;
  // partial of head h0 + g at ((b * H + h0 + g) * n_splits + split)
  const int64_t pbase = ((int64_t)b * H + h0) * n_splits + split;

  float qr[kMaxG][NC][E];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + j * lpt;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (g < Gc && c < C)
        u = *reinterpret_cast<const uint4*>(
            q + ((int64_t)b * H + h0 + g) * hd + c * E);
      Vec16<T>::unpack(u, qr[g][j]);
    }
  }
  bool live = false;
  for (int c = c0; c < c1; ++c) live |= row[c] >= 0 && c * T_ < end;
  if (!live) {
    if (tid < Gc) {
      part_ml[2 * (pbase + (int64_t)tid * n_splits)] = -INFINITY;
      part_ml[2 * (pbase + (int64_t)tid * n_splits) + 1] = 0.f;
    }
    return;
  }

  float acc[kMaxG][NC][E];
  float m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][j][e] = 0.f;
  }

  // every thread runs the same number of steps, so the shuffles below
  // always see the whole warp; tokens that are not live are predicated off
  for (int t0 = start; t0 < end; t0 += ngr * kUnroll) {
    uint4 kr[kUnroll][NC], vr[kUnroll][NC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tok = t0 + u * ngr + grp;
      const int col = tok / T_;
      const int page = col < c1 ? row[col] : -1;
      ok[u] = page >= 0 && tok < end;
      const int t = tok - col * T_;
      const int pg = max(page, 0);  // never dereferenced when not ok
      const T* kp = k_pages + pg * k_sp + t * k_st + kvh * k_sh;
      const T* vp = v_pages + pg * v_sp + t * v_st + kvh * v_sh;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = sub + j * lpt;
        kr[u][j] = vr[u][j] = make_uint4(0, 0, 0, 0);
        if (ok[u] && c < C) {
          kr[u][j] = *reinterpret_cast<const uint4*>(kp + c * E);
          vr[u][j] = *reinterpret_cast<const uint4*>(vp + c * E);
        }
      }
    }
    // scores of this step's tokens, -inf where a token is not live
    float sc[kUnroll][kMaxG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[NC][E];
#pragma unroll
      for (int j = 0; j < NC; ++j) Vec16<T>::unpack(kr[u][j], kf[j]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= Gc) break;  // the same for the whole block
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) a = fmaf(qr[g][j][e], kf[j][e], a);
        for (int o = lpt >> 1; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        sc[u][g] = ok[u] ? a * scale_log2 : -INFINITY;
      }
    }
    float vf[kUnroll][NC][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < NC; ++j) Vec16<T>::unpack(vr[u][j], vf[u][j]);
    // one online-softmax update per step: rescale once, add kUnroll tokens
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gc) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][g]);
      if (mx == -INFINITY) continue;  // no live token yet in this group
      const float alpha = exp2f(m[g] - mx);
      float p[kUnroll];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = exp2f(sc[u][g] - mx);
        sum += p[u];
      }
      l[g] = fmaf(l[g], alpha, sum);
      m[g] = mx;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[g][j][e] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vf[u][j][e], a);
          acc[g][j][e] = a;
        }
    }
  }

  // merge the groups: every lane of a group holds the same m and l
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= Gc) break;
    if (sub == 0) {
      m_s[grp][g] = m[g];
      l_s[grp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = sub + j * lpt;
      if (c < C) {
        float* dst = acc_s + (grp * kMaxG + g) * hd + c * E;
#pragma unroll
        for (int e = 0; e < E; ++e) dst[e] = acc[g][j][e];
      }
    }
  }
  __syncthreads();
  if (tid < Gc) {  // one thread per head: the split's m, l and weights
    float M = -INFINITY;
    for (int r = 0; r < ngr; ++r) M = fmaxf(M, m_s[r][tid]);
    float L = 0.f;
    for (int r = 0; r < ngr; ++r) {
      const float w = exp2f(m_s[r][tid] - M);  // a group with no token: 0
      w_s[r][tid] = w;
      L = fmaf(l_s[r][tid], w, L);
    }
    const int64_t p = pbase + (int64_t)tid * n_splits;
    part_ml[2 * p] = M;
    part_ml[2 * p + 1] = L;
  }
  __syncthreads();
  for (int i = tid; i < Gc * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float a = 0.f;
    for (int r = 0; r < ngr; ++r)
      a = fmaf(acc_s[(r * kMaxG + g) * hd + d], w_s[r][g], a);
    part_acc[(pbase + (int64_t)g * n_splits) * hd + d] = a;
  }
}

__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool take_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = take_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by an earlier reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < kThreads / 32; ++w)
    v = take_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// One block per (b, head): out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = 2^(m_s - M), empty splits (m_s = -inf, acc never written) skipped.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int hd, int n_splits) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[kThreads / 32];
  const int64_t bh = blockIdx.x;
  const float* ml = part_ml + 2 * bh * n_splits;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n_splits; s += kThreads)
    M = fmaxf(M, ml[2 * s]);
  M = block_reduce(M, red, true);
  float L = 0.f;
  for (int s = threadIdx.x; s < n_splits; s += kThreads) {
    const float m = ml[2 * s];
    const float w = m == -INFINITY ? 0.f : exp2f(m - M);
    w_s[s] = w;
    L = fmaf(ml[2 * s + 1], w, L);
  }
  L = block_reduce(L, red, false);  // its barriers publish w_s too
  const float inv = L > 0.f ? 1.f / L : 0.f;  // length-0 rows -> 0
  const float* acc = part_acc + bh * n_splits * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float w = w_s[s];
      if (w != 0.f) a = fmaf(acc[(int64_t)s * hd + d], w, a);
    }
    out[bh * hd + d] = from_f32<T>(a * inv);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths, void* out,
                   float* part_acc, float* part_ml, int B, int H, int KV,
                   int hd, int T_, int MP, int n_splits, int pages_per_split,
                   int lpt, int64_t k_sp, int64_t k_st, int64_t k_sh,
                   int64_t v_sp, int64_t v_st, int64_t v_sh, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  dim3 grid(B, KV * ((G + kMaxG - 1) / kMaxG), n_splits);
  paged_split_kernel<T, NC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), part_acc, part_ml, H, KV, hd, T_, MP,
      pages_per_split, lpt, k_sp, k_st, k_sh, v_sp, v_st, v_sh,
      scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), hd, n_splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd a multiple of 8 in 16..256 (whole
// 16-byte chunks in both dtypes).  Strides are in elements; the pools'
// base pointers and page/token/head strides must be 16-byte aligned.
// part_acc [B * H * n_splits * hd] and part_ml [B * H * n_splits * 2] are
// f32 scratch.  Split s takes page-table columns [s * pages_per_split,
// min((s + 1) * pages_per_split, MP)).  Returns a cudaError_t (0 on
// success).
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int H, int KV, int hd, int T, int MP, int n_splits,
    int pages_per_split, int64_t k_sp, int64_t k_st, int64_t k_sh,
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 16 || hd > 256 || n_splits < 1 ||
      n_splits > kMaxSplits || pages_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int elems = dtype == 0 ? 4 : 8;  // per 16-byte chunk
  const int chunks = hd / elems;
  int lpt = 1;  // lanes per token: a power of two, at most a warp
  while (lpt < chunks && lpt < 32) lpt <<= 1;
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (dtype == 0 && chunks > 32)
    return launch<float, 2>(q, k_pages, v_pages, page_table, lengths, out,
                            acc, ml, B, H, KV, hd, T, MP, n_splits,
                            pages_per_split, lpt, k_sp, k_st, k_sh, v_sp,
                            v_st, v_sh, scale, s);
  if (dtype == 0)
    return launch<float, 1>(q, k_pages, v_pages, page_table, lengths, out,
                            acc, ml, B, H, KV, hd, T, MP, n_splits,
                            pages_per_split, lpt, k_sp, k_st, k_sh, v_sp,
                            v_st, v_sh, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 1>(q, k_pages, v_pages, page_table, lengths,
                                    out, acc, ml, B, H, KV, hd, T, MP,
                                    n_splits, pages_per_split, lpt, k_sp,
                                    k_st, k_sh, v_sp, v_st, v_sh, scale, s);
  return (int)cudaErrorInvalidValue;
}

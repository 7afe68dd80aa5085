// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:
// paged_attention (body _pa_kernel): one-token GQA attention through a
// page table, out[b, h] = softmax(q[b, h] . K[b]^T * scale) V[b] over the
// first lengths[b] tokens of the row's pages.
//
// What bounds it on the card: bytes, if each page is read once.  A live
// K/V token serves the G = H / KV query heads of its kv head: 4 G hd
// flops for 4 hd bytes of bf16 K and V, G flops a byte, below the ~295
// flop/byte ridge for every G the configs have (granite-34b's MQA: 48).
// The least time is the live K/V bytes over 3.35 TB/s: 5.1 us a layer at
// granite-34b's decode batch (B 32, ~33.6k live tokens, 17.2 MB).  The
// CUDA-core design below read each page once per chunk of 8 heads (six
// times at G = 48) and did the G flops a byte as scalar fmaf and warp
// shuffles, which at G = 48 take longer than the bytes: 1.7 % of the
// bound there.  At G <= 8 it reads each page once and is held by latency.
//
// Two split kernels, chosen by the wrapper (paged_attention.py) on dtype
// and head_dim, write f32 partials (m, l, acc[hd]) per (row, head, split);
// one combine kernel merges them.  A split is a fixed number of pages,
// pages_per_split, which split_plan() takes from the page size and G, not
// from the page table's width MP; split s of a row takes its page-table
// columns [s * pages_per_split, (s + 1) * pages_per_split).
// * bf16 at hd <= 128: paged_split_kernel_mma, on tensor cores.  A block
//   takes one split of one row for one kv head and all its G query heads
//   (up to 64 a block, more in head chunks of 64): the heads are the M
//   rows of ceil(G / 16) m16 tiles, a warp each (two warps a tile at
//   G <= 32, each on half of every K/V tile's keys, merged at the end), so
//   each live page is read once per (row, kv head).  q stays in registers
//   as mma A fragments.  32-token K/V tiles come into a ring of 4
//   shared-memory stages by 16-byte cp.async, each token's row found
//   through the page table (so a tile may cross pages of any size), rows
//   padded by 16 bytes so every ldmatrix is free of bank conflicts; a
//   token past the split or on an unmapped page is zero-filled and
//   flagged, and its score set to -inf.  S = q K^T and O += P V are
//   mma.sync m16n8k16 with f32 accumulators (ldmatrix for K,
//   ldmatrix.trans for V), the online softmax runs in f32 in log2 units,
//   and P is rounded to bf16 as the A operand of P V, as the plain version
//   rounds p to V's dtype (the row sums add the rounded values).  What
//   bounds this design is then issue and latency inside each warp, not
//   bytes: at granite-34b's decode batch a 32-token tile takes ~3,000
//   cycles of a warp and its copies are in long before (a quarter of the
//   bound).  So each K or V fragment is loaded a step or two ahead of its
//   mma (the asm is volatile: source order is issue order), the next
//   tile's copies go out between the two products, and four loader lanes
//   share a token row (one page lookup a row).  hd <= 64
//   runs in the HD = 64 instantiation, 64 < hd <= 128 in HD = 128,
//   zero-padded inside as flash pads hd 120.  The grid is persistent:
//   (SMs x the blocks an SM holds) blocks walk the batch's live splits,
//   counted on the card from lengths (row b has ceil(min(lengths[b],
//   MP T) / (pages_per_split T)) of them; a warp scan over the rows finds
//   the row of the c-th), so the work follows the live pages, no block is
//   spent on a split past a row's length, and the launch depends on
//   (B, KV, MP) alone: a CUDA graph replays it for any lengths.
// * f32 at any hd, bf16 at hd > 128: paged_split_kernel, on CUDA cores
//   (tensor cores would mean TF32 for f32, a lower precision).  Grid
//   (B, KV * head chunks, n_splits); a block scores up to 8 query heads of
//   one kv head.  Its 128 threads form groups of `lpt` lanes, one token
//   per group at a time: each lane reads 16 bytes of the token's K and V
//   row straight into registers, holds the matching slice of every head's
//   q in registers, and the group's dot products meet in warp shuffles.
//   `lpt` is the row's chunk count C rounded up to a power of two, so a
//   head_dim whose C is not one leaves lanes idle (hd 120 in f32: C 30 of
//   lpt 32): an idle lane loads nothing, keeps zeros for its q, K and V,
//   so it adds 0 to every shuffle sum, and stores nothing.  Each group
//   keeps an online softmax per head in registers, updated once per batch
//   of 4 tokens (scores in log2 units, so each exponential is one exp2f);
//   at the end the groups merge in shared memory by log-sum-exp.  A split
//   with no live token (past lengths[b], or all its pages unmapped) writes
//   m = -inf, l = 0 and reads no K/V.
// * Combine kernel, one block per (b, head): computes the row's live
//   splits' weights 2^(m_s - M) once, in parallel, then merges the
//   partials and writes out in q's dtype; a split with m = -inf (no live
//   token) is skipped, and a row of length 0 gives exact zeros.  Two
//   kernels rather than one whose last block per row merges through an
//   atomic counter: no counter to zero between calls, no fence.
// A window W > 0 (a per-call argument; 0 is none) limits a row of n tokens
// to its last W: keys at n - W and after, as the flash kernel and the plain
// version mask them.  Its splits then start at the page that holds n - W,
// not at column 0 (window_base), so split s takes columns
// [first + s * pages_per_split, ...) and the tokens before n - W in the first
// page are skipped; the wrapper takes n_splits from the pages a window can
// touch, not from MP.  At W = 0 the first page is column 0: the same splits,
// tiles and sums as without the argument.
// Unmapped (-1) pages are never read.  Page, token and head strides come
// from the caller, so a per-layer view pool[:, l, 0] of the serving pool
// [P, L, 2, T, KV, hd] is read in place (its base and strides must be
// multiples of 16 bytes).  Both designs accumulate in f32.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "splits.cuh"

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
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale_log2, int window) {
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
  const int len = lengths[b];
  const int c0 = window_base(len, T_, window) / T_ + split * pages_per_split;
  const int c1 = min(c0 + pages_per_split, MP);
  const int start = max(c0 * T_, window_lo(len, window));
  const int end = min(c1 * T_, len);
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

// One block per (b, head): out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = 2^(m_s - M), empty splits (m_s = -inf, acc never written) skipped.
// With lengths (the tensor-core design) only row b's live splits are read:
// the split kernel writes no others; without (the CUDA-core design) every
// one of the n_splits, whose dead ones hold m = -inf.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int hd, int n_splits,
    const int* __restrict__ lengths, int H, int tps, int cap, int T_,
    int window) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[kThreads / 32];
  const int64_t bh = blockIdx.x;
  const int n = lengths == nullptr
                    ? n_splits
                    : min(n_splits, live_splits_of(lengths[bh / H], tps, cap,
                                                   T_, window));
  const float* ml = part_ml + 2 * bh * n_splits;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n; s += kThreads) M = fmaxf(M, ml[2 * s]);
  M = block_reduce<kThreads>(M, red, true);
  float L = 0.f;
  for (int s = threadIdx.x; s < n; s += kThreads) {
    const float m = ml[2 * s];
    const float w = m == -INFINITY ? 0.f : exp2f(m - M);
    w_s[s] = w;
    L = fmaf(ml[2 * s + 1], w, L);
  }
  L = block_reduce<kThreads>(L, red, false);  // its barriers publish w_s too
  const float inv = L > 0.f ? 1.f / L : 0.f;  // length-0 rows -> 0
  const float* acc = part_acc + bh * n_splits * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = w_s[s];
      if (w != 0.f) a = fmaf(acc[(int64_t)s * hd + d], w, a);
    }
    out[bh * hd + d] = from_f32<T>(a * inv);
  }
}

// --------------------------------------------- tensor-core split kernel
using bf16 = __nv_bfloat16;

// HD: the instantiation's head_dim (hd zero-padded up to it); NT: m16
// tiles of query heads a block holds (ceil(G / 16), at most 4).
template <int HD, int NT>
struct MmaCfg {
  static constexpr int kSlices = NT <= 2 ? 2 : 1;  // warps on one tile's keys
  static constexpr int kWarps = NT * kSlices;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBK = 32;  // tokens a K/V stage holds
  static constexpr int kWarpKeys = kBK / kSlices;
  static constexpr int kStages = 4;
  static constexpr int kLd = HD + 8;  // row pitch (elements): +16 bytes
  static constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  // a loader thread takes kChunks / kRowLanes of a row's chunks, so a
  // token's page is looked up by kRowLanes threads, not kChunks
  static constexpr int kRowLanes = 4;
  static constexpr int kRowStep = kThreads / kRowLanes;  // rows a pass
  static constexpr int kStageElems = 2 * kBK * kLd;  // K rows, then V rows
  static constexpr int kRingBytes = 2 * kStages * kStageElems;
  // the ring, then a live flag per stage row
  static constexpr size_t kSmem = kRingBytes + kStages * kBK;
  // what a second-slice warp hands its tile's first per lane: O, m[2], l[2]
  static constexpr int kHandoff = HD / 2 + 4;
  static_assert(kChunks % kRowLanes == 0, "whole chunks a loader thread");
  static_assert(kBK == 32, "a stage's live flags are one warp's ballot");
  static_assert((kSlices - 1) * NT * kHandoff * 32 * 4 <= kRingBytes,
                "the hand-off must fit in the ring");
};

// Fragment layout of mma m16n8k16 (lane = 4 g + t): an accumulator
// c[0..1] holds row g, columns 2t and 2t + 1 of its 16 x 8 tile, c[2..3]
// row g + 8.  An A fragment a[0..3] holds (row g, k 2t..), (row g + 8,
// k 2t..), (row g, k 2t + 8..), (row g + 8, k 2t + 8..).  Here a row is a
// query head and a column a token (S) or a head_dim column (O).
template <int HD, int NT>
__global__ void __launch_bounds__(MmaCfg<HD, NT>::kThreads)
    paged_split_kernel_mma(
        const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
        const bf16* __restrict__ v_pages, const int* __restrict__ page_table,
        const int* __restrict__ lengths, float* __restrict__ part_acc,
        float* __restrict__ part_ml, int B, int H, int KV, int hd, int T_,
        int MP, int n_splits, int pages_per_split, int64_t k_sp,
        int64_t k_st, int64_t k_sh, int64_t v_sp, int64_t v_st,
        int64_t v_sh, float scale_log2, int window) {
  using Cfg = MmaCfg<HD, NT>;
  constexpr int kBK = Cfg::kBK;
  constexpr int kLd = Cfg::kLd;
  constexpr int kChunks = Cfg::kChunks;
  constexpr int kStages = Cfg::kStages;
  constexpr int kWarpKeys = Cfg::kWarpKeys;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ok_s = smem_raw + Cfg::kRingBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp % NT;       // this warp's m16 tile of heads
  const int slice = warp / NT;    // and its share of every stage's keys
  const int key0 = slice * kWarpKeys;
  const int G = H / KV;
  const int n_hc = (G + NT * 16 - 1) / (NT * 16);  // head chunks a kv head
  const int n_heads = KV * n_hc;
  const int tps = pages_per_split * T_;
  const int cap = MP * T_;
  // a loader thread copies the 16-byte chunks ld_q, ld_q + kRowLanes, ...
  // of every kRowStep-th row of a tile
  const int ld_q = tid % Cfg::kRowLanes;

  const int live =
      batch_live_splits(lengths, B, tps, cap, T_, window, lane) * n_heads;
  for (int c = blockIdx.x; c < live; c += gridDim.x) {
    const int rc = c / n_heads;
    const int kh = c - rc * n_heads;
    const int kvh = kh / n_hc;
    const int g0 = (kh - kvh * n_hc) * NT * 16;  // first head of the chunk
    int b, s;
    locate_split(lengths, B, tps, cap, T_, window, rc, lane, b, s);
    const int len = lengths[b];
    const int first = window_base(len, T_, window) + s * tps;
    const int start = max(first, window_lo(len, window));
    const int end = min(first + tps, min(len, cap));
    const int n_tiles = (end - start + kBK - 1) / kBK;
    const int* row = page_table + (int64_t)b * MP;

    auto load = [&](int tile, int stage) {
      const int t0 = start + tile * kBK;
      bf16* ks = ring + stage * Cfg::kStageElems;
      bf16* vs = ks + kBK * kLd;
      for (int r = tid / Cfg::kRowLanes; r < kBK; r += Cfg::kRowStep) {
        const int pos = t0 + r;
        const int col = pos / T_;
        const int page = pos < end ? row[col] : -1;
        const bool ok = page >= 0;
        const int64_t t = pos - col * T_;
        const bf16* kp = k_pages + (ok ? page * k_sp + t * k_st + kvh * k_sh
                                       : 0);
        const bf16* vp = v_pages + (ok ? page * v_sp + t * v_st + kvh * v_sh
                                       : 0);
#pragma unroll
        for (int j = 0; j < kChunks / Cfg::kRowLanes; ++j) {
          const int d = (ld_q + j * Cfg::kRowLanes) * 8;
          const bool in = ok && d < hd;  // columns past hd stay zero
          cp_async16(smem_addr(ks + r * kLd + d), kp + (in ? d : 0), in);
          cp_async16(smem_addr(vs + r * kLd + d), vp + (in ? d : 0), in);
        }
        if (ld_q == 0) ok_s[stage * kBK + r] = ok;
      }
    };

    // q as A fragments: rows past G and columns past hd are zero
    const int r_lo = g0 + mt * 16 + (lane >> 2);  // heads within the group
    const int r_hi = r_lo + 8;
    const bf16* qb = q + ((int64_t)b * H + (int64_t)kvh * G) * hd;
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i & 1 ? r_hi : r_lo;
        const int d = kk * 16 + 2 * (lane & 3) + (i >> 1) * 8;
        qf[kk][i] = r < G && d < hd
                        ? *reinterpret_cast<const uint32_t*>(qb + r * hd + d)
                        : 0u;
      }
    }

    __syncthreads();  // the last split's readers of the ring are done
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_tiles) load(i, i);
      cp_async_commit();
    }

    float o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this lane's part of the row sums

    // The ldmatrix, mma and cp.async asm is volatile, so the order below is
    // the order of issue: each K or V fragment is loaded a step or two
    // before the mma that takes it, and the next tile's copies go out
    // between the two products, so their address arithmetic overlaps the
    // products in flight.
    constexpr int kNB = kWarpKeys / 16;        // 16-key blocks a warp holds
    constexpr int kPV = kNB * (HD / 16);       // ldmatrix.trans steps of P V
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile i is in; tile i - 1's stage is free
      const int stage = i % kStages;
      const bf16* ks = ring + stage * Cfg::kStageElems;
      const bf16* vs = ks + kBK * kLd;
      // bit j: whether this warp's key key0 + j is live
      const unsigned live_keys =
          __ballot_sync(0xffffffffu, ok_s[stage * kBK + lane] != 0) >> key0;

      // S = q K^T over this warp's keys: one ldmatrix.x4 feeds 16 keys
      auto load_k = [&](int kk, uint32_t (&dst)[kNB][4]) {
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          ldmatrix_x4(dst[nb], smem_addr(ks + (key0 + nb * 16 + (lane & 7) +
                                               ((lane >> 4) << 3)) * kLd +
                                         kk * 16 + ((lane >> 3) & 1) * 8));
      };
      float sc[kWarpKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      uint32_t bk[2][kNB][4];
      load_k(0, bk[0]);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (kk + 1 < HD / 16) load_k(kk + 1, bk[(kk + 1) & 1]);
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          mma_bf16(sc[2 * nb], qf[kk], bk[kk & 1][nb][0], bk[kk & 1][nb][1]);
          mma_bf16(sc[2 * nb + 1], qf[kk], bk[kk & 1][nb][2],
                   bk[kk & 1][nb][3]);
        }
      }

      if (i + kStages - 1 < n_tiles)
        load(i + kStages - 1, (i + kStages - 1) % kStages);
      cp_async_commit();

      // V fragments for P V, step st = (16 keys kk, 16 columns db)
      auto load_v = [&](int st, uint32_t (&dst)[4]) {
        const int kk = st / (HD / 16);
        const int db = st - kk * (HD / 16);
        ldmatrix_x4_trans(dst, smem_addr(vs + (key0 + kk * 16 + (lane & 7) +
                                               ((lane >> 3) & 1) * 8) * kLd +
                                         db * 16 + (lane >> 4) * 8));
      };
      uint32_t bv[3][4];
      load_v(0, bv[0]);
      load_v(1, bv[1]);

      // log2 units; a token that is not live scores -inf
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = (live_keys >> (j * 8 + 2 * (lane & 3) + (e & 1))) & 1u
                         ? sc[j][e] * scale_log2
                         : -INFINITY;

      // online softmax over the two heads this lane holds
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
      }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // a head with no live token yet keeps exp2(-inf - 0) = 0 everywhere
        base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        const float alpha = exp2f(m[r] - base[r]);
        m[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }

      // P in bf16 registers, laid out as the A fragments of P V
      uint32_t pf[kNB][4];
#pragma unroll
      for (int j = 0; j < kWarpKeys / 8; ++j) {
        float p0 = exp2f(sc[j][0] - base[0]);
        float p1 = exp2f(sc[j][1] - base[0]);
        float p2 = exp2f(sc[j][2] - base[1]);
        float p3 = exp2f(sc[j][3] - base[1]);
        pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
      }

      // O += P V: one ldmatrix.x4.trans feeds 16 columns of 16 keys
#pragma unroll
      for (int st = 0; st < kPV; ++st) {
        if (st + 2 < kPV) load_v(st + 2, bv[(st + 2) % 3]);
        const int kk = st / (HD / 16);
        const int db = st - kk * (HD / 16);
        mma_bf16(o[2 * db], pf[kk], bv[st % 3][0], bv[st % 3][1]);
        mma_bf16(o[2 * db + 1], pf[kk], bv[st % 3][2], bv[st % 3][3]);
      }
    }

    if constexpr (Cfg::kSlices > 1) {
      // the second slice's warp of each tile hands its O, m and l to the
      // first through the (now idle) ring, lane-major: no bank conflicts
      constexpr int kHandoff = Cfg::kHandoff;
      float* xs = reinterpret_cast<float*>(ring) + mt * kHandoff * 32;
      __syncthreads();
      if (slice == 1) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) xs[(j * 4 + e) * 32 + lane] = o[j][e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xs[(HD / 2 + r) * 32 + lane] = m[r];
          xs[(HD / 2 + 2 + r) * 32 + lane] = l[r];
        }
      }
      __syncthreads();
      if (slice == 1) continue;
      float w0[2], w1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xs[(HD / 2 + r) * 32 + lane];
        const float M = fmaxf(m[r], m1);
        w0[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - M);
        w1[r] = m1 == -INFINITY ? 0.f : exp2f(m1 - M);
        l[r] = l[r] * w0[r] + xs[(HD / 2 + 2 + r) * 32 + lane] * w1[r];
        m[r] = M;
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j][e] = o[j][e] * w0[e >> 1] +
                    xs[(j * 4 + e) * 32 + lane] * w1[e >> 1];
    }

    // the partial of head r at ((b * H + kvh * G + r) * n_splits + s)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int h = r ? r_hi : r_lo;
      if (h >= G) continue;
      const int64_t p = ((int64_t)b * H + (int64_t)kvh * G + h) * n_splits + s;
      float* dst = part_acc + p * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = j * 8 + 2 * (lane & 3);
        if (d < hd)
          *reinterpret_cast<float2*>(dst + d) =
              make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
      if ((lane & 3) == 0) {
        part_ml[2 * p] = m[r];
        part_ml[2 * p + 1] = l[r];
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* page_table, const void* lengths, void* out,
                   float* part_acc, float* part_ml, int B, int H, int KV,
                   int hd, int T_, int MP, int n_splits, int pages_per_split,
                   int lpt, int64_t k_sp, int64_t k_st, int64_t k_sh,
                   int64_t v_sp, int64_t v_st, int64_t v_sh, float scale,
                   int window, cudaStream_t stream) {
  const int G = H / KV;
  dim3 grid(B, KV * ((G + kMaxG - 1) / kMaxG), n_splits);
  paged_split_kernel<T, NC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), part_acc, part_ml, H, KV, hd, T_, MP,
      pages_per_split, lpt, k_sp, k_st, k_sh, v_sp, v_st, v_sh,
      scale * kLog2e, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), hd, n_splits, nullptr, H, 0,
      0, T_, 0);
  return cudaGetLastError();
}

// The persistent grid: as many blocks as the card holds at once (SMs x the
// blocks an SM fits, from the occupancy calculator, read once), no more
// than the splits a full page table could have.
template <int HD, int NT>
cudaError_t launch_mma(const void* q, const void* k_pages,
                       const void* v_pages, const void* page_table,
                       const void* lengths, void* out, float* part_acc,
                       float* part_ml, int B, int H, int KV, int hd, int T_,
                       int MP, int n_splits, int pages_per_split,
                       int64_t k_sp, int64_t k_st, int64_t k_sh, int64_t v_sp,
                       int64_t v_st, int64_t v_sh, float scale, int window,
                       int sm_count, cudaStream_t stream) {
  using Cfg = MmaCfg<HD, NT>;
  static int per_sm = 0;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel_mma<HD, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kSmem);
    if (e == cudaSuccess)  // the ring limits the blocks an SM holds
      e = cudaFuncSetAttribute(paged_split_kernel_mma<HD, NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, paged_split_kernel_mma<HD, NT>, Cfg::kThreads,
          Cfg::kSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int G = H / KV;
  const int64_t most =
      (int64_t)B * n_splits * KV * ((G + NT * 16 - 1) / (NT * 16));
  const int blocks = (int)std::max<int64_t>(
      1, std::min<int64_t>(most, (int64_t)sm_count * std::max(1, per_sm)));
  paged_split_kernel_mma<HD, NT><<<blocks, Cfg::kThreads, Cfg::kSmem,
                                   stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), part_acc, part_ml, B, H, KV, hd, T_,
      MP, n_splits, pages_per_split, k_sp, k_st, k_sh, v_sp, v_st, v_sh,
      scale * kLog2e, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<bf16><<<B * H, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<bf16*>(out), hd, n_splits,
      static_cast<const int*>(lengths), H, pages_per_split * T_, MP * T_, T_,
      window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_mma_hd(int NT, const void* q, const void* k_pages,
                          const void* v_pages, const void* page_table,
                          const void* lengths, void* out, float* part_acc,
                          float* part_ml, int B, int H, int KV, int hd,
                          int T_, int MP, int n_splits, int pages_per_split,
                          int64_t k_sp, int64_t k_st, int64_t k_sh,
                          int64_t v_sp, int64_t v_st, int64_t v_sh,
                          float scale, int window, int sm_count,
                          cudaStream_t stream) {
#define PAGED_MMA_ARGS                                                     \
  q, k_pages, v_pages, page_table, lengths, out, part_acc, part_ml, B, H,  \
      KV, hd, T_, MP, n_splits, pages_per_split, k_sp, k_st, k_sh, v_sp,   \
      v_st, v_sh, scale, window, sm_count, stream
  switch (NT) {
    case 1: return launch_mma<HD, 1>(PAGED_MMA_ARGS);
    case 2: return launch_mma<HD, 2>(PAGED_MMA_ARGS);
    case 3: return launch_mma<HD, 3>(PAGED_MMA_ARGS);
    default: return launch_mma<HD, 4>(PAGED_MMA_ARGS);
  }
#undef PAGED_MMA_ARGS
}

}  // namespace

// The CUDA-core design.  dtype: 0 = float32, 1 = bfloat16.  hd a multiple
// of 8 in 16..256 (whole 16-byte chunks in both dtypes).  Strides are in
// elements; the pools' base pointers and page/token/head strides must be
// 16-byte aligned.  part_acc [B * H * n_splits * hd] and part_ml
// [B * H * n_splits * 2] are f32 scratch.  Split s takes page-table
// columns [f + s * pages_per_split, min(f + (s + 1) * pages_per_split, MP)),
// f the column of the row's window's first key (0 at window 0).  Returns a
// cudaError_t (0 on success).
extern "C" int paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int H, int KV, int hd, int T, int MP, int n_splits,
    int pages_per_split, int64_t k_sp, int64_t k_st, int64_t k_sh,
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale, int window,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 16 || hd > 256 || n_splits < 1 ||
      n_splits > kMaxSplits || pages_per_split < 1 || window < 0)
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
                            v_st, v_sh, scale, window, s);
  if (dtype == 0)
    return launch<float, 1>(q, k_pages, v_pages, page_table, lengths, out,
                            acc, ml, B, H, KV, hd, T, MP, n_splits,
                            pages_per_split, lpt, k_sp, k_st, k_sh, v_sp,
                            v_st, v_sh, scale, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 1>(q, k_pages, v_pages, page_table, lengths,
                                    out, acc, ml, B, H, KV, hd, T, MP,
                                    n_splits, pages_per_split, lpt, k_sp,
                                    k_st, k_sh, v_sp, v_st, v_sh, scale,
                                    window, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core design, bfloat16 only, hd a multiple of 8 in 16..128;
// arguments as paged_attention_launch's, plus the card's SM count.  Only
// row b's first live_splits_of(lengths[b], ...) splits are written and
// read.  Returns a cudaError_t (0 on success).
extern "C" int paged_attention_mma_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* lengths, void* out, void* part_acc,
    void* part_ml, int B, int H, int KV, int hd, int T, int MP, int n_splits,
    int pages_per_split, int64_t k_sp, int64_t k_st, int64_t k_sh,
    int64_t v_sp, int64_t v_st, int64_t v_sh, float scale, int window,
    int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 16 || hd > 128 || n_splits < 1 ||
      n_splits > kMaxSplits || pages_per_split < 1 || sm_count < 1 ||
      KV < 1 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const int NT = min(4, (H / KV + 15) / 16);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  if (hd <= 64)
    return launch_mma_hd<64>(NT, q, k_pages, v_pages, page_table, lengths,
                             out, acc, ml, B, H, KV, hd, T, MP, n_splits,
                             pages_per_split, k_sp, k_st, k_sh, v_sp, v_st,
                             v_sh, scale, window, sm_count, s);
  return launch_mma_hd<128>(NT, q, k_pages, v_pages, page_table, lengths,
                            out, acc, ml, B, H, KV, hd, T, MP, n_splits,
                            pages_per_split, k_sp, k_st, k_sh, v_sp, v_st,
                            v_sh, scale, window, sm_count, s);
}

// Latent attention's absorbed decode for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  Added
// for DeepSeek-V3's paged decode (src/repro_torch/models/mla.py): each of a
// row's H = 128 query heads, q = [q_nope W_UK (512) | rope(q_r) (64)],
// attends the row's cached tokens, whose 576-wide rows [c (512) | rope(k_r)
// (64)] all heads share, and takes o = softmax(q . row * scale) c, the
// first 512 columns of the same rows.
//
// What bounds it on the card: a cached token is 1,152 bytes and serves
// 128 heads of 2 (576 + 512) operations each, 242 operations a byte, near
// the H100's ridge of ~295: at DeepSeek-V3's decode batch (B 64, ~2,500
// tokens a row) the bytes take 55 us a layer and the operations, at the
// bf16 tensor-core peak, 45 us.  So the products run on tensor cores and
// each row's tokens are read from device memory once.
//
// Two kernels, as paged_attention.cu's tensor-core design:
// * mla_decode_split_kernel.  A block holds a tile of 64 query heads of
//   one row (heads past H are zero rows) and walks one split of the row's
//   pages (pages_per_split pages, host-chosen, split_plan in
//   mla_decode.py).  The grid is persistent: (SMs x the blocks an SM
//   holds, 1) blocks walk the batch's live (split, head tile) units,
//   counted on the card from lengths, the two head tiles of a split next
//   to each other so the second reads the split's tokens from L2.  Eight
//   warps: warp w takes heads 16 (w % 4) .. +16 of the tile and O columns
//   256 (w / 4) .. +256, so the tile's O[64 x 512] lives in registers, 128
//   floats a thread (FlashMLA's layout, on mma.sync m16n8k16 in place of
//   wgmma).  q's tile [64 x 576] stays in shared memory; 64-token tiles of
//   rows come into a ring of two shared-memory stages by 16-byte cp.async,
//   each token's row found through the page table (so a tile may cross
//   pages of any size), rows padded by 16 bytes so every ldmatrix is free
//   of bank conflicts.  One load of a tile serves both products: S = q
//   rows^T over its 576 columns (ldmatrix), O += P V over its first 512
//   (ldmatrix.trans).  Both warps of a head group compute the same S
//   [16 x 64], the same online softmax (f32, log2 units) and the same P:
//   its unnormalised f32 values go into the row sums, and their bf16
//   rounding is the A operand of P V, so o is (sum of bf16(p) v) over the
//   f32 sum of p; each warp then multiplies its half of V.  A token past the split or on an unmapped
//   page is zero-filled and flagged, and its score set to -inf.  The
//   second head tile reads a split's tokens again, from L2 when the two
//   run together; no cluster multicasts them.
// * mla_decode_combine_kernel, one block per (row, head): merges the row's
//   live splits' partials (m, l, acc[512]) by log-sum-exp and writes o in
//   bf16; a row of length 0 gives exact zeros.
// What bounds this design: shared memory.  Every warp reads q's 16 rows
// and the tile's rows through ldmatrix at every tile (S is computed twice
// per head group), about 1.5 times the tile's bytes from HBM a head
// tile; wgmma (one 64-row product reading its operands once) is the next
// step.

#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "splits.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDV = 512;          // the latent: V, and the rows' first columns
constexpr int kDK = kDV + 64;     // a cached row: the latent and the RoPE key
constexpr int kHeads = 64;        // query heads a block holds
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHalf = kDV / 2;    // O columns a warp holds
constexpr int kBK = 64;           // tokens a stage holds
constexpr int kStages = 2;
constexpr int kLd = kDK + 8;      // row pitch (elements): +16 bytes
constexpr int kChunks = kDK / 8;  // 16-byte chunks a row
constexpr int kRowLanes = 8;      // loader threads a token row
constexpr int kRowStep = kThreads / kRowLanes;  // rows a pass
constexpr int kTileElems = kBK * kLd;
// q's tile, the ring, then a live flag per stage row
constexpr size_t kSmem =
    sizeof(bf16) * (size_t)(kHeads + kStages * kBK) * kLd + kStages * kBK;
constexpr int kMaxSplits = 512;   // the combine kernel's weights in smem
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunks % kRowLanes == 0, "whole chunks a loader thread");
static_assert(kBK == 64, "a stage's live flags are two warps' ballots");

// Fragment layout of mma m16n8k16 (lane = 4 g + t): an accumulator
// c[0..1] holds row g, columns 2t and 2t + 1 of its 16 x 8 tile, c[2..3]
// row g + 8.  An A fragment a[0..3] holds (row g, k 2t..), (row g + 8,
// k 2t..), (row g, k 2t + 8..), (row g + 8, k 2t + 8..).  Here a row is a
// query head and a column a token (S) or a latent column (O).
__global__ void __launch_bounds__(kThreads, 1) mla_decode_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pages,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int B, int H,
    int T_, int MP, int n_splits, int pages_per_split, int64_t sp,
    int64_t st, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kHeads][kLd]
  bf16* ring = q_s + kHeads * kLd;                // [kStages][kBK][kLd]
  unsigned char* ok_s =
      reinterpret_cast<unsigned char*>(ring + kStages * kTileElems);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int mt = warp & 3;     // this warp's 16 heads of the tile
  const int half = warp >> 2;  // and its 256 columns of O
  const int n_ht = (H + kHeads - 1) / kHeads;
  const int tps = pages_per_split * T_;
  const int cap = MP * T_;
  // a loader thread copies the chunks ld_q, ld_q + kRowLanes, ... of every
  // kRowStep-th row of a tile
  const int ld_q = tid % kRowLanes;

  const int live =
      batch_live_splits(lengths, B, tps, cap, T_, 0, lane) * n_ht;
  for (int c = blockIdx.x; c < live; c += gridDim.x) {
    const int rc = c / n_ht;
    const int h0 = (c - rc * n_ht) * kHeads;
    int b, s;
    locate_split(lengths, B, tps, cap, T_, 0, rc, lane, b, s);
    const int start = s * tps;
    const int end = min(start + tps, min(lengths[b], cap));
    const int n_tiles = (end - start + kBK - 1) / kBK;
    const int* row = page_table + (int64_t)b * MP;

    auto load = [&](int tile, int stage) {
      const int t0 = start + tile * kBK;
      bf16* ks = ring + stage * kTileElems;
      for (int r = tid / kRowLanes; r < kBK; r += kRowStep) {
        const int pos = t0 + r;
        const int col = pos / T_;
        const int page = pos < end ? row[col] : -1;
        const bool ok = page >= 0;
        const bf16* src =
            pages + (ok ? page * sp + (int64_t)(pos - col * T_) * st : 0);
#pragma unroll
        for (int j = 0; j < kChunks / kRowLanes; ++j) {
          const int d = (ld_q + j * kRowLanes) * 8;
          cp_async16(smem_addr(ks + r * kLd + d), src + (ok ? d : 0), ok);
        }
        if (ld_q == 0) ok_s[stage * kBK + r] = ok;
      }
    };

    __syncthreads();  // the last unit's readers of q_s and the ring are done
    const bf16* qb = q + ((int64_t)b * H + h0) * kDK;
    for (int i = tid; i < kHeads * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int d = (i - r * kChunks) * 8;
      const bool in = h0 + r < H;
      cp_async16(smem_addr(q_s + r * kLd + d),
                 in ? qb + (int64_t)r * kDK + d : qb, in);
    }
    load(0, 0);  // a live split has a tile
    cp_async_commit();

    float o[kHalf / 8][4];
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
      o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this lane's part of the row sums

    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i & 1;
      if (i + 1 < n_tiles) {
        load(i + 1, stage ^ 1);  // its stage's readers passed the barrier
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile i (and q) in
      const bf16* ks = ring + stage * kTileElems;
      // bit j: whether the tile's token j is live
      const uint64_t live_keys =
          (uint64_t)__ballot_sync(0xffffffffu, ok_s[stage * kBK + lane] != 0) |
          ((uint64_t)__ballot_sync(0xffffffffu,
                                   ok_s[stage * kBK + 32 + lane] != 0)
           << 32);

      // S = q rows^T over 576 columns: per 16 columns one ldmatrix.x4 of q
      // and four of rows (16 tokens each)
      float sc[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kDK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(q_s + (mt * 16 + (lane & 15)) * kLd +
                                 kk * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int nb = 0; nb < kBK / 16; ++nb) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(ks + (nb * 16 + (lane & 7) +
                                          ((lane >> 4) << 3)) * kLd +
                                    kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(sc[2 * nb], a, bk[0], bk[1]);
          mma_bf16(sc[2 * nb + 1], a, bk[2], bk[3]);
        }
      }

      // log2 units; a token that is not live scores -inf
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = (live_keys >> (j * 8 + 2 * (lane & 3) + (e & 1))) & 1ull
                         ? sc[j][e] * scale_log2
                         : -INFINITY;

      // online softmax over the two heads this lane holds
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
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
        for (int j = 0; j < kHalf / 8; ++j) {
          o[j][2 * r] *= alpha;
          o[j][2 * r + 1] *= alpha;
        }
      }

      // P in bf16 registers, laid out as the A fragments of P V
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        float p0 = exp2f(sc[j][0] - base[0]);
        float p1 = exp2f(sc[j][1] - base[0]);
        float p2 = exp2f(sc[j][2] - base[1]);
        float p3 = exp2f(sc[j][3] - base[1]);
        pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
      }

      // O += P V over this warp's 256 columns: one ldmatrix.x4.trans feeds
      // 16 columns of 16 tokens
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int db = 0; db < kHalf / 16; ++db) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(ks + (kk * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8) * kLd +
                                          half * kHalf + db * 16 +
                                          (lane >> 4) * 8));
          mma_bf16(o[2 * db], pf[kk], bv[0], bv[1]);
          mma_bf16(o[2 * db + 1], pf[kk], bv[2], bv[3]);
        }
      }
      __syncthreads();  // this stage is free for the load of tile i + 2
    }

    // the partial of head h at ((b * H + h) * n_splits + s): both warps of
    // a head group hold the same m and l; the first writes them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int h = h0 + mt * 16 + (lane >> 2) + 8 * r;
      if (h >= H) continue;
      const int64_t p = ((int64_t)b * H + h) * n_splits + s;
      float* dst = part_acc + p * kDV + half * kHalf;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int d = j * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      }
      if (half == 0 && (lane & 3) == 0) {
        part_ml[2 * p] = m[r];
        part_ml[2 * p + 1] = l[r];
      }
    }
  }
}

// One block per (b, head): out = sum_s acc_s w_s / sum_s l_s w_s with
// w_s = 2^(m_s - M) over row b's live splits (the split kernel writes no
// others); a split with m = -inf (no live token) is skipped.
__global__ void __launch_bounds__(kCombineThreads) mla_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    bf16* __restrict__ out, int n_splits, const int* __restrict__ lengths,
    int H, int tps, int cap, int T_) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[kCombineThreads / 32];
  const int64_t bh = blockIdx.x;
  const int n =
      min(n_splits, live_splits_of(lengths[bh / H], tps, cap, T_, 0));
  const float* ml = part_ml + 2 * bh * n_splits;
  float M = -INFINITY;
  for (int s = threadIdx.x; s < n; s += kCombineThreads)
    M = fmaxf(M, ml[2 * s]);
  M = block_reduce<kCombineThreads>(M, red, true);
  float L = 0.f;
  for (int s = threadIdx.x; s < n; s += kCombineThreads) {
    const float m = ml[2 * s];
    const float w = m == -INFINITY ? 0.f : exp2f(m - M);
    w_s[s] = w;
    L = fmaf(ml[2 * s + 1], w, L);
  }
  // its barriers publish w_s too
  L = block_reduce<kCombineThreads>(L, red, false);
  const float inv = L > 0.f ? 1.f / L : 0.f;  // length-0 rows -> 0
  const float* acc = part_acc + bh * n_splits * kDV;
  for (int d = threadIdx.x; d < kDV; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = w_s[s];
      if (w != 0.f) a = fmaf(acc[(int64_t)s * kDV + d], w, a);
    }
    out[bh * kDV + d] = __float2bfloat16(a * inv);
  }
}

}  // namespace

// q [B, H, 576] and out [B, H, 512], contiguous bf16; pages the rows of
// one layer, row (page p, token t) at pages + p * sp + t * st (elements;
// base and strides 16-byte aligned, each row contiguous); page_table [B,
// MP] and lengths [B] int32.  part_acc [B * H * n_splits * 512] and
// part_ml [B * H * n_splits * 2] are f32 scratch.  Split s of a row takes
// its page-table columns [s * pages_per_split, (s + 1) * pages_per_split).
// Returns a cudaError_t (0 on success).
extern "C" int mla_decode_launch(const void* q, const void* pages,
                                 const void* page_table, const void* lengths,
                                 void* out, void* part_acc, void* part_ml,
                                 int B, int H, int T, int MP, int n_splits,
                                 int pages_per_split, int64_t sp, int64_t st,
                                 float scale, int sm_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || T < 1 || MP < 1 || n_splits < 1 ||
      n_splits > kMaxSplits || pages_per_split < 1 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  static int per_sm = 0;
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mla_decode_split_kernel, kThreads, kSmem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const int64_t most =
      (int64_t)B * n_splits * ((H + kHeads - 1) / kHeads);
  const int blocks = (int)std::max<int64_t>(
      1, std::min<int64_t>(most, (int64_t)sm_count * std::max(1, per_sm)));
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  mla_decode_split_kernel<<<blocks, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pages),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      acc, ml, B, H, T, MP, n_splits, pages_per_split, sp, st,
      scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_decode_combine_kernel<<<B * H, kCombineThreads, 0, s>>>(
      acc, ml, static_cast<bf16*>(out), n_splits,
      static_cast<const int*>(lengths), H, pages_per_split * T, MP * T, T);
  return (int)cudaGetLastError();
}

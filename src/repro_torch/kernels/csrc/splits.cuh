// The split plans of the paged decode kernels (paged_attention.cu,
// mla_decode.cu): a row's live splits counted on the card from its length,
// the batch's split number c located by a warp scan, and a block-wide
// reduction for the kernels that combine a row's splits.  A split is
// pages_per_split pages (tps tokens) of a row's page table, which holds
// cap = MP * T tokens; a window W > 0 starts a row of n tokens at its key
// n - W, and its splits at the page that holds that key.
// Included after common.cuh; cuda_build hashes every header into every
// library's name.

#pragma once

namespace {

// The first key a row of len tokens attends under a window (0: none).
__device__ __forceinline__ int window_lo(int len, int window) {
  return window > 0 ? max(0, len - window) : 0;
}

// The first token of the page that holds window_lo: where the row's first
// split starts.
__device__ __forceinline__ int window_base(int len, int T_, int window) {
  return window_lo(len, window) / T_ * T_;
}

// A row's live splits: ceil((min(len, cap) - base) / tps), cap = MP * T
// the page table's tokens, tps = pages_per_split * T, base its window's
// first page's first token (0 without a window).
__device__ __forceinline__ int live_splits_of(int len, int tps, int cap,
                                              int T_, int window) {
  if (len <= 0) return 0;
  return max(0, min(len, cap) - window_base(len, T_, window) + tps - 1) / tps;
}

// A reduction over the block's kThreads threads (max or sum), in every
// thread.
template <int kThreads>
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

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The batch's live splits, in every lane of the calling warp.
__device__ __forceinline__ int batch_live_splits(const int* lengths, int B,
                                                 int tps, int cap, int T_,
                                                 int window, int lane) {
  int n = 0;
  for (int b = lane; b < B; b += 32)
    n += live_splits_of(lengths[b], tps, cap, T_, window);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  return n;
}

// Row b and split s of the batch's live split number rc (rows in order,
// each row's live splits in order), in every lane of the calling warp.
__device__ __forceinline__ void locate_split(const int* lengths, int B,
                                             int tps, int cap, int T_,
                                             int window, int rc, int lane,
                                             int& b, int& s) {
  int base = 0;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int n = b0 + lane < B ? live_splits_of(lengths[b0 + lane], tps, cap,
                                                 T_, window)
                                : 0;
    const int inc = warp_inclusive_sum(n, lane);
    const unsigned hit = __ballot_sync(0xffffffffu, base + inc > rc);
    if (hit) {
      const int f = __ffs(hit) - 1;
      b = b0 + f;
      s = rc - base - __shfl_sync(0xffffffffu, inc - n, f);
      return;
    }
    base += __shfl_sync(0xffffffffu, inc, 31);
  }
  b = s = 0;  // rc is past the live splits: not reached
}

}  // namespace

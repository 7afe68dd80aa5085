// RWKV-6 WKV scan for Hopper (sm_90a), plain C interface: the chunked form
// on TF32 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:
// rwkv6_scan (body _wkv_kernel).  Per (batch, head), with an f32 [N, N]
// state S (row n: key dim, column m: value dim):
//
//   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// on r, k, v [B, S, H, N] (f32 or bf16, computed in f32), w [B, S, H, N]
// f32 (clamped at FLT_MIN, the floor the TPU kernel means by its 1e-38
// before the log), u [H, N] f32 and state [B, H, N, N] f32, giving out
// [B, S, H, N] f32 and the final state [B, H, N, N] f32.  Any S >= 1; N one
// of 16, 32, 64.
//
// What bounds it on the card: at the full-width prefill (B 1, S 256, H 64,
// N 64) the function moves 16.8 MB, each input read once and each output
// written once (0.00501 ms at 3.35 TB/s), and does 5 N^2 + 4 N operations
// per token and head (0.00507 ms at the 67 TFLOP/s of f32 on CUDA cores):
// the two bounds meet.  The first port walked the 256 tokens one after
// another in each of 256 blocks of two warps, a chain of dependent FMAs and
// shuffles per token: bound by latency, at 17x the bound.
//
// Design.  The chunked form turns the serial walk into S / 64 steps of
// 64-token chunks, and most of each step into matrix products on tensor
// cores.  One block of 512 threads (16 warps, one block per SM) per (b, h,
// group of C value columns); the groups per head (N / C: 1, 2 or 4) come
// from a host-side plan (rwkv6_scan.scan_plan) that reads B * H and the
// SM count, never the data: 2 at full width, 128 blocks in one wave.  The
// group's C columns of the state stay in shared memory from chunk to
// chunk; the only final write is state'.  Per chunk, in four sub-chunks of
// 16 tokens, three phases between barriers:
//  1. decays as running products of w, so that no factor exceeds the
//     largest w and none is taken as a difference of prefix sums (a zero
//     in w adds about -87 to a prefix sum of log w): per sub-chunk the
//     exclusive prefix product pe[t], the exclusive suffix product q[s]
//     and the total Tot; RP = r * pe, KQ = k * q, and the same restarted at
//     the sub-chunk's half (RP8 over its second 8 tokens, KQ8 over its
//     first), to shared memory.  Half of the block does this, one
//     (sub-chunk, key) each, while the other half starts the next chunk's
//     copies;
//  2. the scores, s <= t, on the diagonal 16x16 blocks in three pieces:
//     the two 8x8 triangles (decay prod_{s<j<t} w_j as a running product
//     from s to t, the bonus r_t . (u * k_t) on the diagonal) on CUDA cores
//     by all threads, a warp per (sub-chunk, four s), the warps of the
//     triangles' long and short stretches spread over the four schedulers;
//     the 8x8 block below them, RP8 . KQ8^T, on tensor cores.  The six
//     off-diagonal blocks (t in sub-chunk i, s in j < i),
//     RP_i . (KQ_j * prod_{j<m<i} Tot_m)^T, 16x16 over N on tensor cores.
//     Beside them the carry, S' = diag(prod_m Tot_m) S +
//     (KQ * prod_{m>j} Tot_m)^T v, into registers;
//  3. out = (RP_i * prod_{m<i} Tot_m) S + scores v on tensor cores, one
//     (sub-chunk, 8 columns) per warp, the sub-chunks rotated over the
//     schedulers so the triangle's work balances; after a barrier the
//     carry replaces S.
// Where the design notes of this kernel speak of exponents, the products
// are the same factors: exp(sum of log w) over the same tokens.
//
// Tensor cores in split TF32: mma.sync m16n8k8 .tf32 with f32
// accumulators.  An f32 operand a is split into hi, a rounded to TF32, and
// lo = a - hi, which the tensor cores truncate to TF32; a product takes
// hi.hi + hi.lo + lo.hi, three MMAs into three accumulators (so that they
// do not wait on each other), within about 2^-21 of f32 per term (one
// TF32 pass keeps about three decimal digits and would break the 2e-4
// check).  bf16 v is exact in TF32, so a product against it takes two
// MMAs.  One kernel, templated on the input type, serves both dtypes.
//
// The next chunk's r, k, w and the group's columns of v are copied into a
// second shared-memory buffer by 16-byte cp.async while this chunk
// computes; a ragged last chunk is zero-filled by the copies (w is read as
// 1 there) and its padded rows are never written.  Four __syncthreads per
// chunk.  Shared rows are padded so that the mma fragment loads are free
// of bank conflicts, except the transposed KQ reads of the carry
// (two-way).

#include <float.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;                            // tokens per chunk
constexpr int kSub = 16;                          // tokens per sub-chunk
constexpr int kNSub = kT / kSub;                  // 4
constexpr int kHalf = kSub / 2;                   // 8
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDecayThreads = kThreads / 2;  // phase 1's decays; the rest copy
constexpr int kOffDiag = kNSub * (kNSub - 1) / 2;  // 6 score blocks j < i

// m16n8k8 operands, each split as x = hi + lo with hi and lo in TF32
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna rounds a finite x, in two integer operations where cvt.rna
// takes four), lo the remainder, exact in f32.  The tensor cores read the
// top 19 bits of a .tf32 register, so lo enters truncated to TF32: within
// 2^-21 of x.
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {  // x is already a TF32 value (a widened bf16)
    hi = __float_as_uint(x);
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32, each term in an accumulator of its own so that
// the MMAs of one k step do not wait on each other: d.t[0] += lo.hi,
// d.t[1] += hi.lo (not when b is exact), d.t[2] += hi.hi
struct Acc3 {
  float t[3][4];
};

template <bool kExactB>
__device__ __forceinline__ void mma3(Acc3& d, const FragA& a,
                                     const FragB& b) {
  mma_tf32(d.t[0], a.lo, b.hi[0], b.hi[1]);
  if (!kExactB) mma_tf32(d.t[1], a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d.t[2], a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void zero(Acc3& d) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d.t[j][e] = 0.f;
}

// the product, the small terms added first
__device__ __forceinline__ float total(const Acc3& d, int e) {
  return (d.t[0][e] + d.t[1][e]) + d.t[2][e];
}

// four consecutive values from shared memory, widened to f32
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16);
  f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16);
  f[3] = __uint_as_float(x.y & 0xffff0000u);
}

// Reduce-scatter of v[L] over the lanes whose index differs in the bits
// M, 2M, .. below kParts: each level keeps half of the values, summed with
// the partner's other half.  The lane ends with the sums of the values at
// offset sum_m (lane & m ? L_m / 2 : 0) + e, where L_m is the count before
// level m; it writes them through out(t, sum).
template <int L, int M, int kParts, typename Out>
__device__ __forceinline__ void reduce_scatter(const float (&v)[L], int part,
                                               int off, Out out) {
  if constexpr (M >= kParts) {
#pragma unroll
    for (int e = 0; e < L; ++e) out(off + e, v[e]);
  } else {
    constexpr int H = L / 2;
    const bool up = part & M;
    float h[H];
#pragma unroll
    for (int e = 0; e < H; ++e) {
      const float keep = up ? v[e + H] : v[e];
      const float send = up ? v[e] : v[e + H];
      h[e] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    reduce_scatter<H, 2 * M, kParts>(h, part, off + (up ? H : 0), out);
  }
}

// Dynamic shared memory of one block, byte offsets.  Two stages of the
// chunk's inputs as they arrive (r, k, w [kT][N]; v [kT][kVld]), then the
// f32 working set: RP, KQ [kT][kLd], the chunk's scores [kT][kSld], the
// state's columns [N][kVld], Tot [kNSub][N], u [N], and RP8, KQ8
// [kNSub][kHalf][kLd] (second-half rows of RP, first-half rows of KQ, with
// the decays restarted at the half).
template <typename T, int N, int C>
struct Layout {
  static constexpr int kLd = N + 4;    // A/B fragment rows: 4 g + q banks
  static constexpr int kVld = C + 8;   // v and state rows: 8 q + g banks
  static constexpr int kSld = kT + 4;  // score rows
  static constexpr int kRBytes = kT * N * (int)sizeof(T);
  static constexpr int kWBytes = kT * N * 4;
  static constexpr int kVBytes = kT * kVld * (int)sizeof(T);
  static constexpr int kStage = 2 * kRBytes + kWBytes + kVBytes;
  static constexpr int kRP = 2 * kStage;
  static constexpr int kKQ = kRP + kT * kLd * 4;
  static constexpr int kScore = kKQ + kT * kLd * 4;
  static constexpr int kState = kScore + kT * kSld * 4;
  static constexpr int kTot = kState + N * kVld * 4;
  static constexpr int kU = kTot + kNSub * N * 4;
  static constexpr int kRP8 = kU + N * 4;
  static constexpr int kKQ8 = kRP8 + kNSub * kHalf * kLd * 4;
  static constexpr int kBytes = kKQ8 + kNSub * kHalf * kLd * 4;
  static_assert(kVBytes % 16 == 0 && kStage % 16 == 0,
                "cp.async needs 16-byte aligned rows and stages");
  static_assert(kBytes <= 232448, "over the 227 KB a block can have");
  static_assert(kNSub * N <= kDecayThreads, "a thread per (sub-chunk, key)");
};

// The threads [kDecayThreads, kThreads) start the copies of one chunk
// (tokens [t0, t0 + nt)) into a stage; rows past nt are zero-filled.
template <typename T, int N, int C>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const T* r,
                                            const T* k, const T* v,
                                            const float* w, int64_t base,
                                            int64_t tok, int col0, int t0,
                                            int nt) {
  constexpr int kCopiers = kThreads - kDecayThreads;
  using L = Layout<T, N, C>;
  constexpr int kRow = N * (int)sizeof(T) / 16;  // 16-byte pieces per row
  constexpr int kWRow = N * 4 / 16;
  constexpr int kVRow = C * (int)sizeof(T) / 16;
  const uint32_t rs = smem_addr(dst);
  const uint32_t ks = rs + L::kRBytes;
  const uint32_t ws = ks + L::kRBytes;
  const uint32_t vs = ws + L::kWBytes;
  const int tid = threadIdx.x - kDecayThreads;
  for (int i = tid; i < kT * kRow; i += kCopiers) {
    const int t = i / kRow, p = i % kRow;
    const bool in = t < nt;
    const int64_t off = base + (int64_t)(t0 + (in ? t : 0)) * tok;
    cp_async16(rs + i * 16, reinterpret_cast<const char*>(r + off) + p * 16,
               in);
    cp_async16(ks + i * 16, reinterpret_cast<const char*>(k + off) + p * 16,
               in);
  }
  for (int i = tid; i < kT * kWRow; i += kCopiers) {
    const int t = i / kWRow, p = i % kWRow;
    const bool in = t < nt;
    const int64_t off = base + (int64_t)(t0 + (in ? t : 0)) * tok;
    cp_async16(ws + i * 16, reinterpret_cast<const char*>(w + off) + p * 16,
               in);
  }
  for (int i = tid; i < kT * kVRow; i += kCopiers) {
    const int t = i / kVRow, p = i % kVRow;
    const bool in = t < nt;
    const int64_t off = base + (int64_t)(t0 + (in ? t : 0)) * tok + col0;
    cp_async16(vs + t * L::kVld * (int)sizeof(T) + p * 16,
               reinterpret_cast<const char*>(v + off) + p * 16, in);
  }
}

template <typename T, int N, int C>
__global__ void __launch_bounds__(kThreads, 1)
    rwkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ w,
                         const float* __restrict__ u,
                         const float* __restrict__ s0,
                         float* __restrict__ out, float* __restrict__ s_out,
                         int S, int H) {
  using L = Layout<T, N, C>;
  constexpr int kLd = L::kLd, kVld = L::kVld, kSld = L::kSld;
  constexpr bool kExactV = sizeof(T) == 2;  // bf16 v is exact in TF32
  constexpr int kCarry = (N / 16) * (C / 8);  // 16x8 tiles of the state
  constexpr int kCarryPerWarp = (kCarry + kWarps - 1) / kWarps;
  constexpr int kOut = kNSub * (C / 8);  // (sub-chunk, 8 columns)
  extern __shared__ __align__(16) unsigned char smem[];
  float* RP = reinterpret_cast<float*>(smem + L::kRP);
  float* KQ = reinterpret_cast<float*>(smem + L::kKQ);
  float* Sc = reinterpret_cast<float*>(smem + L::kScore);
  float* St = reinterpret_cast<float*>(smem + L::kState);
  float* Tot = reinterpret_cast<float*>(smem + L::kTot);
  float* us = reinterpret_cast<float*>(smem + L::kU);
  float* RP8 = reinterpret_cast<float*>(smem + L::kRP8);
  float* KQ8 = reinterpret_cast<float*>(smem + L::kKQ8);

  const int grp = blockIdx.x % (N / C);
  const int bh = blockIdx.x / (N / C);
  const int h = bh % H;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;  // mma fragment row / column
  const int q4 = lane & 3;   // mma fragment k index

  const int64_t tok = (int64_t)H * N;  // stride of one token
  const int64_t base = (int64_t)b * S * tok + (int64_t)h * N;
  const int col0 = grp * C;
  const int nc = (S + kT - 1) / kT;

  if (tid >= kDecayThreads) {
    stage_chunk<T, N, C>(smem, r, k, v, w, base, tok, col0, 0, min(kT, S));
    cp_async_commit();
  }
  const float* s0b = s0 + (int64_t)bh * N * N;
  for (int i = tid; i < N * C; i += kThreads) {
    const int n = i / C, m = i % C;
    St[n * kVld + m] = s0b[n * N + col0 + m];
  }
  for (int i = tid; i < N; i += kThreads) us[i] = u[h * N + i];

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kT;
    const int nt = min(kT, S - t0);
    cp_async_wait<0>();  // this chunk, started in the last one's phase 1
    __syncthreads();
    unsigned char* cur = smem + (c & 1) * L::kStage;
    const T* rs = reinterpret_cast<const T*>(cur);
    const T* ks = reinterpret_cast<const T*>(cur + L::kRBytes);
    float* ws = reinterpret_cast<float*>(cur + 2 * L::kRBytes);
    const T* vs =
        reinterpret_cast<const T*>(cur + 2 * L::kRBytes + L::kWBytes);

    // ---- 1. decays of one (sub-chunk i, key n): RP, KQ, RP8, KQ8 and
    // Tot, and w clamped in place (1 past the chunk's end) for 2a (the
    // loads first: the stores could alias them for all the compiler
    // knows); meanwhile the other half of the block starts the copies of
    // the next chunk
    if (tid >= kDecayThreads) {
      // the next chunk into the other stage, last read in chunk c - 1
      // before its last barrier
      if (c + 1 < nc) {
        stage_chunk<T, N, C>(smem + ((c + 1) & 1) * L::kStage, r, k, v, w,
                             base, tok, col0, t0 + kT,
                             min(kT, S - t0 - kT));
        cp_async_commit();
      }
    } else if (tid < kNSub * N) {
      const int i = tid / N, n = tid % N;
      float wv[kSub], rv[kSub], kv[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int tt = i * kSub + t;
        wv[t] = tt < nt ? fmaxf(ws[tt * N + n], FLT_MIN) : 1.f;
        rv[t] = to_f32(rs[tt * N + n]);
        kv[t] = to_f32(ks[tt * N + n]);
      }
      float p = 1.f, p8 = 1.f;  // from the sub-chunk's start, its half's
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        RP[(i * kSub + t) * kLd + n] = rv[t] * p;
        if (t >= kHalf)
          RP8[(i * kHalf + t - kHalf) * kLd + n] = rv[t] * p8;
        ws[(i * kSub + t) * N + n] = wv[t];
        p *= wv[t];
        if (t >= kHalf) p8 *= wv[t];
      }
      Tot[i * N + n] = p;
      float q = 1.f, q8 = 1.f;  // to the sub-chunk's end, the half's
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t) {
        KQ[(i * kSub + t) * kLd + n] = kv[t] * q;
        if (t < kHalf) KQ8[(i * kHalf + t) * kLd + n] = kv[t] * q8;
        q *= wv[t];
        if (t < kHalf) q8 *= wv[t];
      }
    }

    __syncthreads();

    // ---- 2a. the diagonal 8x8 blocks of the score (s <= t in one half of
    // a sub-chunk) on CUDA cores: thread (i, s, part) holds k_s decayed
    // from s to t for n = 4 (kParts jj + part) + e and sums its share of
    // the score for every t of its half; the shares meet in a
    // reduce-scatter over the kParts lanes.  Warp w takes sub-chunk w % 4
    // and kS values of s from kS (w / 4) on, so each scheduler (w % 4) has
    // one warp of each stretch of the triangles; a warp skips the t before
    // its first s and past its half.  The block's zeros above the diagonal
    // are written here too; the 8x8 block below it (t in the second half,
    // s in the first) is 2b's
    {
      constexpr int kParts = N >= 32 ? 8 : 4;  // lanes sharing one s
      constexpr int kS = 32 / kParts;          // values of s per warp
      constexpr int kJ = N / (4 * kParts);     // 4-wide pieces per thread
      if (warp < kNSub * kSub / kS) {
        const int i = warp & 3;
        const int s_lo = (warp >> 2) * kS;
        const int s = s_lo + lane / kParts;
        const int part = lane % kParts;
        const int ss = i * kSub + s;
        const int t_end = s_lo < kHalf ? kHalf : kSub;
        float kd[kJ][4];
        float bonus = 0.f;  // r_s . (u * k_s), the diagonal
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int n = 4 * (kParts * jj + part);
          float rv[4];
          load4(ks + ss * N + n, kd[jj]);
          load4(rs + ss * N + n, rv);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            bonus = fmaf(rv[e], us[n + e] * kd[jj][e], bonus);
        }
        float sc[kSub];
#pragma unroll
        for (int t = 0; t < kSub; ++t) {
          sc[t] = 0.f;
          if (t < s_lo || t >= t_end) continue;  // for the whole warp
          const int tt = i * kSub + t;
          const bool live = t > s;
          float sum = 0.f;
#pragma unroll
          for (int jj = 0; jj < kJ; ++jj) {
            const int n = 4 * (kParts * jj + part);
            float rv[4], wt[4];
            load4(rs + tt * N + n, rv);
            load4(ws + tt * N + n, wt);
            float acc = rv[0] * kd[jj][0];
#pragma unroll
            for (int e = 1; e < 4; ++e) acc = fmaf(rv[e], kd[jj][e], acc);
            sum += acc;
#pragma unroll
            for (int e = 0; e < 4; ++e) kd[jj][e] *= live ? wt[e] : 1.f;
          }
          sc[t] = live ? sum : (t == s ? bonus : 0.f);  // 0 above
        }
        reduce_scatter<kSub, 1, kParts>(sc, part, 0, [&](int t, float x) {
          if (t < t_end) Sc[(i * kSub + t) * kSld + ss] = x;
        });
      }
    }

    // ---- 2b. the 8x8 block below the diagonal of each sub-chunk's
    // 16x16 block, t in its second half and s in its first: RP8 . KQ8^T on
    // tensor cores, one warp per sub-chunk (the m16 tile's rows 8..15 are
    // zeros and their results dropped)
    if (warp >= 2 * kOffDiag && warp < 2 * kOffDiag + kNSub) {
      const int i = warp - 2 * kOffDiag;
      const float* A = RP8 + i * kHalf * kLd;
      const float* Bm = KQ8 + i * kHalf * kLd;
      Acc3 acc;
      zero(acc);
#pragma unroll
      for (int kb = 0; kb < N; kb += 8) {
        FragA a;
        split<false>(A[g8 * kLd + kb + q4], a.hi[0], a.lo[0]);
        split<false>(A[g8 * kLd + kb + q4 + 4], a.hi[2], a.lo[2]);
        a.hi[1] = a.lo[1] = a.hi[3] = a.lo[3] = 0u;
        FragB bf;
        split<false>(Bm[g8 * kLd + kb + q4], bf.hi[0], bf.lo[0]);
        split<false>(Bm[g8 * kLd + kb + q4 + 4], bf.hi[1], bf.lo[1]);
        mma3<false>(acc, a, bf);
      }
      *reinterpret_cast<float2*>(
          Sc + (i * kSub + kHalf + g8) * kSld + i * kSub + 2 * q4) =
          make_float2(total(acc, 0), total(acc, 1));
    }

    // ---- 2c. off-diagonal score blocks (i, j), j < i: warp 2 p + nb
    // takes 8 columns nb of block p
    if (warp < 2 * kOffDiag) {
      const int pr = warp >> 1, nb = warp & 1;
      const int i = pr < 1 ? 1 : (pr < 3 ? 2 : 3);
      const int j = pr - i * (i - 1) / 2;
      const float* A = RP + i * kSub * kLd;
      const float* Bm = KQ + (j * kSub + nb * 8) * kLd;
      Acc3 acc;
      zero(acc);
#pragma unroll
      for (int kb = 0; kb < N; kb += 8) {
        float f0 = 1.f, f1 = 1.f;  // prod_{j<m<i} Tot_m at n = kb+q4, +4
#pragma unroll
        for (int m = 1; m < kNSub - 1; ++m) {
          if (m > j && m < i) {
            f0 *= Tot[m * N + kb + q4];
            f1 *= Tot[m * N + kb + q4 + 4];
          }
        }
        FragA a;
        split<false>(A[g8 * kLd + kb + q4], a.hi[0], a.lo[0]);
        split<false>(A[(g8 + 8) * kLd + kb + q4], a.hi[1], a.lo[1]);
        split<false>(A[g8 * kLd + kb + q4 + 4], a.hi[2], a.lo[2]);
        split<false>(A[(g8 + 8) * kLd + kb + q4 + 4], a.hi[3], a.lo[3]);
        FragB bf;
        split<false>(Bm[g8 * kLd + kb + q4] * f0, bf.hi[0], bf.lo[0]);
        split<false>(Bm[g8 * kLd + kb + q4 + 4] * f1, bf.hi[1], bf.lo[1]);
        mma3<false>(acc, a, bf);
      }
      float* o = Sc + i * kSub * kSld + j * kSub + nb * 8 + 2 * q4;
      *reinterpret_cast<float2*>(o + g8 * kSld) =
          make_float2(total(acc, 0), total(acc, 1));
      *reinterpret_cast<float2*>(o + (g8 + 8) * kSld) =
          make_float2(total(acc, 2), total(acc, 3));
    }

    // ---- 2d. the carry into registers: diag(prod Tot) S + KC^T v, where
    // KC[s] = KQ[s] * prod_{m>j(s)} Tot_m; tile x = (rows 16 mt.., cols
    // 8 nt..) of the state
    Acc3 cacc[kCarryPerWarp];
#pragma unroll
    for (int x = 0; x < kCarryPerWarp; ++x) {
      const int it = warp + x * kWarps;
      if (it >= kCarry) break;
      const int mt = it / (C / 8), nt8 = (it % (C / 8)) * 8;
      const int n0 = mt * 16 + g8, n1 = n0 + 8;
      float e0[kNSub], e1[kNSub];  // prod_{m>j} Tot_m for j = 0..3
      e0[kNSub - 1] = 1.f;
      e1[kNSub - 1] = 1.f;
#pragma unroll
      for (int j = kNSub - 2; j >= 0; --j) {
        e0[j] = e0[j + 1] * Tot[(j + 1) * N + n0];
        e1[j] = e1[j + 1] * Tot[(j + 1) * N + n1];
      }
      const float p0 = e0[0] * Tot[n0], p1 = e1[0] * Tot[n1];
      zero(cacc[x]);
      cacc[x].t[2][0] = St[n0 * kVld + nt8 + 2 * q4] * p0;
      cacc[x].t[2][1] = St[n0 * kVld + nt8 + 2 * q4 + 1] * p0;
      cacc[x].t[2][2] = St[n1 * kVld + nt8 + 2 * q4] * p1;
      cacc[x].t[2][3] = St[n1 * kVld + nt8 + 2 * q4 + 1] * p1;
#pragma unroll
      for (int kb = 0; kb < kT; kb += 8) {
        const int j = kb / kSub;
        FragA a;
        split<false>(KQ[(kb + q4) * kLd + n0] * e0[j], a.hi[0], a.lo[0]);
        split<false>(KQ[(kb + q4) * kLd + n1] * e1[j], a.hi[1], a.lo[1]);
        split<false>(KQ[(kb + q4 + 4) * kLd + n0] * e0[j], a.hi[2],
                     a.lo[2]);
        split<false>(KQ[(kb + q4 + 4) * kLd + n1] * e1[j], a.hi[3],
                     a.lo[3]);
        FragB bf;
        split<kExactV>(to_f32(vs[(kb + q4) * kVld + nt8 + g8]), bf.hi[0],
                       bf.lo[0]);
        split<kExactV>(to_f32(vs[(kb + q4 + 4) * kVld + nt8 + g8]),
                       bf.hi[1], bf.lo[1]);
        mma3<kExactV>(cacc[x], a, bf);
      }
    }
    __syncthreads();

    // ---- 3. out = (RP_i * prod_{m<i} Tot_m) S + scores v for one
    // (sub-chunk i, 8-column tile) per item, i rotated so that each
    // scheduler (warp % 4) gets every i
    for (int it = warp; it < kOut; it += kWarps) {
      const int nt8 = (it >> 2) * 8;
      const int i = (it + (it >> 2)) & 3;
      const float* A = RP + i * kSub * kLd;
      Acc3 acc;
      zero(acc);
#pragma unroll
      for (int kb = 0; kb < N; kb += 8) {
        float f0 = 1.f, f1 = 1.f;  // prod_{m<i} Tot_m at n = kb+q4, +4
#pragma unroll
        for (int m = 0; m < kNSub - 1; ++m) {
          if (m < i) {
            f0 *= Tot[m * N + kb + q4];
            f1 *= Tot[m * N + kb + q4 + 4];
          }
        }
        FragA a;
        split<false>(A[g8 * kLd + kb + q4] * f0, a.hi[0], a.lo[0]);
        split<false>(A[(g8 + 8) * kLd + kb + q4] * f0, a.hi[1], a.lo[1]);
        split<false>(A[g8 * kLd + kb + q4 + 4] * f1, a.hi[2], a.lo[2]);
        split<false>(A[(g8 + 8) * kLd + kb + q4 + 4] * f1, a.hi[3],
                     a.lo[3]);
        FragB bf;
        split<false>(St[(kb + q4) * kVld + nt8 + g8], bf.hi[0], bf.lo[0]);
        split<false>(St[(kb + q4 + 4) * kVld + nt8 + g8], bf.hi[1],
                     bf.lo[1]);
        mma3<false>(acc, a, bf);
      }
      const float* P = Sc + i * kSub * kSld;
#pragma unroll
      for (int kb = 0; kb < kT; kb += 8) {
        if (kb < (i + 1) * kSub) {
          FragA a;
          split<false>(P[g8 * kSld + kb + q4], a.hi[0], a.lo[0]);
          split<false>(P[(g8 + 8) * kSld + kb + q4], a.hi[1], a.lo[1]);
          split<false>(P[g8 * kSld + kb + q4 + 4], a.hi[2], a.lo[2]);
          split<false>(P[(g8 + 8) * kSld + kb + q4 + 4], a.hi[3], a.lo[3]);
          FragB bf;
          split<kExactV>(to_f32(vs[(kb + q4) * kVld + nt8 + g8]), bf.hi[0],
                         bf.lo[0]);
          split<kExactV>(to_f32(vs[(kb + q4 + 4) * kVld + nt8 + g8]),
                         bf.hi[1], bf.lo[1]);
          mma3<kExactV>(acc, a, bf);
        }
      }
      const int row = i * kSub + g8;
      float* o =
          out + base + (int64_t)(t0 + row) * tok + col0 + nt8 + 2 * q4;
      if (row < nt)
        *reinterpret_cast<float2*>(o) =
            make_float2(total(acc, 0), total(acc, 1));
      if (row + 8 < nt)
        *reinterpret_cast<float2*>(o + 8 * tok) =
            make_float2(total(acc, 2), total(acc, 3));
    }
    __syncthreads();

    // the carry replaces the state, or is state' after the last chunk
    float* dst = c + 1 < nc ? St : s_out + (int64_t)bh * N * N + col0;
    const int ld = c + 1 < nc ? kVld : N;
#pragma unroll
    for (int x = 0; x < kCarryPerWarp; ++x) {
      const int it = warp + x * kWarps;
      if (it >= kCarry) break;
      const int n0 = (it / (C / 8)) * 16 + g8;
      const int m = (it % (C / 8)) * 8 + 2 * q4;
      *reinterpret_cast<float2*>(dst + n0 * ld + m) =
          make_float2(total(cacc[x], 0), total(cacc[x], 1));
      *reinterpret_cast<float2*>(dst + (n0 + 8) * ld + m) =
          make_float2(total(cacc[x], 2), total(cacc[x], 3));
    }
  }
}

template <typename T, int N, int C>
cudaError_t launch_nc(const void* r, const void* k, const void* v,
                      const float* w, const float* u, const float* s0,
                      float* out, float* s_out, int B, int S, int H,
                      cudaStream_t stream) {
  constexpr int smem = Layout<T, N, C>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv6_chunked_kernel<T, N, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)B * H * (N / C));
  rwkv6_chunked_kernel<T, N, C><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, out, s_out, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   float* out, float* s_out, int B, int S, int H, int N,
                   int groups, cudaStream_t stream) {
#define RWKV6_CASE(n, g)                                                  \
  if (N == n && groups == g)                                              \
    return launch_nc<T, n, n / g>(r, k, v, w, u, s0, out, s_out, B, S, H, \
                                  stream);
  RWKV6_CASE(16, 1)
  RWKV6_CASE(32, 1)
  RWKV6_CASE(32, 2)
  RWKV6_CASE(64, 1)
  RWKV6_CASE(64, 2)
  RWKV6_CASE(64, 4)
#undef RWKV6_CASE
  return cudaErrorInvalidValue;
}

template <typename T>
int smem_bytes(int N, int groups) {
#define RWKV6_CASE(n, g) \
  if (N == n && groups == g) return Layout<T, n, n / g>::kBytes;
  RWKV6_CASE(16, 1)
  RWKV6_CASE(32, 1)
  RWKV6_CASE(32, 2)
  RWKV6_CASE(64, 1)
  RWKV6_CASE(64, 2)
  RWKV6_CASE(64, 4)
#undef RWKV6_CASE
  return -1;
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16.  All tensors contiguous,
// r, k, v and w on 16-byte boundaries; N one of 16, 32, 64; groups (value
// column groups per head, one block each) 1..N/16, a power of two; S >= 1.
// Returns a cudaError_t (0 on success).
extern "C" int rwkv6_scan_launch(int dtype, const void* r, const void* k,
                                 const void* v, const void* w, const void* u,
                                 const void* s0, void* out, void* s_out,
                                 int B, int S, int H, int N, int groups,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* of = static_cast<float*>(out);
  float* sof = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, of, sof, B, S, H, N, groups,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, of, sof, B, S, H, N,
                                 groups, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of the (dtype, N, groups) kernel
// takes, in bytes; -1 for a shape it is not built for.
extern "C" int rwkv6_scan_smem_bytes(int dtype, int N, int groups) {
  if (dtype == 0) return smem_bytes<float>(N, groups);
  if (dtype == 1) return smem_bytes<__nv_bfloat16>(N, groups);
  return -1;
}

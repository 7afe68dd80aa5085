// Held experts' SwiGLU products over their routed rows, for Hopper
// (sm_90a), plain C interface.
//
// Replaces no Pallas kernel (see kernels/expert_ffn.py): on one chip of an
// expert-parallel deployment, for every (token, choice) pair routed to a
// held expert e, gate * w_down[e](silu(x w_gate[e]) * x w_up[e]), summed
// per token.
//
// What bounds it on the card: bytes at decode, both near the ridge at a
// prompt.  A held expert's three matrices (3 x 6144 x 2048 bf16 = 75.5 MB
// at K-EXAONE's widths) serve the ~2 tokens a decode step routes to it,
// one to two flops a byte; a 2,048-token prompt gives it ~128 rows.  So a
// block takes one row tile of one expert (all its rows where they fit one
// tile) and one column tile of the output, and reads its columns of the
// expert's weights once.
//
// Four kernels, grids static in the call's shape (a CUDA graph replays
// them for any routing):
// * expert_sort_kernel (one block): the pairs sorted by held expert, the
//   pairs not held last: for sorted row r the pair it holds (order[r] =
//   token * K + choice), each held expert's first row (offs[0..held]),
//   each pair's row (slot) and expert (key).
// * expert_gate_up_kernel<Tile>: a block takes one row tile of one
//   expert and one column tile of d_ff, found by a walk over offs: tile j
//   of expert e holds its sorted rows [offs[e] + j BM, ...).  The grid has
//   (ceil(rows / BM) + held) x d_ff / BN blocks, enough for any routing;
//   the blocks go out by column tile, an expert's row tiles together (its
//   weights' tile read from memory once), and those past the routing's
//   tiles last, leaving at once.  Rows of x are gathered by token.
//   Both products of the column tile in one pass over d_model, as mma.sync
//   m16n8k16 with f32 accumulators: BK-deep stages of x's rows and of both
//   weights' columns come into a ring of shared-memory stages by 16-byte
//   cp.async, rows padded by 16 bytes so every ldmatrix is free of bank
//   conflicts (ldmatrix for x, ldmatrix.trans for the row-major [d_model,
//   d_ff] weights).  silu(g) u in f32, stored as bf16 (the plain version's
//   bf16 activations) in the row's slot of h.
// * expert_down_kernel<Tile>: the same over h's sorted rows and w_down
//   (column tiles of d_model), times each row's gate, in f32 into the
//   row's slot of y.
// * expert_combine_kernel: grid (tokens, column blocks); each token adds
//   the slots of its held pairs in choice order, so the sums are the same
//   on every run (no atomics).
// The tiles (BM rows, BN columns, BK deep, warps, stages) are the fastest
// of a sweep at a decode batch (BM 16: every tile near the bytes' bound,
// 8 warps side by side in the columns) and at prompts of 1,024-2,048
// tokens (BM 128: an expert's ~100 rows in one tile, 2 x 4 warps).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// A block's tile: BM sorted rows by BN columns of each matrix, BK deep a
// stage, WM x WN warps (each BM / WM rows by BN / WN columns), kStages
// stages in the ring.  Rows of a stage are padded by 16 bytes.
template <int BM_, int BN_, int BK_, int WM, int WN, int kStages_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, kStages = kStages_;
  static constexpr int kWarpsM = WM, kWarpsN = WN;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMI = BM / WM / 16;  // m16 tiles a warp
  static constexpr int kNI = BN / WN / 8;   // n8 tiles a warp
  static constexpr int kLdA = BK + 8;
  static constexpr int kLdW = BN + 8;
  static constexpr int kAElems = BM * kLdA;
  static constexpr int kWElems = BK * kLdW;
  static constexpr size_t smem(int nb) {
    return (size_t)kStages * (kAElems + nb * kWElems) * sizeof(bf16);
  }
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0 && BK % 16 == 0,
                "a warp takes whole m16 tiles and pairs of n8 tiles");
};

// One block's tile: rows of expert e's sorted rows times NB matrices'
// C::BN-column tile.  a: x [T, Kd] (kGateUp, rows gathered by token) or h
// [rows, Kd]; w0, w1: [held, Kd, N]; out: h [rows, N] bf16 (kGateUp) or
// y [rows, N] f32.
template <class C, bool kGateUp>
__device__ __forceinline__ void expert_tile(
    const bf16* __restrict__ a, const bf16* __restrict__ w0,
    const bf16* __restrict__ w1, void* __restrict__ out,
    const int* __restrict__ order, const int* __restrict__ offs,
    const float* __restrict__ gates, int held, int Kd, int N, int K) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK;
  constexpr int kLdA = C::kLdA, kLdW = C::kLdW;
  constexpr int NB = kGateUp ? 2 : 1;
  constexpr int kStage = C::kAElems + NB * C::kWElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int64_t a_off[BM];  // a row's offset in a, -1 past the rows
  __shared__ float gate_s[BM];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  // the walk over offs: nt row tiles in all (tile j of expert e holds its
  // sorted rows from offs[e] + j BM); block b takes row tile b % nt of
  // column tile b / nt, so an expert's row tiles of one column tile go
  // out together (its weights' tile is read from memory once) and blocks
  // past nt column tiles' worth leave at once
  int nt = 0;
  for (int j = 0; j < held; ++j) nt += (offs[j + 1] - offs[j] + BM - 1) / BM;
  const int b = blockIdx.x;
  if (b >= nt * (N / BN)) return;
  const int tile = b % nt;
  int e = -1, r0 = 0, r1 = 0;
  {
    int seen = 0;
    for (int j = 0; j < held; ++j) {
      const int lo = offs[j], hi = offs[j + 1];
      const int n = (hi - lo + BM - 1) / BM;
      if (tile < seen + n) {
        e = j;
        r0 = lo + (tile - seen) * BM;
        r1 = min(hi, r0 + BM);
        break;
      }
      seen += n;
    }
  }
  if (e < 0) return;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nrows = r1 - r0;
  for (int i = tid; i < BM; i += C::kThreads) {
    const bool in = i < nrows;
    const int p = in ? order[r0 + i] : 0;
    a_off[i] = !in ? -1 : (int64_t)(kGateUp ? p / K : r0 + i) * Kd;
    if constexpr (!kGateUp) gate_s[i] = in ? gates[p] : 0.f;
  }
  __syncthreads();

  const int n0 = (b / nt) * BN;
  const int64_t wbase = (int64_t)e * Kd * N + n0;
  auto load = [&](int kt, int stage) {
    bf16* as = smem + stage * kStage;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = tid; i < BM * (BK / 8); i += C::kThreads) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int64_t off = a_off[r];
      cp_async16(smem_addr(as + r * kLdA + c), off < 0 ? a : a + off + k0 + c,
                 off >= 0);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const bf16* w = (b == 0 ? w0 : w1) + wbase + (int64_t)k0 * N;
      bf16* ws = as + C::kAElems + b * C::kWElems;
#pragma unroll
      for (int i = tid; i < BK * (BN / 8); i += C::kThreads) {
        const int r = i / (BN / 8);
        const int c = (i % (BN / 8)) * 8;
        cp_async16(smem_addr(ws + r * kLdW + c), w + (int64_t)r * N + c, true);
      }
    }
  };

  const int nk = Kd / BK;
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  float acc[NB][C::kMI][C::kNI][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int mi = 0; mi < C::kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::kNI; ++ni)
        acc[b][mi][ni][0] = acc[b][mi][ni][1] = acc[b][mi][ni][2] =
            acc[b][mi][ni][3] = 0.f;
  const int wrow = (warp / C::kWarpsN) * (BM / C::kWarpsM);
  const int wcol = (warp % C::kWarpsN) * (BN / C::kWarpsN);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::kStages - 2>();  // stage kt has landed
    __syncthreads();                  // and stage kt - 1 is free
    const int next = kt + C::kStages - 1;
    if (next < nk) load(next, next % C::kStages);
    cp_async_commit();
    const bf16* as = smem + (kt % C::kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[C::kMI][4];
#pragma unroll
      for (int mi = 0; mi < C::kMI; ++mi)
        ldmatrix_x4(af[mi], smem_addr(as + (wrow + mi * 16 + (lane & 15)) *
                                               kLdA +
                                      kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const bf16* ws = as + C::kAElems + b * C::kWElems;
#pragma unroll
        for (int nj = 0; nj < C::kNI / 2; ++nj) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(ws + (kk * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8) *
                                                   kLdW +
                                          wcol + nj * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int mi = 0; mi < C::kMI; ++mi) {
            mma_bf16(acc[b][mi][2 * nj], af[mi], bv[0], bv[1]);
            mma_bf16(acc[b][mi][2 * nj + 1], af[mi], bv[2], bv[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // a lane holds rows lane / 4 and lane / 4 + 8 of each m16 tile, columns
  // 2 (lane % 4) and the next of each n8 tile
#pragma unroll
  for (int mi = 0; mi < C::kMI; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wrow + mi * 16 + (lane >> 2) + half * 8;
      if (row >= nrows) continue;
      const int64_t base = (int64_t)(r0 + row) * N + n0 + wcol + 2 * (lane & 3);
#pragma unroll
      for (int ni = 0; ni < C::kNI; ++ni) {
        const float g0 = acc[0][mi][ni][2 * half];
        const float g1 = acc[0][mi][ni][2 * half + 1];
        if constexpr (kGateUp) {
          const float u0 = acc[NB - 1][mi][ni][2 * half];
          const float u1 = acc[NB - 1][mi][ni][2 * half + 1];
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + base +
                                             ni * 8) =
              __floats2bfloat162_rn(g0 / (1.f + __expf(-g0)) * u0,
                                    g1 / (1.f + __expf(-g1)) * u1);
        } else {
          const float gt = gate_s[row];
          *reinterpret_cast<float2*>(static_cast<float*>(out) + base +
                                     ni * 8) = make_float2(g0 * gt, g1 * gt);
        }
      }
    }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads) expert_gate_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w_gate,
    const bf16* __restrict__ w_up, bf16* __restrict__ h,
    const int* __restrict__ order, const int* __restrict__ offs, int held,
    int D, int F, int K) {
  expert_tile<C, true>(x, w_gate, w_up, h, order, offs, nullptr, held, D, F,
                       K);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads) expert_down_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w_down,
    float* __restrict__ y, const int* __restrict__ order,
    const int* __restrict__ offs, const float* __restrict__ gates, int held,
    int D, int F, int K) {
  expert_tile<C, false>(h, w_down, nullptr, y, order, offs, gates, held, F, D,
                        K);
}

constexpr int kSortThreads = 1024;

// The pairs' sort, one block: each pair's expert (key, held where it is
// not held), its place among that expert's pairs (a shared-memory atomic,
// so the order of an expert's rows may differ between calls: each row's
// products and each token's sum in choice order do not depend on it), the
// experts' first rows (offs) by a scan of the counts, then each pair's
// sorted row (slot) and the pair each row holds (order).
__global__ void __launch_bounds__(kSortThreads) expert_sort_kernel(
    const int64_t* __restrict__ ids, int pairs, int held,
    int* __restrict__ order, int* __restrict__ offs, int* __restrict__ slot,
    int* __restrict__ key) {
  extern __shared__ int count[];  // held + 1: counts, then first rows
  for (int e = threadIdx.x; e <= held; e += kSortThreads) count[e] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < pairs; p += kSortThreads) {
    const int64_t v = ids[p];
    const int e = v >= 0 && v < held ? (int)v : held;
    key[p] = e;
    slot[p] = atomicAdd(&count[e], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int first = 0;
    for (int e = 0; e <= held; ++e) {
      const int n = count[e];
      count[e] = first;
      offs[e] = first;
      first += n;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < pairs; p += kSortThreads) {
    const int r = count[key[p]] + slot[p];
    slot[p] = r;
    order[r] = p;
  }
}

constexpr int kCombineThreads = 128;  // 4 columns a thread

__global__ void __launch_bounds__(kCombineThreads) expert_combine_kernel(
    const float* __restrict__ y, const int* __restrict__ slot,
    const int* __restrict__ key, float* __restrict__ out, int held, int D,
    int K) {
  const int t = blockIdx.x;
  const int c = (blockIdx.y * kCombineThreads + threadIdx.x) * 4;
  if (c >= D) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < K; ++k) {
    const int p = t * K + k;
    if (key[p] >= held) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(y + (int64_t)slot[p] * D + c);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(out + (int64_t)t * D + c) = s;
}

// The products and the combine, gate and up in tile GU, down in DN (both
// of the same BM).  A product's grid is one block per (row tile, column
// tile) the most rows could need.
template <class GU, class DN>
cudaError_t launch(const void* x, const void* w_gate, const void* w_up,
                   const void* w_down, const int* order, const int* offs,
                   const float* gates, const int* slot, const int* key,
                   void* h, float* y, float* out, int T, int D, int F, int K,
                   int held, int rows, cudaStream_t stream) {
  static_assert(GU::BM == DN::BM, "one row tiling for both products");
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        expert_gate_up_kernel<GU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)GU::smem(2));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(expert_down_kernel<DN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)DN::smem(1));
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  if (D % GU::BK || D % DN::BN || F % GU::BN || F % DN::BK)
    return cudaErrorInvalidValue;
  const int tiles = (rows + GU::BM - 1) / GU::BM + held;
  expert_gate_up_kernel<GU><<<tiles * (F / GU::BN), GU::kThreads,
                              GU::smem(2), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_gate),
      static_cast<const bf16*>(w_up), static_cast<bf16*>(h), order, offs,
      held, D, F, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  expert_down_kernel<DN><<<tiles * (D / DN::BN), DN::kThreads,
                           DN::smem(1), stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w_down), y, order,
      offs, gates, held, D, F, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int per_block = kCombineThreads * 4;
  expert_combine_kernel<<<dim3(T, (D + per_block - 1) / per_block),
                          kCombineThreads, 0, stream>>>(y, slot, key, out,
                                                        held, D, K);
  return cudaGetLastError();
}

// The tiles of the wrapper's row_tile(T), gate/up and down, from a sweep
// of 19 tiles on an H100 at K-EXAONE's widths.
// Widths that are not multiples of 128 (the small models the tests serve
// on the card) take Narrow, whatever the call.
using Decode16Gu = Tile<16, 128, 64, 1, 8, 4>;
using Decode16Dn = Tile<16, 128, 128, 1, 4, 3>;
using Prompt128 = Tile<128, 128, 64, 2, 4, 3>;
using Narrow = Tile<16, 64, 64, 1, 4, 4>;

}  // namespace

// ids [pairs] int64 local expert ids -> order, slot, key [pairs] and offs
// [held + 1], int32, as above.  Returns a cudaError_t (0 on success).
extern "C" int expert_sort_launch(const void* ids, int pairs, int held,
                                  void* order, void* offs, void* slot,
                                  void* key, void* stream) {
  if (pairs < 1 || held < 1) return (int)cudaErrorInvalidValue;
  expert_sort_kernel<<<1, kSortThreads, (held + 1) * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), pairs, held, static_cast<int*>(order),
      static_cast<int*>(offs), static_cast<int*>(slot), static_cast<int*>(key));
  return (int)cudaGetLastError();
}

// x [T, D]; w_gate, w_up [held, D, F]; w_down [held, F, D] (bf16,
// contiguous); order, offs, slot, key from expert_sort_launch; gates
// [T K] f32 by pair; h [rows, F] bf16 and y [rows, D] f32 scratch; out
// [T, D] f32.  rows >= offs[held]; D and F multiples of 64; bm 16 or 128
// (the row tile at widths that are multiples of 128).  Returns a
// cudaError_t (0 on success).
extern "C" int expert_ffn_launch(const void* x, const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 const void* order, const void* offs,
                                 const void* gates, const void* slot,
                                 const void* key, void* h, void* y, void* out,
                                 int T, int D, int F, int K, int held,
                                 int rows, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 64 != 0 || F % 64 != 0 || D < 64 || F < 64 || T < 1 || K < 1 ||
      held < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const int* o = static_cast<const int*>(order);
  const int* of = static_cast<const int*>(offs);
  const float* g = static_cast<const float*>(gates);
  const int* sl = static_cast<const int*>(slot);
  const int* k = static_cast<const int*>(key);
  float* yy = static_cast<float*>(y);
  float* ot = static_cast<float*>(out);
  if (D % 128 != 0 || F % 128 != 0)
    return launch<Narrow, Narrow>(x, w_gate, w_up, w_down, o, of, g, sl, k,
                                  h, yy, ot, T, D, F, K, held, rows, s);
  switch (bm) {
    case 16:
      return launch<Decode16Gu, Decode16Dn>(x, w_gate, w_up, w_down, o, of,
                                            g, sl, k, h, yy, ot, T, D, F, K,
                                            held, rows, s);
    case 128:
      return launch<Prompt128, Prompt128>(x, w_gate, w_up, w_down, o, of, g,
                                          sl, k, h, yy, ot, T, D, F, K, held,
                                          rows, s);
  }
  return (int)cudaErrorInvalidValue;
}

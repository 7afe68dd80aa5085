// RWKV-6 WKV scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py:
// rwkv6_scan (body _wkv_kernel).  Per (batch, head), with an f32 [N, N]
// state S (row n: key dim, column m: value dim):
//
//   o_t[m] = sum_n r_t[n] (S[n, m] + u[n] k_t[n] v_t[m])
//   S[n, m] = w_t[n] S[n, m] + k_t[n] v_t[m]
//
// on r, k, v [B, S, H, N] (f32 or bf16, read as they are, computed in
// f32), w [B, S, H, N] f32 (clamped at FLT_MIN, the floor the TPU kernel
// means by its 1e-38 before the log), u [H, N] f32 and state [B, H, N, N]
// f32, giving out
// [B, S, H, N] f32 and the final state [B, H, N, N] f32.  Any S >= 1.
//
// What bounds it on the card: about 5 N^2 f32 operations per token and
// head on CUDA cores (no tensor cores in the recurrence form) against the
// bytes of r, k, v, w and out; at the full-width prefill (B 1, S 256,
// H 64, N 64) both bounds are about 5 us.  The recurrence is sequential in
// the token axis, so what limits this kernel is latency, not either bound.
//
// Design: the TPU kernel carries the state in VMEM across a sequential
// grid axis of 64-token chunks; a Hopper block cannot, so the block loops
// over time itself and keeps the state in registers.  Value columns are
// independent, so one block of 64 threads takes (b, h, 16 columns): the 4
// adjacent lanes of a column each hold N/4 rows of it (n = j*4 + part),
// and their partial outputs meet in two warp shuffles.  A tile of 16
// tokens of r, k, w (and the block's 16 columns of v) is staged in shared
// memory as f32, double-buffered, with one __syncthreads per tile.  The
// grid is B * H * N/16 blocks: 256 at full width.  The chunked form on
// tensor cores is the later, fast design.

#include <float.h>

#include "common.cuh"

namespace {

constexpr int kCols = 16;                 // value columns per block
constexpr int kParts = 4;                 // lanes sharing one column
constexpr int kThreads = kCols * kParts;  // 64
constexpr int kTile = 16;                 // tokens staged per tile

template <typename scalar_t, int N>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_kernel(const scalar_t* __restrict__ r,
                      const scalar_t* __restrict__ k,
                      const scalar_t* __restrict__ v,
                      const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0, float* __restrict__ out,
                      float* __restrict__ s_out, int S, int H) {
  constexpr int kPer = N / kParts;    // state rows per thread
  constexpr int kGroups = N / kCols;  // column groups per head
  __shared__ float r_s[2][kTile][N];
  __shared__ float k_s[2][kTile][N];
  __shared__ float w_s[2][kTile][N];
  __shared__ float v_s[2][kTile][kCols];

  const int g = blockIdx.x % kGroups;
  const int bh = blockIdx.x / kGroups;
  const int h = bh % H;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int part = tid % kParts;
  const int col = tid / kParts;
  const int m = g * kCols + col;

  float st[kPer];  // S[j * kParts + part, m]
  float uu[kPer];
  const float* s0b = s0 + (int64_t)bh * N * N;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = j * kParts + part;
    st[j] = s0b[n * N + m];
    uu[j] = u[h * N + n];
  }

  const int64_t tok = (int64_t)H * N;  // stride of one token
  const int64_t base = (int64_t)b * S * tok + (int64_t)h * N;
  const int ntiles = (S + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    // buffer it & 1 was last read in tile it - 2, which every thread
    // finished before passing tile it - 1's barrier
    const int buf = it & 1;
    const int t0 = it * kTile;
    const int nt = min(kTile, S - t0);
    for (int i = tid; i < nt * N; i += kThreads) {
      const int t = i / N;
      const int n = i - t * N;
      const int64_t idx = base + (int64_t)(t0 + t) * tok + n;
      r_s[buf][t][n] = to_f32(r[idx]);
      k_s[buf][t][n] = to_f32(k[idx]);
      w_s[buf][t][n] = fmaxf(w[idx], FLT_MIN);
    }
    for (int i = tid; i < nt * kCols; i += kThreads) {
      const int t = i / kCols;
      const int c = i - t * kCols;
      v_s[buf][t][c] =
          to_f32(v[base + (int64_t)(t0 + t) * tok + g * kCols + c]);
    }
    __syncthreads();

    for (int t = 0; t < nt; ++t) {
      const float vm = v_s[buf][t][col];
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int n = j * kParts + part;
        const float kv = k_s[buf][t][n] * vm;
        o = fmaf(r_s[buf][t][n], fmaf(uu[j], kv, st[j]), o);
        st[j] = fmaf(w_s[buf][t][n], st[j], kv);
      }
      // the column's kParts lanes are adjacent: sum their partial outputs
      o += __shfl_xor_sync(0xffffffffu, o, 1);
      o += __shfl_xor_sync(0xffffffffu, o, 2);
      if (part == 0) out[base + (int64_t)(t0 + t) * tok + m] = o;
    }
  }

  float* sb = s_out + (int64_t)bh * N * N;
#pragma unroll
  for (int j = 0; j < kPer; ++j) sb[(j * kParts + part) * N + m] = st[j];
}

template <typename scalar_t, int N>
cudaError_t launch_n(const void* r, const void* k, const void* v,
                     const float* w, const float* u, const float* s0,
                     float* out, float* s_out, int B, int S, int H,
                     cudaStream_t stream) {
  const dim3 grid((unsigned)B * H * (N / kCols));
  rwkv6_scan_kernel<scalar_t, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const scalar_t*>(r), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), w, u, s0, out, s_out, S, H);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0,
                   float* out, float* s_out, int B, int S, int H, int N,
                   cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch_n<scalar_t, 16>(r, k, v, w, u, s0, out, s_out, B, S, H,
                                    stream);
    case 32:
      return launch_n<scalar_t, 32>(r, k, v, w, u, s0, out, s_out, B, S, H,
                                    stream);
    case 64:
      return launch_n<scalar_t, 64>(r, k, v, w, u, s0, out, s_out, B, S, H,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16.  All tensors contiguous;
// N one of 16, 32, 64; S >= 1.  Returns a cudaError_t (0 on success).
extern "C" int rwkv6_scan_launch(int dtype, const void* r, const void* k,
                                 const void* v, const void* w, const void* u,
                                 const void* s0, void* out, void* s_out,
                                 int B, int S, int H, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* of = static_cast<float*>(out);
  float* sof = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch<float>(r, k, v, wf, uf, s0f, of, sof, B, S, H, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, wf, uf, s0f, of, sof, B, S, H, N,
                                 s);
  return (int)cudaErrorInvalidValue;
}

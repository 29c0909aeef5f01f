// Fused SwiGLU gate for Hopper (sm_90a): out = silu(x @ wg) * (x @ wu).
//
// Replaces the Pallas kernel fused_swiglu_pallas
// (src/repro/kernels/fused_swiglu.py:44, body _kernel at :21): both
// products accumulate in f32 from one read of x, and the silu(g)*u epilogue
// runs before the single store, so g and u never reach device memory.  The
// down projection (@ wd) stays outside, as in the reference.
//
// What bounds it: bytes.  On the decode path M (rows of x) is 1..16 while
// wg and wu are K x N (4096 x 14336 for llama3-8b): 2*M FLOPs per weight
// element, far below the card's ratio of operations to bytes, so the kernel
// is a stream over the two weight matrices and its target is HBM bandwidth.
//
// Design: grid (N / 128, M / 8); 8 warps.  Each lane owns 4 adjacent output
// columns and loads them as one vector, so a warp reads a contiguous 512-byte
// (f32) slice of a weight row; warps interleave over K (warp w takes k = w,
// w+8, ...), four rows in flight per warp.  x is staged in shared memory in
// chunks of 256 columns.  The 8 warps' partial sums meet in shared memory
// and are added in warp order.  Every output element is therefore reduced
// over K in one fixed order that depends on K alone — never on M — so a
// row computed in an 8-row verify batch rounds exactly as in a 1-row decode.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;    // rows of x per block (== kWarps: warp w finalizes row w)
constexpr int kTN = 128;  // output columns per block: 32 lanes x 4
constexpr int kKC = 256;  // x columns staged per chunk
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                        const T* __restrict__ wu, T* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[kTM][kKC];
  __shared__ float red[kWarps][kTM][kTN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kTM;
  const int col = blockIdx.x * kTN + lane * 4;
  const bool col_ok = col < N;  // N % 4 == 0: a lane's four columns are all in or all out

  float g[kTM][4], u[kTM][4];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[r][c] = u[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTM * kKC; idx += kThreads) {
      const int r = idx / kKC, kk = idx % kKC;
      xs[r][kk] = (m0 + r < M && kk < kc) ? to_f32(x[(long long)(m0 + r) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    int kk = warp;
    for (; kk + (kUnroll - 1) * kWarps < kc; kk += kUnroll * kWarps) {
      float4 g4[kUnroll], u4[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long off = (long long)(k0 + kk + j * kWarps) * N + col;
        g4[j] = load4(wg + off);
        u4[j] = load4(wu + off);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const float xv = xs[r][kk + j * kWarps];
          g[r][0] = fmaf(xv, g4[j].x, g[r][0]);
          g[r][1] = fmaf(xv, g4[j].y, g[r][1]);
          g[r][2] = fmaf(xv, g4[j].z, g[r][2]);
          g[r][3] = fmaf(xv, g4[j].w, g[r][3]);
          u[r][0] = fmaf(xv, u4[j].x, u[r][0]);
          u[r][1] = fmaf(xv, u4[j].y, u[r][1]);
          u[r][2] = fmaf(xv, u4[j].z, u[r][2]);
          u[r][3] = fmaf(xv, u4[j].w, u[r][3]);
        }
      }
    }
    for (; kk < kc; kk += kWarps) {
      const long long off = (long long)(k0 + kk) * N + col;
      const float4 g1 = load4(wg + off), u1 = load4(wu + off);
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
        const float xv = xs[r][kk];
        g[r][0] = fmaf(xv, g1.x, g[r][0]);
        g[r][1] = fmaf(xv, g1.y, g[r][1]);
        g[r][2] = fmaf(xv, g1.z, g[r][2]);
        g[r][3] = fmaf(xv, g1.w, g[r][3]);
        u[r][0] = fmaf(xv, u1.x, u[r][0]);
        u[r][1] = fmaf(xv, u1.y, u[r][1]);
        u[r][2] = fmaf(xv, u1.z, u[r][2]);
        u[r][3] = fmaf(xv, u1.w, u[r][3]);
      }
    }
  }

  // cross-warp reduction in warp order; thread (warp w, lane) finalizes row w
  float gs[4], us[4];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = g[r][c];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][warp][lane * 4 + c];
    gs[c] = s;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][r][lane * 4 + c] = u[r][c];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][warp][lane * 4 + c];
    us[c] = s;
  }
  const int row = m0 + warp;
  if (row < M && col_ok) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float gv = gs[c];
      out[(long long)row * N + col + c] = from_f32<T>(gv * (1.f / (1.f + expf(-gv))) * us[c]);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* wg, const void* wu, void* out, int M, int K,
                         int N, cudaStream_t stream) {
  dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  fused_swiglu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], wg/wu [K, N], out [M, N]; contiguous, N % 4 == 0, 16-byte aligned.
REPRO_EXPORT int fused_swiglu_launch(const void* x, const void* wg, const void* wu, void* out,
                                     int M, int K, int N, int dtype, void* stream) {
  if (N % 4 != 0 || M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == DT_F32    ? launch_typed<float>(x, wg, wu, out, M, K, N, st)
                  : dtype == DT_BF16 ? launch_typed<__nv_bfloat16>(x, wg, wu, out, M, K, N, st)
                                     : cudaErrorInvalidValue;
  return (int)e;
}

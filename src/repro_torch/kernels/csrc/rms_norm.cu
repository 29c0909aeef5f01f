// The serving forward's RMS norm for Hopper (sm_90a):
// out = x * rsqrt(mean(x^2) + eps) * w, each row of x [M, d] on its own.
//
// Replaces no Pallas kernel: the reference's norm is XLA's
// (src/repro/models/common.py:27, rms_norm).  The port had left it to
// PyTorch's elementwise ops and its reduction kernel, whose launch
// configuration follows the number of rows: a row's sum of squares was
// grouped otherwise alone (a decode step) than among 8 (a verify), and in
// bf16 the norm's one rounding turned that into an ulp of the MLP's input,
// enough to break a tie of two logits (tools/bf16_invariance.py: the first
// difference between a verify and the greedy decode was the MLP's input,
// after an equal attention output).  Here a row's sum runs in one order that
// depends on d alone: one block a row, thread t adds the squares of the
// elements t, t + 256, t + 512, ... in order in f32, the eight warps' sums
// meet by a butterfly of shuffles and then in warp order.  A row computed
// alone equals the same row among any number of rows, bit for bit.
//
// What bounds it: bytes (x read, out written, w read from L2 by every
// block); a handful of operations per element.  The row is read twice (the
// sum, then the scaling), the second time from L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(const T* x, const T* w, T* out, int d,
                                                            float eps) {
  __shared__ float s_warp[kThreads / 32];
  __shared__ float s_scale;
  const T* xr = x + (long long)blockIdx.x * d;
  T* orow = out + (long long)blockIdx.x * d;
  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    acc = fmaf(v, v, acc);
  }
  acc = warp_sum(acc);  // a butterfly: every lane ends with the same sum
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) s += s_warp[k];
    s_scale = rsqrtf(s / d + eps);  // the mean, then + eps, as the plain version
  }
  __syncthreads();
  const float r = s_scale;
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, void* out, int M, int d, float eps,
                         cudaStream_t st) {
  rms_norm_kernel<T><<<M, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                              static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x [M, d] and out [M, d] contiguous, w [d], all of one dtype (DT_F32 or
// DT_BF16); M >= 1 rows, d >= 1.
REPRO_EXPORT int rms_norm_launch(const void* x, const void* w, void* out, int M, int d, float eps,
                                 int dtype, void* stream) {
  if (M < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == DT_F32    ? launch_typed<float>(x, w, out, M, d, eps, st)
                  : dtype == DT_BF16 ? launch_typed<__nv_bfloat16>(x, w, out, M, d, eps, st)
                                     : cudaErrorInvalidValue;
  return (int)e;
}

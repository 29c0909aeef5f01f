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
// after an equal attention output).
//
// The order of summation depends on d alone (and the dtype), through the
// launch shape ops.rms_norm_plan gives: vec values a load (16 bytes where d
// allows, else one value), tpr threads a row (a power of two, 32 to 512),
// nv loads a thread.  Thread t of a row adds, in f32, the squares of its
// loads i = 0..nv-1 (values (i tpr + t) vec ..) in order; the warp's sums
// meet by a butterfly of shuffles; the row's tpr / 32 warp sums meet by a
// second butterfly, which every warp of the row runs alike on the sums in
// shared memory.  A row computed alone equals the same row among any number
// of rows, bit for bit.
//
// What bounds it: at the serving paths' M = 1..16 the latency of one round
// trip to memory and the launch (the byte bound is nanoseconds); at a long
// prefill's M = 512, bytes (x read, out written, w read from L2 by every
// block).  So the row is read once, by 16-byte loads, and its values stay in
// registers between the sum and the scaling; w's loads are issued before x's,
// their latency under x's and the sum; one barrier where a row spans
// several warps, none where it spans one; and where a row takes fewer than
// 256 threads (d <= 1024 in bf16: MLA's latents, the mamba2 group norm) a
// block takes several rows.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // threads of a row at most (ops._NORM_MAX_TPR)
constexpr int kBlock = 256;       // threads of a block at least, rows permitting

// VEC values of T as one load: 16 bytes, or one value
template <typename T, int VEC>
struct Pack {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "16-byte packs or single values");
  using Raw = typename std::conditional<VEC == 1, T, uint4>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) { raw = *reinterpret_cast<const Raw*>(p); }
  __device__ __forceinline__ void store(T* p) const { *reinterpret_cast<Raw*>(p) = raw; }
  __device__ __forceinline__ float get(int e) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[e]);
  }
  __device__ __forceinline__ void set(int e, float v) {
    reinterpret_cast<T*>(&raw)[e] = from_f32<T>(v);
  }
};

// rows [rows_per_block * blockIdx.x, ..) of x [M, d]; a row is tpr threads
// (blockDim.x / tpr rows a block), thread t holding loads i = 0..NV-1 at
// values (i tpr + t) VEC .. + VEC - 1
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int M,
                    int d, int tpr, float eps) {
  __shared__ float s_warp[kMaxThreads / 32];
  const int t = threadIdx.x % tpr, row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int loads = d / VEC;
  const long long base = (long long)row * d;
  Pack<T, VEC> wv[NV], xv[NV];
  // w first: its latency hides under x's loads and the sum
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i * tpr + t < loads) wv[i].load(w + (i * tpr + t) * VEC);
  float acc = 0.f;
  if (row < M) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * tpr + t < loads) xv[i].load(x + base + (i * tpr + t) * VEC);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * tpr + t < loads) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = xv[i].get(e);
          acc = fmaf(v, v, acc);
        }
      }
  }
  acc = warp_sum(acc);  // a butterfly: every lane ends with the same sum
  if (tpr > 32) {
    // the row's warps: each adds the row's warp sums by the same butterfly
    const int lane = threadIdx.x % 32, first = threadIdx.x / tpr * (tpr / 32);
    if (lane == 0) s_warp[threadIdx.x / 32] = acc;
    __syncthreads();
    acc = warp_sum(lane < tpr / 32 ? s_warp[first + lane] : 0.f);
  }
  if (row >= M) return;
  const float r = rsqrtf(acc / d + eps);  // the mean, then + eps, as the plain version
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (i * tpr + t < loads) {
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.set(e, xv[i].get(e) * r * wv[i].get(e));
      o.store(out + base + (i * tpr + t) * VEC);
    }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const void* w, void* out, int M, int d, int tpr, int nv,
                       float eps, cudaStream_t st) {
  const int rows = tpr >= kBlock ? 1 : kBlock / tpr;
  const dim3 grid((M + rows - 1) / rows), block(rows * tpr);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  switch (nv) {
    case 1: rms_norm_kernel<T, VEC, 1><<<grid, block, 0, st>>>(xp, wp, op, M, d, tpr, eps); break;
    case 2: rms_norm_kernel<T, VEC, 2><<<grid, block, 0, st>>>(xp, wp, op, M, d, tpr, eps); break;
    case 4: rms_norm_kernel<T, VEC, 4><<<grid, block, 0, st>>>(xp, wp, op, M, d, tpr, eps); break;
    case 8: rms_norm_kernel<T, VEC, 8><<<grid, block, 0, st>>>(xp, wp, op, M, d, tpr, eps); break;
    case 16:
      if constexpr (VEC == 1) {
        rms_norm_kernel<T, 1, 16><<<grid, block, 0, st>>>(xp, wp, op, M, d, tpr, eps);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, void* out, int M, int d, int vec, int tpr,
                         int nv, float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec && d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_vec<T, kVec>(x, w, out, M, d, tpr, nv, eps, st);
  if (vec == 1) return launch_vec<T, 1>(x, w, out, M, d, tpr, nv, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [M, d] and out [M, d] contiguous, w [d], all of one dtype (DT_F32 or
// DT_BF16); M >= 1 rows, d >= 1; the launch shape of ops.rms_norm_plan(d,
// dtype): vec values a load (16 bytes' worth: x, w and out 16-byte aligned;
// or 1), tpr threads a row (a power of two, 32 to 512), nv loads a thread
// (1, 2, 4 or 8; 16 with vec 1), tpr * nv * vec >= d.
REPRO_EXPORT int rms_norm_launch(const void* x, const void* w, void* out, int M, int d, int vec,
                                 int tpr, int nv, float eps, int dtype, void* stream) {
  if (M < 1 || d < 1 || tpr < 32 || tpr > kMaxThreads || (tpr & (tpr - 1)) ||
      (long long)tpr * nv * vec < d || d % vec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == DT_F32    ? launch_typed<float>(x, w, out, M, d, vec, tpr, nv, eps, st)
      : dtype == DT_BF16 ? launch_typed<__nv_bfloat16>(x, w, out, M, d, vec, tpr, nv, eps, st)
                         : cudaErrorInvalidValue;
  return (int)e;
}

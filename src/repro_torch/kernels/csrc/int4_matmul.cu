// AWQ groupwise int4 dequant-GEMM for Hopper (sm_90a): out = x @ ((q - z) * s).
//
// Replaces the Pallas kernel int4_matmul_pallas
// (src/repro/kernels/int4_matmul.py:52, body _kernel at :23): the weight
// streams from device memory packed, two 4-bit values per byte along K, and
// is dequantized groupwise, w = (float(q) - z) * s in f32 exactly as the
// reference computes it, next to the product; the dense weight never
// reaches device memory.
//
// What bounds it: bytes.  At the serving paths' M (1 to 16 rows of x) each
// weight byte feeds 2*M multiply-adds per nibble, so the kernel is a stream
// over the packed weight plus 8 bytes of scale and zero per column and
// group (12.5 % on top at group 128).  Only in f32 at M >= 8 do the
// CUDA-core operations match the bytes.
//
// Design: grid (N / 128 column tiles, K splits, M tiles of up to 8 rows);
// 8 warps.  Each lane owns 4 neighbouring columns and loads their packed
// bytes as one 32-bit word, so a warp reads 128 contiguous bytes of a packed
// row (a ragged N, or a base that forbids the word, takes byte loads and
// masks the tail).  Warps interleave over the packed rows of the block's K
// range (warp w takes rows w, w+8, ...), 8 rows in flight per warp, and
// reload scale and zero when a row enters a new group.  x is staged in
// shared memory as f32, 256 values of K at a time for every row of the M
// tile; a nibble becomes a float by moving its byte under the exponent of
// 2^23 (one PRMT).
// The 8 warps' partial sums meet in shared memory and are added in warp
// order.  K is split across blocks so that the card is full when N is
// narrow (llama3-8b's wk and wv, N = 1024, are 8 column tiles): each split
// writes an f32 partial [split, row, column] and a second kernel adds the
// splits in order.  The split is a function of K, N and the group size
// alone (ops.int4_splits), never of M, so every output element is reduced
// over K in one fixed order: a row computed alone equals the same row in a
// batch bit for bit, and no order depends on atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;          // neighbouring columns per lane
constexpr int kTN = 32 * kCols;   // output columns per block
constexpr int kKC = 256;          // values of K staged per chunk (128 packed rows)
constexpr int kUnroll = 8;        // packed rows in flight per warp

// nibble c of four (one per byte of ``nib``, each 0..15) as a float: byte c
// moved under the exponent byte of 2^23 (one PRMT), then 2^23 taken off, exactly
__device__ __forceinline__ float nibble_to_f32(uint32_t nib, int c) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7650u + c)) - 8388608.f;
}

template <typename T, int MT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ qw,
                       const float* __restrict__ scales, const float* __restrict__ zeros,
                       T* __restrict__ out, float* __restrict__ part, int M, int K, int N,
                       int group, int k_per_split) {
  __shared__ __align__(16) float xs[MT][kKC];
  __shared__ float red[kWarps][MT][kTN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * kTN + lane * kCols;
  const int m0 = blockIdx.z * MT;
  const int kb0 = blockIdx.y * k_per_split;
  const int kb1 = min(K, kb0 + k_per_split);

  float acc[MT][kCols];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  float s[kCols] = {}, z[kCols] = {};
  int group_end = kb0;  // K at which the group of s and z ends: no group loaded yet

  for (int k0 = kb0; k0 < kb1; k0 += kKC) {
    const int kc = min(kKC, kb1 - k0);  // even: split bounds are whole groups of even size
    __syncthreads();
    for (int idx = threadIdx.x; idx < MT * kKC; idx += kThreads) {
      const int r = idx / kKC, kk = idx % kKC;
      xs[r][kk] = (m0 + r < M && kk < kc) ? to_f32(x[(long long)(m0 + r) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    const int rows = kc / 2;
    const long long p0 = k0 / 2;
    for (int i = warp; i < rows; i += kWarps * kUnroll) {
      uint32_t w[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int lp = i + j * kWarps;
        w[j] = 0u;
        if (lp < rows) {
          const uint8_t* row = qw + (p0 + lp) * N;
          if (kVec) {
            if (col < N) w[j] = *reinterpret_cast<const uint32_t*>(row + col);
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (col + c < N) w[j] |= uint32_t(row[col + c]) << (8 * c);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int lp = i + j * kWarps;
        if (lp >= rows) break;  // uniform across the warp
        const int k = k0 + 2 * lp;
        if (k >= group_end) {  // a new group (the division runs once per group)
          const int g = k / group;
          group_end = (g + 1) * group;
          const long long off = (long long)g * N + col;
          if (kVec) {
            if (col < N) {
              const float4 s4 = *reinterpret_cast<const float4*>(scales + off);
              const float4 z4 = *reinterpret_cast<const float4*>(zeros + off);
              s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
              z[0] = z4.x; z[1] = z4.y; z[2] = z4.z; z[3] = z4.w;
            }
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              s[c] = col + c < N ? scales[off + c] : 0.f;
              z[c] = col + c < N ? zeros[off + c] : 0.f;
            }
          }
        }
        float x_lo[MT], x_hi[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(&xs[r][2 * lp]);
          x_lo[r] = v.x;
          x_hi[r] = v.y;
        }
        const uint32_t lo4 = w[j] & 0x0F0F0F0Fu, hi4 = (w[j] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          // (float(q) - z) * s, rounded as the reference rounds it (no contraction)
          const float wl = __fmul_rn(__fsub_rn(nibble_to_f32(lo4, c), z[c]), s[c]);
          const float wh = __fmul_rn(__fsub_rn(nibble_to_f32(hi4, c), z[c]), s[c]);
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            acc[r][c] = fmaf(x_lo[r], wl, acc[r][c]);
            acc[r][c] = fmaf(x_hi[r], wh, acc[r][c]);
          }
        }
      }
    }
  }

  // the warps' partials, added in warp order
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[warp][r][lane * kCols + c] = acc[r][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MT * kTN; idx += kThreads) {
    const int r = idx / kTN, cc = idx % kTN;
    const int row = m0 + r, n = blockIdx.x * kTN + cc;
    if (row >= M || n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][r][cc];
    if (part != nullptr)
      part[((long long)blockIdx.y * M + row) * N + n] = v;
    else
      out[(long long)row * N + n] = from_f32<T>(v);
  }
}

// out[i] = sum of the splits' partials in split order, in T
template <typename T>
__global__ void __launch_bounds__(kThreads)
    int4_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int splits,
                        long long MN) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < MN;
       i += (long long)gridDim.x * kThreads) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += part[sp * MN + i];
    out[i] = from_f32<T>(v);
  }
}

template <typename T, int MT, bool kVec>
void launch_tile(const T* x, const uint8_t* qw, const float* sc, const float* zr, T* out,
                 float* part, int M, int K, int N, int group, int k_per_split, int splits,
                 cudaStream_t stream) {
  dim3 grid((N + kTN - 1) / kTN, splits, (M + MT - 1) / MT);
  int4_matmul_kernel<T, MT, kVec><<<grid, kThreads, 0, stream>>>(
      x, qw, sc, zr, out, part, M, K, N, group, k_per_split);
}

template <typename T, bool kVec>
void launch_rows(const T* x, const uint8_t* qw, const float* sc, const float* zr, T* out,
                 float* part, int M, int K, int N, int group, int k_per_split, int splits,
                 cudaStream_t stream) {
  // rows per block: the fewest that hold M (the K order of a row is the same for every choice)
  if (M == 1)
    launch_tile<T, 1, kVec>(x, qw, sc, zr, out, part, M, K, N, group, k_per_split, splits, stream);
  else if (M == 2)
    launch_tile<T, 2, kVec>(x, qw, sc, zr, out, part, M, K, N, group, k_per_split, splits, stream);
  else if (M <= 4)
    launch_tile<T, 4, kVec>(x, qw, sc, zr, out, part, M, K, N, group, k_per_split, splits, stream);
  else
    launch_tile<T, 8, kVec>(x, qw, sc, zr, out, part, M, K, N, group, k_per_split, splits, stream);
}

template <typename T>
cudaError_t launch_typed(const void* x_, const void* qw_, const void* sc_, const void* zr_,
                         void* out_, void* part_, int M, int K, int N, int group, int k_per_split,
                         int splits, int rows_per_pass, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const uint8_t* qw = static_cast<const uint8_t*>(qw_);
  const float* sc = static_cast<const float*>(sc_);
  const float* zr = static_cast<const float*>(zr_);
  T* out = static_cast<T*>(out_);
  float* part = splits > 1 ? static_cast<float*>(part_) : nullptr;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(qw) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(sc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(zr) % 16 == 0;
  // with a split, rows pass through the partial buffer [splits, rows_per_pass, N] in turn
  const int pass = splits > 1 ? rows_per_pass : M;
  for (int r0 = 0; r0 < M; r0 += pass) {
    const int rows = min(pass, M - r0);
    const T* xr = x + (long long)r0 * K;
    T* outr = out + (long long)r0 * N;
    if (vec)
      launch_rows<T, true>(xr, qw, sc, zr, outr, part, rows, K, N, group, k_per_split, splits,
                           stream);
    else
      launch_rows<T, false>(xr, qw, sc, zr, outr, part, rows, K, N, group, k_per_split, splits,
                            stream);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (part != nullptr) {
      const long long mn = (long long)rows * N;
      const int blocks = (int)min((mn + kThreads - 1) / kThreads, 4096LL);
      int4_combine_kernel<T><<<blocks, kThreads, 0, stream>>>(part, outr, splits, mn);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

}  // namespace

// x [M, K] (f32 or bf16), qweight uint8/int8 [K/2, N] packed (low nibble
// even k), scales/zeros f32 [K/group, N], out [M, N] in x's type; all
// contiguous.  The K range of a split is k_per_split (a multiple of the
// group); with splits > 1, part is an f32 [splits, min(M, rows_per_pass), N].
REPRO_EXPORT int int4_matmul_launch(const void* x, const void* qweight, const void* scales,
                                    const void* zeros, void* out, void* part, int M, int K,
                                    int N, int group, int k_per_split, int splits,
                                    int rows_per_pass, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group <= 0 || group % 2 || K % group ||
      k_per_split <= 0 || k_per_split % group || splits != (K + k_per_split - 1) / k_per_split ||
      splits > 65535 || (splits > 1 && (part == nullptr || rows_per_pass <= 0)))
    return (int)cudaErrorInvalidValue;
  if ((splits > 1 ? rows_per_pass : M) > 8 * 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == DT_F32 ? launch_typed<float>(x, qweight, scales, zeros, out, part, M, K, N, group,
                                            k_per_split, splits, rows_per_pass, st)
      : dtype == DT_BF16
          ? launch_typed<__nv_bfloat16>(x, qweight, scales, zeros, out, part, M, K, N, group,
                                        k_per_split, splits, rows_per_pass, st)
          : cudaErrorInvalidValue;
  return (int)e;
}

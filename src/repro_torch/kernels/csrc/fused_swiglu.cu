// Fused SwiGLU gate for Hopper (sm_90a): out = silu(x @ wg) * (x @ wu).
//
// Replaces the Pallas kernel fused_swiglu_pallas
// (src/repro/kernels/fused_swiglu.py:44, body _kernel at :21): both
// products accumulate in f32 from one read of x, and silu(g) * u is applied
// in f32 to the complete sums over K before the single store, so g and u
// never reach device memory except as split partials.  The down projection
// (@ wd) stays outside, as in the reference.
//
// What bounds it: bytes.  On the paths M is 1..16 while wg and wu are
// K x N (4096 x 14336 for llama3-8b: 235 MB in bf16, 470 MB in f32), so the
// kernel is a stream over the two weights at HBM rate: 0.0701 / 0.1404 ms
// at the 8B, 0.0200 / 0.0401 ms at the 1B (K 2048, N 8192).
//
// Design: weight_stream.cuh (the split grid over all SMs, the cp.async
// ring, x staged once, the in-kernel split combine in a fixed order).  Per
// dtype:
// * bf16 (SwigluMma): a stage is 16 values of K of both weights' 256-column
//   tiles, 4 stages; a row's 16-byte granules are permuted by k mod 8, so
//   that ldmatrix's eight row addresses fall in eight bank groups.  Warp w
//   owns columns 32w..32w+31: per k16 step one ldmatrix of x (16 rows; rows
//   past M read row 0, and their sums are never stored) and two
//   ldmatrix.trans per weight feed 4 + 4 mma.sync.m16n8k16 into the g and
//   u accumulators.  A bf16 weight row of N % 8 != 0 values is copied 8
//   or 4 bytes at a time (N % 4, N % 2 == 0), byte by byte for an odd N
//   (a tensor-parallel rank's share of a padded d_ff, e.g. 4779); nothing
//   else depends on N, so the order of summation over K does not change.
//   On an H100 it streams at the rate of its loads alone (N % 8 == 0).
// * f32 (SwigluF32<MT>): lane l of warp w owns columns 64 (w / 2) + 2l and
//   2l + 1, and warps w and w ^ 1 split K by rows (phase w mod 2 takes the
//   rows k = w mod 2, in order); per row two 8-byte shared loads of the
//   weights, one vector of x per 4 rows of the tile and 4*MT fmaf; the two
//   phases meet in shared memory.  Two columns per lane keep 16 rows of g
//   and u (64 registers) within two blocks per SM, so a 16-row prefill is
//   one pass over the weights.  A stage is 4 rows of K (8 at MT 16, fewer
//   barriers per FMA), 6 stages (3 at MT 16, where x takes 64 KB).  MT is
//   the fewest of 1, 2, 4, 8, 16 that hold M; a row's chain of fmaf is the
//   same for every MT.
#include "weight_stream.cuh"

namespace {

constexpr int kSwigluKQuantum = 32;  // K per split is a multiple (ops._SWIGLU_K_QUANTUM)

template <typename T_>
struct SwigluArgs {
  const T_* x;
  const T_* wg;
  const T_* wu;
  T_* out;
  Split sp;
  int xr;     // bf16: rows of x held in shared memory, min(M, 16)
  int x_vec;  // bf16: x rows load 16 bytes at a time
};

__device__ __forceinline__ float swiglu(const float (&v)[2]) {
  return v[0] * (1.f / (1.f + expf(-v[0]))) * v[1];
}

// ---- bf16 on tensor cores ------------------------------------------------------

// bytes per cp.async of a weight row: the widest of 16, 8 and 4 that 2N
// divides, or 1: plain byte loads (copy_rows_bytes) for an odd N
template <int GR>
struct SwigluMma {
  using T = __nv_bfloat16;
  using Args = SwigluArgs<T>;
  static constexpr int P = 2, kStages = 4, kRows = kRowTile;
  static constexpr int KT = 16;           // values of K per stage: one k16 step
  static constexpr int LDW = kTileN;  // weight tile row stride, elements (unpadded)
  using Z = Swz<8, 0>;  // granule j ^ (k mod 8): ldmatrix's 8 row addresses in 8 bank groups
  static constexpr int kMatBytes = KT * LDW * 2;
  static constexpr int kSlotBytes = 2 * kMatBytes;

  __host__ __device__ static int ldx(int k_per_split) { return round_up(k_per_split, KT) + 8; }
  static int smem_bytes(int k_per_split, int xr) {
    return kStages * kSlotBytes + xr * ldx(k_per_split) * 2;
  }

  const Args& a;
  Block b;
  unsigned char* smem;
  T* xs;
  int ldx_;
  float accg[4][4], accu[4][4];  // n8 tile j: columns 32*warp + 8j

  __device__ SwigluMma(const Args& a_, unsigned char* sm) : a(a_), smem(sm) {
    b = block_of(a.sp, kRows);
    ldx_ = ldx(a.sp.k_per_split);
    xs = reinterpret_cast<T*>(smem + kStages * kSlotBytes);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accg[j][e] = accu[j][e] = 0.f;
  }
  __device__ int steps() const { return (b.kb1 - b.kb0 + KT - 1) / KT; }

  __device__ void load_stage(int step, int slot) {
    unsigned char* dst = smem + slot * kSlotBytes;
    const int k0 = b.kb0 + step * KT, N = a.sp.N;
    copy_weight_rows<GR, kTileN * 2, Z>(dst, LDW * 2, a.wg, 2LL * N, k0, KT, b.kb1, 2 * b.n0,
                                        2 * N);
    copy_weight_rows<GR, kTileN * 2, Z>(dst + kMatBytes, LDW * 2, a.wu, 2LL * N, k0, KT, b.kb1,
                                        2 * b.n0, 2 * N);
  }

  __device__ void stage_x() {
    stage_rows_bf16(xs, ldx_, a.xr, round_up(b.kb1 - b.kb0, KT), a.x, a.sp.K, a.sp.M, b.m0,
                    b.kb0, b.kb1, a.x_vec);
  }

  __device__ void compute(int it, int slot) {
    const unsigned char* wg = smem + slot * kSlotBytes;
    const unsigned char* wu = wg + kMatBytes;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
    const int row = mr + (mi & 1) * 8;
    unsigned xa[4];
    // rows past the tile's read row 0: their sums are never stored
    ldsm_x4(xa, xs + (row < b.rows ? row : 0) * ldx_ + it * KT + (mi >> 1) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = (mi & 1) * 8 + mr;  // k of the lane's row address
      const int off = k * LDW * 2 + Z::at(k, 2 * (warp * 32 + h * 16 + (mi >> 1) * 8));
      unsigned bg[4], bu[4];
      ldsm_x4_trans(bg, wg + off);
      ldsm_x4_trans(bu, wu + off);
      mma_bf16(accg[2 * h], xa, bg[0], bg[1]);
      mma_bf16(accg[2 * h + 1], xa, bg[2], bg[3]);
      mma_bf16(accu[2 * h], xa, bu[0], bu[1]);
      mma_bf16(accu[2 * h + 1], xa, bu[2], bu[3]);
    }
  }

  __device__ void finish() {}

  // fragment e of tile j: row g + 8 * (e / 2), column 32*warp + 8j + 2t + e % 2
  template <class F>
  __device__ void emit(F&& f) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v[4] = {accg[j][2 * h], accg[j][2 * h + 1], accu[j][2 * h],
                            accu[j][2 * h + 1]};
        f(g + 8 * h, warp * 32 + 8 * j + 2 * t, std::integral_constant<int, 2>{}, v);
      }
  }

  static __device__ __forceinline__ float value(const float (&v)[2]) { return swiglu(v); }
};

// ---- f32 on CUDA cores ---------------------------------------------------------

template <int MT, int GR>  // rows of x per block; bytes per cp.async: 16 (N % 4 == 0) or 4
struct SwigluF32 {
  using T = float;
  using Args = SwigluArgs<T>;
  static constexpr int P = 2, kStages = MT >= 16 ? 3 : 6, kRows = MT;
  static constexpr int kPh = 2;  // warps that share columns, each a phase of K
  // rows of K per stage: two per phase, four at MT 16 (fewer barriers per
  // FMA); phase p takes the rows k = p mod 2 in order either way
  static constexpr int KT = (MT >= 16 ? 4 : 2) * kPh;
  static constexpr int kMatBytes = KT * kTileN * 4;
  static constexpr int kSlotBytes = 2 * kMatBytes;

  static int smem_bytes(int k_per_split) {
    const int main = kStages * kSlotBytes + round_up(k_per_split, KT) * MT * 4;
    const int red = MT * kTileN * 4;  // phase 1's sums, after the ring
    return main > red ? main : red;
  }

  const Args& a;
  Block b;
  unsigned char* smem;
  float* xs;  // [k][MT]
  float g[MT][2], u[MT][2];

  // warp w: columns 64 * (w / 2) + 2 * lane, the rows k = w % 2 (mod 2) of K
  __device__ static int col() { return threadIdx.x / 32 / kPh * 64 + threadIdx.x % 32 * 2; }
  __device__ static int phase() { return threadIdx.x / 32 % kPh; }

  __device__ SwigluF32(const Args& a_, unsigned char* sm) : a(a_), smem(sm) {
    b = block_of(a.sp, kRows);
    xs = reinterpret_cast<float*>(smem + kStages * kSlotBytes);
#pragma unroll
    for (int r = 0; r < MT; ++r) g[r][0] = g[r][1] = u[r][0] = u[r][1] = 0.f;
  }
  __device__ int steps() const { return (b.kb1 - b.kb0 + KT - 1) / KT; }

  __device__ void load_stage(int step, int slot) {
    unsigned char* dst = smem + slot * kSlotBytes;
    const int k0 = b.kb0 + step * KT, N = a.sp.N;
    copy_rows<GR, kTileN * 4>(dst, kTileN * 4, a.wg, 4LL * N, k0, KT, b.kb1, 4 * b.n0, 4 * N);
    copy_rows<GR, kTileN * 4>(dst + kMatBytes, kTileN * 4, a.wu, 4LL * N, k0, KT, b.kb1,
                              4 * b.n0, 4 * N);
  }

  __device__ void stage_x() {
    stage_cols_f32<float, MT>(xs, round_up(b.kb1 - b.kb0, KT), a.x, a.sp.K, a.sp.M, b.m0, b.kb0,
                              b.kb1);
  }

  __device__ void compute(int it, int slot) {
    const float* wg = reinterpret_cast<const float*>(smem + slot * kSlotBytes);
    const float* wu = wg + KT * kTileN;
    const int c = col();
#pragma unroll
    for (int j = 0; j < KT / kPh; ++j) {
      const int i = phase() + j * kPh, kl = it * KT + i;
      if (b.kb0 + kl >= b.kb1) break;  // the same for the whole warp
      const float2 gw = *reinterpret_cast<const float2*>(wg + i * kTileN + c);
      const float2 uw = *reinterpret_cast<const float2*>(wu + i * kTileN + c);
      float xv[MT];
      load_x<MT>(xv, xs + kl * MT);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        g[r][0] = fmaf(xv[r], gw.x, g[r][0]);
        g[r][1] = fmaf(xv[r], gw.y, g[r][1]);
        u[r][0] = fmaf(xv[r], uw.x, u[r][0]);
        u[r][1] = fmaf(xv[r], uw.y, u[r][1]);
      }
    }
  }

  // phase 0's sums plus phase 1's, through shared memory
  __device__ void finish() {
    float* red = reinterpret_cast<float*>(smem);
    const int c = col();
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float(&v)[MT][2] = m == 0 ? g : u;
      __syncthreads();
      if (phase() == 1) {
#pragma unroll
        for (int r = 0; r < MT; ++r)
          *reinterpret_cast<float2*>(red + r * kTileN + c) = make_float2(v[r][0], v[r][1]);
      }
      __syncthreads();
      if (phase() == 0) {
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float2 t = *reinterpret_cast<const float2*>(red + r * kTileN + c);
          v[r][0] += t.x;
          v[r][1] += t.y;
        }
      }
    }
  }

  template <class F>
  __device__ void emit(F&& f) const {
    if (phase()) return;  // phase 0 holds the block's sums
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float v[4] = {g[r][0], g[r][1], u[r][0], u[r][1]};
      f(r, col(), std::integral_constant<int, 2>{}, v);
    }
  }

  static __device__ __forceinline__ float value(const float (&v)[2]) { return swiglu(v); }
};

template <int GR>
cudaError_t launch_f32_rows(const SwigluArgs<float>& a, int rows, cudaStream_t st) {
  const int kps = a.sp.k_per_split;
  if (rows == 1) return launch_op<SwigluF32<1, GR>>(a, SwigluF32<1, GR>::smem_bytes(kps), st);
  if (rows == 2) return launch_op<SwigluF32<2, GR>>(a, SwigluF32<2, GR>::smem_bytes(kps), st);
  if (rows <= 4) return launch_op<SwigluF32<4, GR>>(a, SwigluF32<4, GR>::smem_bytes(kps), st);
  if (rows <= 8) return launch_op<SwigluF32<8, GR>>(a, SwigluF32<8, GR>::smem_bytes(kps), st);
  return launch_op<SwigluF32<16, GR>>(a, SwigluF32<16, GR>::smem_bytes(kps), st);
}

// an f32 weight row of N % 4 != 0 values is copied 4 bytes at a time (its
// rows start 4-byte aligned only)
cudaError_t launch_f32(const SwigluArgs<float>& a, int rows, cudaStream_t st) {
  return a.sp.N % 4 == 0 ? launch_f32_rows<16>(a, rows, st) : launch_f32_rows<4>(a, rows, st);
}

cudaError_t launch_bf16(const SwigluArgs<__nv_bfloat16>& a, cudaStream_t st) {
  const int smem = SwigluMma<16>::smem_bytes(a.sp.k_per_split, a.xr), N = a.sp.N;
  return N % 8 == 0   ? launch_op<SwigluMma<16>>(a, smem, st)
         : N % 4 == 0 ? launch_op<SwigluMma<8>>(a, smem, st)
         : N % 2 == 0 ? launch_op<SwigluMma<4>>(a, smem, st)
                      : launch_op<SwigluMma<1>>(a, smem, st);
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* wg, const void* wu, void* out, float* part,
                         int* counters, int M, int K, int N, int k_per_split, int splits,
                         int rows_per_pass, cudaStream_t st) {
  // with a split, rows pass through the partials [splits, 2, rows_per_pass, N] in turn
  const int pass = splits > 1 ? rows_per_pass : M;
  for (int r0 = 0; r0 < M; r0 += pass) {
    const int rows = min(pass, M - r0);
    SwigluArgs<T> a;
    a.x = static_cast<const T*>(x) + (long long)r0 * K;
    a.wg = static_cast<const T*>(wg);
    a.wu = static_cast<const T*>(wu);
    a.out = static_cast<T*>(out) + (long long)r0 * N;
    // the partials' rows are N rounded up to 4 (ops._stream_scratch): a row of any N
    // then starts 16-byte aligned for the float2 / float4 stores and loads
    a.sp = Split{rows, K, N, k_per_split, splits, part, counters, round_up(N, 4)};
    a.xr = min(rows, kRowTile);
    a.x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    cudaError_t e;
    if constexpr (std::is_same<T, float>::value)
      e = launch_f32(a, rows, st);
    else
      e = launch_bf16(a, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// x [M, K], wg/wu [K, N], out [M, N]; contiguous, any N, weights 16-byte
// aligned.  K splits of k_per_split (a multiple of kSwigluKQuantum, from
// ops.stream_plan); with splits > 1, part is an f32 [splits, 2,
// min(M, rows_per_pass), N] and counters holds a zero per (row tile, column
// tile) of a pass.
REPRO_EXPORT int fused_swiglu_launch(const void* x, const void* wg, const void* wu, void* out,
                                     void* part, void* counters, int M, int K, int N,
                                     int k_per_split, int splits, int rows_per_pass, int dtype,
                                     void* stream) {
  if (!plan_ok(M, K, N, k_per_split, splits, kSwigluKQuantum, rows_per_pass) ||
      (splits > 1 && (part == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(wg) % 16 || reinterpret_cast<uintptr_t>(wu) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  cudaError_t e =
      dtype == DT_F32
          ? launch_typed<float>(x, wg, wu, out, p, c, M, K, N, k_per_split, splits, rows_per_pass,
                                st)
      : dtype == DT_BF16 ? launch_typed<__nv_bfloat16>(x, wg, wu, out, p, c, M, K, N, k_per_split,
                                                       splits, rows_per_pass, st)
                         : cudaErrorInvalidValue;
  return (int)e;
}

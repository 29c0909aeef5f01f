// The serving product for Hopper (sm_90a): out = x @ w, one weight stream.
//
// Replaces no Pallas kernel.  The reference leaves these products to XLA's
// dot (src/repro/models/attention.py's q/k/v/o projections, the MLP's down
// projection, the lm_head); the port had left them to torch.matmul, whose
// cuBLAS kernels choose their order of summation over K by the number of
// rows, M.  In bf16 that gave a row other bits among 16 rows than alone,
// and the tree engine's verify (a row among n) then read other logits than
// the greedy decode (the row alone), breaking its contract that the
// speculative output is the greedy decode.  This kernel sums every output
// element over K in one order that depends on K, N and the quantum alone:
// a row computed alone equals the same row among any number of rows, bit
// for bit.  It is the third op on weight_stream.cuh, beside fused_swiglu.cu
// and int4_matmul.cu, whose design promises exactly that.
//
// What bounds it: bytes.  On the serving paths M is 1..16 rows against a
// [K, N] weight read once (the llama3-8b wq 4096 x 4096: 33.6 MB in bf16),
// each weight value feeding at most 2*M operations, far below the card's
// ~295 (bf16) or ~20 (f32) operations per byte of HBM.
//
// Design: weight_stream.cuh (the split grid over all SMs, the cp.async
// ring, x staged once, the in-kernel split combine in split order), with
// fused_swiglu.cu's two ops reduced to one weight and no epilogue:
// * bf16 (MatmulMma): a stage is 16 values of K of the weight's 256-column
//   tile, 8 stages (the bytes in flight of fused_swiglu's 4 stages of two
//   weights); granules permuted by k mod 8 for ldmatrix.  Warp w owns
//   columns 32w..32w+31: per k16 step one ldmatrix of x (16 rows; rows past
//   the tile's read row 0 of the tile, and their sums are never stored:
//   emit's callback drops r >= rows) and two ldmatrix.trans of the weight
//   feed 4 mma.sync.m16n8k16.  An MMA row's sums do not depend on the other
//   rows of its A operand, so which rows share a tile changes no bit.
// * f32 (MatmulF32<MT>): lane l of warp w owns columns 64 (w / 2) + 2l and
//   2l + 1; warps w and w ^ 1 split K by rows (phase w mod 2 takes the rows
//   k = w mod 2, in order); a stage is 4 rows of K (8 at MT 16), 12 stages
//   (6 at MT 16).  MT is the fewest of 1, 2, 4, 8, 16 that hold the rows; a
//   row's chain of fmaf is the same for every MT.  No TF32.
// * More than 16 rows run row tiles of 16 (bf16) or MT 16 (f32) side by
//   side, each streaming the weight again (from L2 where the tiles run
//   together); with a split, more than 64 rows run in passes of 64 through
//   the partials.  A long prefill so pays the weight's bytes once per row
//   tile: the price of an order of summation that M does not choose.
#include "weight_stream.cuh"

namespace {

constexpr int kMatmulKQuantum = 32;  // K per split is a multiple (ops._MATMUL_K_QUANTUM)

template <typename T_>
struct MatmulArgs {
  const T_* x;
  const T_* w;
  T_* out;
  Split sp;
  int xr;     // bf16: rows of x held in shared memory, min(M, 16)
  int x_vec;  // bf16: x rows load 16 bytes at a time
};

// ---- bf16 on tensor cores ------------------------------------------------------

// bytes per cp.async of a weight row: the widest of 16, 8 and 4 that 2N
// divides, or 1: plain byte loads for an odd N
template <int GR>
struct MatmulMma {
  using T = __nv_bfloat16;
  using Args = MatmulArgs<T>;
  static constexpr int P = 1, kStages = 8, kRows = kRowTile;
  static constexpr int KT = 16;       // values of K per stage: one k16 step
  static constexpr int LDW = kTileN;  // weight tile row stride, elements (unpadded)
  using Z = Swz<8, 0>;  // granule j ^ (k mod 8): ldmatrix's 8 row addresses in 8 bank groups
  static constexpr int kSlotBytes = KT * LDW * 2;

  __host__ __device__ static int ldx(int k_per_split) { return round_up(k_per_split, KT) + 8; }
  static int smem_bytes(int k_per_split, int xr) {
    return kStages * kSlotBytes + xr * ldx(k_per_split) * 2;
  }

  const Args& a;
  Block b;
  unsigned char* smem;
  T* xs;
  int ldx_;
  float acc[4][4];  // n8 tile j: columns 32*warp + 8j

  __device__ MatmulMma(const Args& a_, unsigned char* sm) : a(a_), smem(sm) {
    b = block_of(a.sp, kRows);
    ldx_ = ldx(a.sp.k_per_split);
    xs = reinterpret_cast<T*>(smem + kStages * kSlotBytes);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  __device__ int steps() const { return (b.kb1 - b.kb0 + KT - 1) / KT; }

  __device__ void load_stage(int step, int slot) {
    const int k0 = b.kb0 + step * KT, N = a.sp.N;
    copy_weight_rows<GR, kTileN * 2, Z>(smem + slot * kSlotBytes, LDW * 2, a.w, 2LL * N, k0, KT,
                                        b.kb1, 2 * b.n0, 2 * N);
  }

  __device__ void stage_x() {
    stage_rows_bf16(xs, ldx_, a.xr, round_up(b.kb1 - b.kb0, KT), a.x, a.sp.K, a.sp.M, b.m0,
                    b.kb0, b.kb1, a.x_vec);
  }

  __device__ void compute(int it, int slot) {
    const unsigned char* w = smem + slot * kSlotBytes;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, mi = lane / 8, mr = lane % 8;
    const int row = mr + (mi & 1) * 8;
    unsigned xa[4];
    // rows past the tile's read row 0: their sums are never stored
    ldsm_x4(xa, xs + (row < b.rows ? row : 0) * ldx_ + it * KT + (mi >> 1) * 8);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = (mi & 1) * 8 + mr;  // k of the lane's row address
      unsigned bw[4];
      ldsm_x4_trans(bw, w + k * LDW * 2 + Z::at(k, 2 * (warp * 32 + h * 16 + (mi >> 1) * 8)));
      mma_bf16(acc[2 * h], xa, bw[0], bw[1]);
      mma_bf16(acc[2 * h + 1], xa, bw[2], bw[3]);
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
        const float v[2] = {acc[j][2 * h], acc[j][2 * h + 1]};
        f(g + 8 * h, warp * 32 + 8 * j + 2 * t, std::integral_constant<int, 2>{}, v);
      }
  }

  static __device__ __forceinline__ float value(const float (&v)[1]) { return v[0]; }
};

// ---- f32 on CUDA cores ---------------------------------------------------------

template <int MT, int GR>  // rows of x per block; bytes per cp.async: 16 (N % 4 == 0) or 4
struct MatmulF32 {
  using T = float;
  using Args = MatmulArgs<T>;
  static constexpr int P = 1, kStages = MT >= 16 ? 6 : 12, kRows = MT;
  static constexpr int kPh = 2;  // warps that share columns, each a phase of K
  // rows of K per stage: two per phase, four at MT 16 (fewer barriers per
  // FMA); phase p takes the rows k = p mod 2 in order either way
  static constexpr int KT = (MT >= 16 ? 4 : 2) * kPh;
  static constexpr int kSlotBytes = KT * kTileN * 4;

  static int smem_bytes(int k_per_split) {
    const int main = kStages * kSlotBytes + round_up(k_per_split, KT) * MT * 4;
    const int red = MT * kTileN * 4;  // phase 1's sums, after the ring
    return main > red ? main : red;
  }

  const Args& a;
  Block b;
  unsigned char* smem;
  float* xs;  // [k][MT]
  float o[MT][2];

  // warp w: columns 64 * (w / 2) + 2 * lane, the rows k = w % 2 (mod 2) of K
  __device__ static int col() { return threadIdx.x / 32 / kPh * 64 + threadIdx.x % 32 * 2; }
  __device__ static int phase() { return threadIdx.x / 32 % kPh; }

  __device__ MatmulF32(const Args& a_, unsigned char* sm) : a(a_), smem(sm) {
    b = block_of(a.sp, kRows);
    xs = reinterpret_cast<float*>(smem + kStages * kSlotBytes);
#pragma unroll
    for (int r = 0; r < MT; ++r) o[r][0] = o[r][1] = 0.f;
  }
  __device__ int steps() const { return (b.kb1 - b.kb0 + KT - 1) / KT; }

  __device__ void load_stage(int step, int slot) {
    const int k0 = b.kb0 + step * KT, N = a.sp.N;
    copy_rows<GR, kTileN * 4>(smem + slot * kSlotBytes, kTileN * 4, a.w, 4LL * N, k0, KT, b.kb1,
                              4 * b.n0, 4 * N);
  }

  __device__ void stage_x() {
    stage_cols_f32<float, MT>(xs, round_up(b.kb1 - b.kb0, KT), a.x, a.sp.K, a.sp.M, b.m0, b.kb0,
                              b.kb1);
  }

  __device__ void compute(int it, int slot) {
    const float* w = reinterpret_cast<const float*>(smem + slot * kSlotBytes);
    const int c = col();
#pragma unroll
    for (int j = 0; j < KT / kPh; ++j) {
      const int i = phase() + j * kPh, kl = it * KT + i;
      if (b.kb0 + kl >= b.kb1) break;  // the same for the whole warp
      const float2 wv = *reinterpret_cast<const float2*>(w + i * kTileN + c);
      float xv[MT];
      load_x<MT>(xv, xs + kl * MT);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        o[r][0] = fmaf(xv[r], wv.x, o[r][0]);
        o[r][1] = fmaf(xv[r], wv.y, o[r][1]);
      }
    }
  }

  // phase 0's sums plus phase 1's, through shared memory
  __device__ void finish() {
    float* red = reinterpret_cast<float*>(smem);
    const int c = col();
    __syncthreads();
    if (phase() == 1) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
        *reinterpret_cast<float2*>(red + r * kTileN + c) = make_float2(o[r][0], o[r][1]);
    }
    __syncthreads();
    if (phase() == 0) {
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float2 t = *reinterpret_cast<const float2*>(red + r * kTileN + c);
        o[r][0] += t.x;
        o[r][1] += t.y;
      }
    }
  }

  template <class F>
  __device__ void emit(F&& f) const {
    if (phase()) return;  // phase 0 holds the block's sums
#pragma unroll
    for (int r = 0; r < MT; ++r) f(r, col(), std::integral_constant<int, 2>{}, o[r]);
  }

  static __device__ __forceinline__ float value(const float (&v)[1]) { return v[0]; }
};

template <int GR>
cudaError_t launch_f32_rows(const MatmulArgs<float>& a, int rows, cudaStream_t st) {
  const int kps = a.sp.k_per_split;
  if (rows == 1) return launch_op<MatmulF32<1, GR>>(a, MatmulF32<1, GR>::smem_bytes(kps), st);
  if (rows == 2) return launch_op<MatmulF32<2, GR>>(a, MatmulF32<2, GR>::smem_bytes(kps), st);
  if (rows <= 4) return launch_op<MatmulF32<4, GR>>(a, MatmulF32<4, GR>::smem_bytes(kps), st);
  if (rows <= 8) return launch_op<MatmulF32<8, GR>>(a, MatmulF32<8, GR>::smem_bytes(kps), st);
  return launch_op<MatmulF32<16, GR>>(a, MatmulF32<16, GR>::smem_bytes(kps), st);
}

// an f32 weight row of N % 4 != 0 values is copied 4 bytes at a time (its
// rows start 4-byte aligned only)
cudaError_t launch_f32(const MatmulArgs<float>& a, int rows, cudaStream_t st) {
  return a.sp.N % 4 == 0 ? launch_f32_rows<16>(a, rows, st) : launch_f32_rows<4>(a, rows, st);
}

cudaError_t launch_bf16(const MatmulArgs<__nv_bfloat16>& a, cudaStream_t st) {
  const int smem = MatmulMma<16>::smem_bytes(a.sp.k_per_split, a.xr), N = a.sp.N;
  return N % 8 == 0   ? launch_op<MatmulMma<16>>(a, smem, st)
         : N % 4 == 0 ? launch_op<MatmulMma<8>>(a, smem, st)
         : N % 2 == 0 ? launch_op<MatmulMma<4>>(a, smem, st)
                      : launch_op<MatmulMma<1>>(a, smem, st);
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, void* out, float* part, int* counters,
                         int M, int K, int N, int k_per_split, int splits, int rows_per_pass,
                         cudaStream_t st) {
  // with a split, rows pass through the partials [splits, rows_per_pass, N] in turn
  const int pass = splits > 1 ? rows_per_pass : M;
  for (int r0 = 0; r0 < M; r0 += pass) {
    const int rows = min(pass, M - r0);
    MatmulArgs<T> a;
    a.x = static_cast<const T*>(x) + (long long)r0 * K;
    a.w = static_cast<const T*>(w);
    a.out = static_cast<T*>(out) + (long long)r0 * N;
    // the partials' rows are N rounded up to 4 (ops._stream_scratch)
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

// x [M, K], w [K, N], out [M, N]; contiguous, any N, w 16-byte aligned.  K
// splits of k_per_split (a multiple of kMatmulKQuantum, from
// ops.stream_plan); with splits > 1, part is an f32 [splits, min(M,
// rows_per_pass), N rounded up to 4] and counters holds a zero per (row
// tile, column tile) of a pass.
REPRO_EXPORT int stream_matmul_launch(const void* x, const void* w, void* out, void* part,
                                      void* counters, int M, int K, int N, int k_per_split,
                                      int splits, int rows_per_pass, int dtype, void* stream) {
  if (!plan_ok(M, K, N, k_per_split, splits, kMatmulKQuantum, rows_per_pass) ||
      (splits > 1 && (part == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  cudaError_t e =
      dtype == DT_F32
          ? launch_typed<float>(x, w, out, p, c, M, K, N, k_per_split, splits, rows_per_pass, st)
      : dtype == DT_BF16 ? launch_typed<__nv_bfloat16>(x, w, out, p, c, M, K, N, k_per_split,
                                                       splits, rows_per_pass, st)
                         : cudaErrorInvalidValue;
  return (int)e;
}

// Weight streams for Hopper (sm_90a): the one design behind fused_swiglu.cu
// and int4_matmul.cu.
//
// Each kernel is a skinny product: M = 1..16 rows of x (a decode step, a
// chain verify, a short prompt) against a row-major [K, N] weight that is
// read once — two bf16 or f32 matrices for fused_swiglu, one packed int4
// matrix with its scales and zeros for int4_matmul.  Each weight byte feeds
// at most 2*M multiply-adds, far below the card's ~295 (bf16) or ~20 (f32)
// operations per byte of HBM, so what bounds them is bytes: the weight has
// to leave device memory at close to 3.35 TB/s.  The design:
//
// * Every SM streams.  The grid is (row tiles of at most 16, N / 256
//   column tiles, K splits); row tiles come first, so the blocks of one
//   (column tile, split) run side by side and share their weight in L2.
//   The split, ops.stream_plan, is a function of K, N and the quantum of K
//   (the group size for int4, kSwigluKQuantum for fused_swiglu) alone —
//   never of M — and aims at two blocks of eight warps on each of the 132
//   SMs, all resident at once: a block's work is the same everywhere, so a
//   second wave would stream alone.  A split holds at most 1024 values of K,
//   so that x fits in shared memory.
// * Enough bytes in flight.  A ring of kStages stages in shared memory is
//   filled by 16-byte cp.async (zero-filled past K and past N, where the
//   source size is 0): kStages - 1 stages, 24-48 KB per block, are in flight
//   while one is consumed.  x for the block's whole K range (and int4's
//   scales and zeros, with the first stage) is staged once before the loop,
//   so no barrier drains the ring at fixed intervals of K; the one barrier
//   per stage only hands a slot back.  Shared memory is used unpadded and
//   128-byte aligned: a 16-byte offset of the ring made the f32 kernels a
//   tenth slower, padded and offset rows the int4 stream a sixth slower
//   (NVIDIA H100 80GB HBM3, tools/weight_stream_variants.py).  Where lanes read the
//   same columns of neighbouring rows, the rows' 16-byte granules are
//   permuted instead (Swz).  With the arithmetic removed, the stream reads
//   the bf16 8B gate and up weights (235 MB) in 0.095 ms and the f32 ones
//   (470 MB) in 0.174 ms, as fast as torch.sum reads them.
// * Few instructions per byte.  bf16 runs on tensor cores
//   (mma.sync.m16n8k16, f32 accumulate) fed by ldmatrix: x is the A operand,
//   16 rows (rows past M repeat row 0 and are never stored: an MMA row's
//   result does not depend on the other rows), the weight tile the B
//   operand.  f32 runs on CUDA cores (TF32 would break the f32 tolerance)
//   with a row tile MT of 1, 2, 4, 8 or 16, the fewest that hold M, so no
//   FMA is spent on a row of zeros.
//
// The split-K sum is combined inside the kernel: with one split the block
// writes its result; with several, each block writes an f32 partial
// [split, part, row, column], takes an atomic ticket on a zeroed counter of
// its (row tile, column tile), and the last to arrive resets the counter and
// adds the partials in split order (attention.cuh's pattern; the counters
// are ops._tickets', kept per device and stream).  Every output element is
// therefore summed over K in one order that depends on K, N and the quantum
// alone — warps in a fixed order inside a split, splits in split order,
// never M, the arrival order or float atomics: a row computed alone equals
// the same row in a batch, and two calls are equal, bit for bit.
// tools/weight_stream_variants.py times the kernels with the arithmetic,
// the combine or the whole body removed.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps
constexpr int kTileN = 256;    // output columns per block (ops._STREAM_TILE_N)
constexpr int kRowTile = 16;    // rows of x per block at most: the m16 of one MMA
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// one launch's rows, depth, columns and split of K
struct Split {
  int M, K, N;  // rows of x in this launch, depth, output columns
  int k_per_split, splits;
  float* part;    // [splits, parts, M, ldp] f32; unused with one split
  int* counters;  // one per (row tile, column tile), zero between launches
  int ldp;        // row stride of the partials: N rounded up to 4
};

// a block's place: first column, first row, live rows, split, K range
struct Block {
  int n0, m0, rows, split, kb0, kb1;
};

__device__ __forceinline__ Block block_of(const Split& s, int row_tile) {
  Block b;
  b.m0 = blockIdx.x * row_tile;  // row tiles next to each other: they share the weight in L2
  b.n0 = blockIdx.y * kTileN;
  b.split = blockIdx.z;
  b.rows = min(row_tile, s.M - b.m0);
  b.kb0 = b.split * s.k_per_split;
  b.kb1 = min(s.K, b.kb0 + s.k_per_split);
  return b;
}

// Byte c of shared row r, the row's 16-byte granules permuted by r mod kR:
// granule j holds granule j ^ ((r mod kR) << kS).  Lanes that read the same
// columns of kR neighbouring rows then fall in distinct banks without padding
// the rows, which would cost each copied row its 128-byte alignment.
// Swz<1, 0> is the identity.
template <int kR, int kS>
struct Swz {
  __device__ __forceinline__ static int at(int r, int c) {
    return c ^ ((r & (kR - 1)) << (4 + kS));
  }
};
using NoSwz = Swz<1, 0>;

// rows [r0, r0 + R) of a row-major byte matrix (row stride ld), bytes
// [c0, c0 + RB) of each, into shared memory (row stride lds), by GR-byte
// cp.async; rows >= r_end and bytes >= c_end are zero-filled.  GR divides
// c_end - c0, so a granule is all in or all out.
template <int GR, int RB, class Z = NoSwz>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int lds, const void* src_,
                                          long long ld, int r0, int R, int r_end, int c0,
                                          int c_end) {
  constexpr int G = RB / GR;  // granules per row
  const unsigned char* src = static_cast<const unsigned char*>(src_);
  for (int i = threadIdx.x; i < R * G; i += kThreads) {
    const int r = i / G, c = (i % G) * GR;
    const bool ok = r0 + r < r_end && c0 + c < c_end;
    cp_async<GR>(dst + r * lds + Z::at(r, c), ok ? src + (r0 + r) * ld + c0 + c : src, ok);
  }
}

// the same by plain byte loads: a base or a width that no 16-byte copy fits
template <int RB, class Z = NoSwz>
__device__ __forceinline__ void copy_rows_bytes(unsigned char* dst, int lds, const void* src_,
                                                long long ld, int r0, int R, int r_end, int c0,
                                                int c_end) {
  const unsigned char* src = static_cast<const unsigned char*>(src_);
  for (int i = threadIdx.x; i < R * RB; i += kThreads) {
    const int r = i / RB, c = i % RB;
    dst[r * lds + Z::at(r, c)] =
        r0 + r < r_end && c0 + c < c_end ? src[(r0 + r) * ld + c0 + c] : 0;
  }
}

// A bf16 weight's rows by GR-byte cp.async, or by plain byte loads for GR 1
// (an odd N, whose rows are not 4-byte aligned)
template <int GR, int RB, class Z>
__device__ __forceinline__ void copy_weight_rows(unsigned char* dst, int lds, const void* src,
                                                 long long ld, int r0, int R, int r_end, int c0,
                                                 int c_end) {
  if constexpr (GR == 1)
    copy_rows_bytes<RB, Z>(dst, lds, src, ld, r0, R, r_end, c0, c_end);
  else
    copy_rows<GR, RB, Z>(dst, lds, src, ld, r0, R, r_end, c0, c_end);
}

// x rows [m0, m0 + R) of x [M, K] over the K range [kb0, kb0 + KR) as bf16
// rows of stride ldx (the MMA's A operand); zeros past kb1 and past M.
// vec: K % 8 == 0 and x 16-byte aligned (8 values per load).
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* xs, int ldx, int R, int KR,
                                                const __nv_bfloat16* x, int K, int M, int m0,
                                                int kb0, int kb1, bool vec) {
  if (vec) {
    const int G = KR / 8;
    for (int i = threadIdx.x; i < R * G; i += kThreads) {
      const int r = i / G, c = (i % G) * 8, k = kb0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k < kb1)
        v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + k);
      *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < R * KR; i += kThreads) {
      const int r = i / KR, c = i % KR, k = kb0 + c;
      xs[r * ldx + c] = m0 + r < M && k < kb1 ? x[(long long)(m0 + r) * K + k]
                                              : __float2bfloat16_rn(0.f);
    }
  }
}

// x rows [m0, m0 + MT) over [kb0, kb0 + KR) as f32, k-major: xs[kl * MT + r]
// (a k step reads its MT values in one vector); zeros past kb1 and past M.
// A thread loads four neighbouring values of one row, then stores them.
template <typename T, int MT>
__device__ __forceinline__ void stage_cols_f32(float* xs, int KR, const T* x, int K, int M,
                                               int m0, int kb0, int kb1) {
#pragma unroll 4
  for (int i = threadIdx.x; i < KR / 4 * MT; i += kThreads) {
    const int r = i % MT, kq = 4 * (i / MT);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (m0 + r < M) {
      const T* xr = x + (long long)(m0 + r) * K + kb0 + kq;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kb0 + kq + j < kb1) v[j] = to_f32(xr[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[(kq + j) * MT + r] = v[j];
  }
}

// the MT values of one k step of stage_cols_f32's layout
template <int MT>
__device__ __forceinline__ void load_x(float (&v)[MT], const float* p) {
  if constexpr (MT == 1) {
    v[0] = p[0];
  } else if constexpr (MT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int r = 0; r < MT; r += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + r);
      v[r] = t.x;
      v[r + 1] = t.y;
      v[r + 2] = t.z;
      v[r + 3] = t.w;
    }
  }
}

// The output of one element from its P complete sums
template <class Op>
__device__ __forceinline__ void store_out(typename Op::T* out, int N, int row, int col,
                                          const float* v, int w, int i) {
  float e[Op::P];
#pragma unroll
  for (int p = 0; p < Op::P; ++p) e[p] = v[p * w + i];
  out[(long long)row * N + col] = from_f32<typename Op::T>(Op::value(e));
}

// The last block of a (row tile, column tile) adds the splits' partials in
// split order and stores the output.  Out of line, on scalars only: inlined,
// its code made the f32 kernels' main loops slower by a tenth
// (tools/weight_stream_variants.py, no-combine against kernel).
template <class Op>
__device__ __noinline__ void combine_splits(typename Op::T* out, const float* part, int M, int N,
                                            int ldp, int splits, int m0, int n0, int rows) {
  constexpr int P = Op::P;
  for (int i = threadIdx.x; i < rows * (kTileN / 4); i += kThreads) {
    const int row = m0 + i / (kTileN / 4), col = n0 + (i % (kTileN / 4)) * 4;
    if (col >= N) continue;
    float v[P * 4];
#pragma unroll
    for (int j = 0; j < P * 4; ++j) v[j] = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s)
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float* src = part + (((long long)s * P + p) * M + row) * ldp + col;
        const float4 t = __ldcg(reinterpret_cast<const float4*>(src));
        v[p * 4] += t.x;
        v[p * 4 + 1] += t.y;
        v[p * 4 + 2] += t.z;
        v[p * 4 + 3] += t.w;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) store_out<Op>(out, N, row, col + j, v, 4, j);
  }
}

// The kernel of every weight stream.  Op (one per path, in the .cu files)
// supplies: Args (with a Split sp and an output pointer out), T, P (parts of
// the result: 2 for fused_swiglu's g and u, 1 for int4),
// kStages, kRows; a constructor on (args, dynamic shared memory) that places the block
// (member b); steps() (ring stages of the block); load_stage(step, slot)
// (the stage's cp.async, no commit); stage_x(); compute(step, slot);
// finish(); emit(f), which calls f(row, column, width, values[P][width]) for
// each group of neighbouring columns it holds; and value(v[P]), the output
// of one element's complete sums.
template <class Op>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks on each SM
    stream_kernel(const typename Op::Args a) {
  // no static shared memory, and 128-byte alignment: a ring row of f32 or
  // packed int4 then starts a 128-byte wavefront (a 16-byte offset made the
  // f32 kernels a tenth slower)
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = Op::P, S = Op::kStages;
  Op op(a, smem);
  const int steps = op.steps();
  // the ring: S - 1 stages in flight before the first is consumed
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) op.load_stage(s, s);
    cp_async_commit();
  }
  op.stage_x();
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();  // stage it has landed
    __syncthreads();         // ... for every thread, and slot (it - 1) % S is free
    if (it + S - 1 < steps) op.load_stage(it + S - 1, (it + S - 1) % S);
    cp_async_commit();
    op.compute(it, it % S);
  }
  cp_async_wait<0>();
  __syncthreads();
  op.finish();

  const Split& sp = a.sp;
  const Block& b = op.b;
  // one split: the block's sums are the result
  auto store = [&](int r, int c, auto width, const float* v) {
    constexpr int W = decltype(width)::value;
    const int row = b.m0 + r, col = b.n0 + c;
    if (r >= b.rows || col >= sp.N) return;
    if (sp.splits == 1) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (col + i < sp.N) store_out<Op>(a.out, sp.N, row, col + i, v, W, i);
      return;
    }
    // several: the split's partial (columns up to ldp, a multiple of 4, exist)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float* dst = sp.part + (((long long)b.split * P + p) * sp.M + row) * sp.ldp + col;
      if constexpr (W == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(v[p * 4], v[p * 4 + 1], v[p * 4 + 2],
                                                      v[p * 4 + 3]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(v[p * 2], v[p * 2 + 1]);
    }
  };
  op.emit(store);
  if (sp.splits == 1) return;

  // the last block of the (row tile, column tile) to finish adds the splits
  __threadfence();
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    int* ctr = sp.counters + blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(ctr, 1) == sp.splits - 1;
    if (last) *ctr = 0;  // every split has counted: zero for the next launch
  }
  if (!__syncthreads_or(last)) return;
  __threadfence();
  combine_splits<Op>(a.out, sp.part, sp.M, sp.N, sp.ldp, sp.splits, b.m0, b.n0, b.rows);
}

// Launch Op's kernel on grid (column tiles, splits, row tiles) with smem
// bytes of dynamic shared memory.
template <class Op>
cudaError_t launch_op(const typename Op::Args& a, int smem, cudaStream_t stream) {
  static int allowed[kMaxCards] = {};  // the most dynamic shared memory, per card
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = stream_kernel<Op>;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const Split& s = a.sp;
  dim3 grid((s.M + Op::kRows - 1) / Op::kRows, (s.N + kTileN - 1) / kTileN, s.splits);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The launch plan's checks, shared by the two libraries: whole quanta per
// split, splits covering K and no more, the grid's limits.
inline bool plan_ok(int M, int K, int N, int k_per_split, int splits, int quantum,
                    int rows_per_pass) {
  return M > 0 && K > 0 && N > 0 && quantum > 0 && k_per_split > 0 &&
         k_per_split % quantum == 0 && splits == (K + k_per_split - 1) / k_per_split &&
         splits <= 65535 && (N + kTileN - 1) / kTileN <= 65535 && rows_per_pass > 0 &&
         rows_per_pass % kRowTile == 0;
}

}  // namespace

// The serving product for Hopper (sm_90a): out = x @ w, row-invariant.
//
// Replaces no Pallas kernel.  The reference leaves these products to XLA's
// dot (src/repro/models/attention.py's q/k/v/o projections, the MLP's down
// projection, the lm_head); the port had left them to torch.matmul, whose
// cuBLAS kernels choose their order of summation over K by the number of
// rows, M.  In bf16 that gave a row other bits among 16 rows than alone,
// and the tree engine's verify (a row among n) then read other logits than
// the greedy decode (the row alone), breaking its contract that the
// speculative output is the greedy decode.
//
// The order of summation, the same for every M.  The plan (ops.matmul_plan:
// a column tile, K per split and S splits, a function of K, N and the dtype
// alone) cuts K into S splits of k_per_split.  Within a split, K is walked
// in fixed steps in order into a zeroed f32 accumulator: in bf16 by k16
// steps of one instruction, wgmma.mma_async m64nTk16 (T the column tile; the
// split's first step with scale-d 0), in f32 by one fmaf a value of K.  The
// splits' sums are then added in split order with one association,
// ((p0 + p1) + p2) + ...  Nothing depends on M, on which rows share a tile
// (an MMA row's sums do not depend on its other rows), on arrival order or
// on float atomics: a row computed alone equals the same row among any
// number of rows, bit for bit, and two calls are equal.
//
// Two ways to run that order:
// * split in a cluster (bf16 M <= 64, f32 every M): the S splits of a
//   column tile are the S CTAs of one thread-block cluster (S <= 8, a
//   portable cluster).  Each leaves its f32 tile in its own shared memory;
//   after a cluster barrier, rank r adds the r-th slice of the tile's
//   columns over ranks 0..S-1 in rank order, through distributed shared
//   memory, and stores it.  Nothing but the output is written to device
//   memory: no partials, no tickets, no last-arriver pass.  With one split
//   (the lm_heads) there is nothing to add: one wave of CTAs walks the
//   column tiles and stores each from its registers.
// * walked by one CTA (bf16 M > 64): one CTA per (128-row tile, column
//   tile) walks all S splits itself, with a split accumulator and a
//   running total in registers: total = p0, then total += p_s at each
//   split's end, the association of the cluster's combine.  Row tiles lie
//   next to each other in the grid, so they read a column tile of the
//   weight from L2; nothing but the output is written.
//
// bf16, on the tensor cores.  x is wgmma's A operand (K-major), the weight
// tile its B operand (the weight is row-major [K, N], so B is MN-major,
// which wgmma takes for 16-bit types), both in the 128-byte-swizzled layout
// that TMA writes.  One producer warp keeps a ring of stages (64 values of K
// of x and of the weight tile) in flight by TMA into an mbarrier ring; one
// consumer warpgroup per 64 rows issues the stage's four k16 wgmmas.  x's
// tile is 64 rows (two warpgroups, 128 rows, sharing each weight stage when
// M > 64); a stage loads 16 of them to 16 rows, 64 to 64, rows past M
// zero-filled by TMA, and no row past M is stored.  The weight tile is T =
// 64 or 128 columns (128 from N >= 2048): n256 would leave the walked
// regime no registers for its running total.  At M <= 16 the tensor cores
// do 4 x the work of mma.sync.m16n8k16, still far below the ~295
// operations a byte at which bf16 stops being byte-bound; what counts there
// is bytes in flight, so the plans aim at one wave of one CTA an SM (more
// CTAs, each with a shorter K, were slower) with rings of 3-8 stages of
// 10-24 KB.
// TMA needs K and N multiples of 8 (16-byte row strides); ops.stream_matmul
// refuses other bf16 shapes by name (no serving path on the card passes
// one).
//
// f32, on CUDA cores (no TF32: the f32 tolerance).  To 16 rows a thread
// owns one column of the tile (T = 64, 128 or 256 threads) and MT = 1, 2,
// 4, 8 or 16 rows, the fewest that hold M; 16-value stages of the weight
// tile and of x in a cp.async ring.  Beyond, 128 x 128 tiles, 8 x 8 outputs
// a thread, x and the weight staged through shared memory 8 values of K at
// a time; each output's chain of fmaf is the same, and so are the splits
// and their combine.
//
// What bounds it: bytes at the serving paths' M = 1..16 (each weight value
// feeds 2M operations against the card's ~295 (bf16) or ~20 (f32)
// operations a byte of HBM), operations in a long prefill's M = 512.
//
// The batched form, x [G, M, K] @ w [G, K, N] -> out [G, M, N] in one launch
// (ops.stream_bmm): the grid's z axis walks the G groups, and group g's CTAs
// run the plan above on its own x, weight and output.  It replaces the
// family-specific batched products the port had left to torch.bmm and
// einsum: the MoE's experts (the reference's einsum("ecd,edf->ecf"), whose
// M is the capacity and moves with the forward's rows), rwkv6's four
// token-shift projections, and MLA's per-head products with W_uk and W_uv.
// Each group sums in the order of ops.matmul_plan(K, N, dtype), never of M
// or G.  Every launch, one group or several, reads x and the weight through
// 3-D tensor maps (bf16; [G, M, K] and [G, K, N], a group's rows past M
// zero-filled) or group-strided pointers (f32); the plain product is the
// batched one with G = 1.
#include <cooperative_groups.h>
#include <cuda.h>

#include <utility>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterMax = 8;  // splits at most: one portable cluster (ops._MATMUL_CLUSTER)
constexpr int kBK = 64;         // bf16: K a stage, one 128-byte swizzle row of x (ops quantum)
constexpr int kKT = 16;         // f32: K a stage of the skinny ring (ops quantum)
constexpr int kBf16Skinny = 64;  // bf16: the skinny regime's rows at most, one wgmma tile
constexpr int kF32Skinny = 16;   // f32: the skinny regime's rows at most
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use on sm_90

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// one launch's shape and plan (ops.matmul_plan)
struct Plan {
  int M, K, N;
  int tile_n;       // columns of a column tile
  int k_per_split;  // a multiple of the stage's K
  int splits;       // 1, 2, 4 or 8: ceil(K / k_per_split)
  int G;            // groups: the grid's z axis (1 for the plain product)
};

// ---- the split combine through distributed shared memory ------------------------

__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v, int room) {
  // room >= 4: the bf16 path's N is a multiple of 8 and v's columns a multiple of 4
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(o) = u;
}
__device__ __forceinline__ void store4(float* o, float4 v, int room) {
  if (room >= 4 && reinterpret_cast<uintptr_t>(o) % 16 == 0) {
    *reinterpret_cast<float4*>(o) = v;
    return;
  }
  o[0] = v.x;
  if (room > 1) o[1] = v.y;
  if (room > 2) o[2] = v.z;
  if (room > 3) o[3] = v.w;
}

// Every CTA of the cluster holds its split's f32 tile P [rows][ldp] (tn
// columns) in its own shared memory.  Rank r adds columns [r tn / S, (r + 1)
// tn / S) over ranks 0..S-1 in rank order and stores rows < rows of them at
// out[row, n0 + column].  Called by every thread of every CTA.
template <typename T>
__device__ __forceinline__ void cluster_combine(float* P, int ldp, int rows, int tn, T* out,
                                                int N, int n0) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every rank's tile is in its shared memory
  const int S = (int)cl.num_blocks(), r = (int)cl.block_rank();
  const int cw = tn / S, groups = cw / 4, c0 = r * cw;
  for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
    const int row = i / groups, c = c0 + (i % groups) * 4, col = n0 + c;
    if (col >= N) continue;
    // every rank's four values in flight at once, then the adds in rank order
    float4 v[kClusterMax];
#pragma unroll
    for (int q = 0; q < kClusterMax; ++q)
      if (q < S) v[q] = *reinterpret_cast<const float4*>(cl.map_shared_rank(P, q) + row * ldp + c);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < kClusterMax; ++q)
      if (q < S) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    store4(out + (long long)row * N + col, s, N - col);
  }
  cl.sync();  // no rank leaves while another reads its tile
}

// ---- bf16: TMA, mbarriers and wgmma ---------------------------------------------

// mbar_wait with a bound: a ring stage that never completes (a tensor map
// that does not match the kernel, say) traps, and the launch's stream
// reports the error, instead of spinning on the card for ever
__device__ __forceinline__ void ring_wait(uint64_t* bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned ok = 0;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (ok) return;
    if (n == (1u << 26)) __trap();
  }
}

// the descriptor of a wgmma operand in shared memory in the 128-byte swizzle
// that TMA's CU_TENSOR_MAP_SWIZZLE_128B writes: start address, leading and
// stride byte offsets in 16-byte units, layout type 1 (128B)
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) | ((uint64_t)(lbo & 0x3FFFu) << 16) |
         ((uint64_t)(sbo & 0x3FFFu) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a (64 x 16, K-major) * b (16 x T, MN-major), both read from shared
// memory through their descriptors (imm-trans-b 1); d = a * b where scale_d is 0
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// shared memory of a bf16 CTA: S stages of [x: XR rows x 128 bytes][weight:
// T / 64 boxes of 64 rows of K x 128 bytes], 1024-aligned.  A warpgroup's
// wgmma reads 64 rows of x; with XR 16 (M <= 16) its rows 16..63 are the
// stage's weight bytes, whose sums land in rows that are never stored (an
// MMA row's sums do not depend on its other rows), and a stage is 18 KB in
// place of 24
template <int T, int RW, int S, int XR>
struct Bf16Tile {
  static constexpr int kStages = S;
  static constexpr int kABytes = XR * 128;
  static constexpr int kBBytes = kBK * T * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kThreads = RW * 128 + 32;  // consumers, then the producer warp
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + the alignment to 1024
  static constexpr int kLdp = T + 8;  // the split combine's tile row, in the spent ring
  static_assert(XR * kLdp * 4 <= kStages * kStageBytes, "the combine's tile reuses the ring");
};

// element i of a warpgroup's m64nTk16 accumulator: row 16 warp + lane / 4 + 8
// ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2; rows m0 + row < M
// of columns n0 + column < N stored as bf16
template <int R>
__device__ __forceinline__ void store_acc(const float (&d)[R], __nv_bfloat16* out, int M, int N,
                                          int m0, int n0) {
  const int lane = threadIdx.x % 32, r0 = m0 + threadIdx.x % 128 / 32 * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r0 + 8 * h) * N + col) =
            __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// x [G, M, K] (tensor map tx, box 64 x XR x 1) @ w [G, K, N] (tw, box 64 x
// 64 x 1) -> out [G, M, N], group blockIdx.z.  SKINNY (RW 1): grid (splits,
// C, G), a cluster of the splits; with several splits C is the column tiles
// and the cluster adds them (cluster_combine); with one a CTA walks column
// tiles blockIdx.y, + C, ... (one wave of CTAs a group, the ring running on
// from one tile into the next) and stores each from its registers.  Fat (RW
// 2): grid (row tiles of 128, column tiles, G), each CTA walking every split.
template <int T, int RW, bool SKINNY, int STAGES, int XR>
__global__ void __launch_bounds__(RW * 128 + 32)
    matmul_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw, __nv_bfloat16* __restrict__ out,
                       const Plan p) {
  using L = Bf16Tile<T, RW, STAGES, XR>;
  constexpr int kS = L::kStages;
  __shared__ __align__(8) uint64_t full[kS], empty[kS];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles = cdiv(p.N, T), g = blockIdx.z;
  out += (long long)g * p.M * p.N;
  const int m0 = SKINNY ? 0 : blockIdx.x * 64 * RW;
  const int s_lo = SKINNY ? blockIdx.x : 0, s_hi = SKINNY ? blockIdx.x + 1 : p.splits;
  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * RW);  // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == RW) {
    // the producer warp: its first lane keeps kS stages in flight
    if (tid % 32 == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
      int it = 0;
      for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y)
        for (int s = s_lo; s < s_hi; ++s) {
          const int kb1 = min(p.K, (s + 1) * p.k_per_split);
          for (int k0 = s * p.k_per_split; k0 < kb1; k0 += kBK, ++it) {
            const int st = it % kS;
            ring_wait(&empty[st], ((it / kS) & 1) ^ 1);  // the first round passes
            unsigned char* a = smem + st * L::kStageBytes;
            mbar_expect_tx(&full[st], L::kStageBytes);
            tma_load_3d(a, &tx, k0, m0, g, &full[st]);
#pragma unroll
            for (int h = 0; h < T / 64; ++h)
              tma_load_3d(a + L::kABytes + h * kBK * 128, &tw, tile * T + 64 * h, k0, g,
                          &full[st]);
          }
        }
    }
    __syncwarp();
  } else {
    // consumer warpgroup wg: rows m0 + 64 wg .. + 63
    const int lane = tid % 32;
    const unsigned base = smem_u32(smem);
    float acc[T / 2];
    float total[SKINNY ? 1 : T / 2];
#pragma unroll
    for (int i = 0; i < T / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
      for (int s = s_lo; s < s_hi; ++s) {
        const int kb1 = min(p.K, (s + 1) * p.k_per_split);
        int first = 1;
        for (int k0 = s * p.k_per_split; k0 < kb1; k0 += kBK, ++it) {
          const int st = it % kS;
          ring_wait(&full[st], (it / kS) & 1);
          const unsigned a = base + st * L::kStageBytes + wg * 64 * 128;
          const unsigned b = base + st * L::kStageBytes + L::kABytes;
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < kBK / 16; ++t)
            // x: the k16 step is 32 bytes into each 128-byte row (8-row groups
            // 1024 bytes apart); the weight: 16 rows of 128 bytes, its 64-column
            // boxes kBK * 128 bytes apart
            wgmma_bf16(acc, sw128_desc(a + 32 * t, 1, 64),
                       sw128_desc(b + 2048 * t, kBK * 128 / 16, 64), first && t == 0 ? 0 : 1);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(acc);
          first = 0;
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
        }
        if constexpr (!SKINNY) {
          // the split's sum joins the running total, in split order
#pragma unroll
          for (int i = 0; i < T / 2; ++i) total[i] = s == 0 ? acc[i] : total[i] + acc[i];
        }
      }
      if constexpr (SKINNY) {
        if (p.splits == 1) {
          store_acc(acc, out, p.M, p.N, 0, tile * T);
        } else {
          // the split's tile (rows < M) into this CTA's shared memory: the ring is
          // spent, since a CTA of several splits takes one tile
          float* P = reinterpret_cast<float*>(smem);
          const int r0 = tid % 128 / 32 * 16 + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
          for (int j = 0; j < T / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (r0 + 8 * h < p.M)
                *reinterpret_cast<float2*>(P + (r0 + 8 * h) * L::kLdp + 8 * j + c0) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      } else {
        store_acc(total, out + (long long)wg * 64 * p.N, p.M - wg * 64, p.N, m0, tile * T);
      }
    }
  }
  if (SKINNY && p.splits > 1)
    cluster_combine(reinterpret_cast<float*>(smem), L::kLdp, p.M, T, out, p.N, blockIdx.y * T);
}

// ---- f32 on CUDA cores ----------------------------------------------------------

// shared memory of a skinny f32 CTA: kStages stages of [weight: kKT rows x T
// columns][x: MT rows x kKT values of K]
template <int MT, int T>
struct F32Tile {
  static constexpr int kStages = 6;
  static constexpr int kWBytes = kKT * T * 4;
  static constexpr int kStageBytes = kWBytes + MT * kKT * 4;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kLdp = T + 4;  // the combine's tile row
  static_assert(MT * kLdp * 4 <= kSmem, "the combine's tile reuses the ring");
};

// x [G, M, K] @ w [G, K, N] -> out [G, M, N], M <= MT; grid (splits, column
// tiles, G), a cluster of the splits; thread t owns column n0 + t of group
// blockIdx.z.  GR: bytes a cp.async of a weight row (16 where N % 4 == 0,
// else 4); x_vec: x rows by 16 bytes (K % 4 == 0 and x 16-byte aligned).
template <int MT, int T, int GR>
__global__ void __launch_bounds__(T)
    matmul_f32_skinny(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, const Plan p, const int x_vec) {
  using L = F32Tile<MT, T>;
  constexpr int kS = L::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, n0 = blockIdx.y * T;
  const long long g = blockIdx.z;
  x += g * p.M * p.K;
  w += g * p.K * p.N;
  out += g * p.M * p.N;
  const int kb0 = blockIdx.x * p.k_per_split, kb1 = min(p.K, kb0 + p.k_per_split);
  const int steps = cdiv(kb1 - kb0, kKT);

  auto load = [&](int step, int slot) {
    unsigned char* dst = smem + slot * L::kStageBytes;
    const int k0 = kb0 + step * kKT;
    constexpr int G = T * 4 / GR;  // granules of a weight row
    for (int i = tid; i < kKT * G; i += T) {
      const int r = i / G, c = (i % G) * (GR / 4);
      const bool ok = k0 + r < kb1 && n0 + c < p.N;
      cp_async<GR>(dst + (r * T + c) * 4, ok ? w + (long long)(k0 + r) * p.N + n0 + c : w, ok);
    }
    float* xs = reinterpret_cast<float*>(dst + L::kWBytes);  // [MT][kKT]
    if (x_vec) {
      for (int i = tid; i < MT * (kKT / 4); i += T) {
        const int r = i / (kKT / 4), c = (i % (kKT / 4)) * 4;
        const bool ok = r < p.M && k0 + c < kb1;
        cp_async<16>(xs + r * kKT + c, ok ? x + (long long)r * p.K + k0 + c : x, ok);
      }
    } else {
      for (int i = tid; i < MT * kKT; i += T) {
        const int r = i / kKT, c = i % kKT;
        const bool ok = r < p.M && k0 + c < kb1;
        cp_async<4>(xs + r * kKT + c, ok ? x + (long long)r * p.K + k0 + c : x, ok);
      }
    }
  };

  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.f;
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kS - 2>();  // stage it has landed
    __syncthreads();          // ... for every thread, and slot (it - 1) % kS is free
    if (it + kS - 1 < steps) load(it + kS - 1, (it + kS - 1) % kS);
    cp_async_commit();
    const float* ws = reinterpret_cast<const float*>(smem + (it % kS) * L::kStageBytes);
    const float* xs = ws + kKT * T;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 4) {
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[(kk + j) * T + tid];
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * kKT + kk);
        acc[r] = fmaf(xv.x, wv[0], acc[r]);
        acc[r] = fmaf(xv.y, wv[1], acc[r]);
        acc[r] = fmaf(xv.z, wv[2], acc[r]);
        acc[r] = fmaf(xv.w, wv[3], acc[r]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is spent: the split's tile takes its place
  float* P = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < MT; ++r) P[r * L::kLdp + tid] = acc[r];
  cluster_combine(P, L::kLdp, p.M, T, out, p.N, n0);
}

constexpr int kFatM = 128, kFatN = 128, kFatK = 8, kFatThreads = 256;
constexpr int kFatLdp = kFatN + 4;             // the combine's tile row
constexpr int kFatSmem = kFatM * kFatLdp * 4;  // a split's tile, or the running total

// x [G, M, K] @ w [G, K, N] -> out for M > 16, 128 x 128 tiles; with
// BATCHED the grid's z is (group, row tile), group-major, else the row tile
// of the one group (the group offsets cost registers, of the 128 a thread
// that two CTAs an SM leave: with them the plain product spilled and ran
// 1.3 x slower at M 512).  !WALK: grid
// (splits, column tiles, G x row tiles), a cluster of the splits: each CTA sums
// its split for the tile and the cluster adds the splits as the skinny
// regime does.  WALK: grid (1, column tiles, row tiles): each CTA walks the
// splits in order and keeps the running total in shared memory, each
// thread in its own slots, total = p0, then total += p_s.  Thread (ty, tx)
// = (t / 16, t % 16) owns rows 4 ty + {0..3} and 64 + 4 ty + {0..3},
// columns 4 tx + {0..3} and 64 + 4 tx + {0..3}.  x_vec / w_vec: rows of x /
// w load by 16 bytes (K / N a multiple of 4, the base 16-byte aligned).
template <bool WALK, bool BATCHED>
__global__ void __launch_bounds__(kFatThreads, 2)
    matmul_f32_fat(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, const Plan p, const int x_vec, const int w_vec) {
  __shared__ __align__(16) float As[2][kFatK][kFatM];  // x, k-major
  __shared__ __align__(16) float Bs[2][kFatK][kFatN];
  extern __shared__ __align__(16) float P[];  // [kFatM][kFatLdp]: a split's tile or the total
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  int rt = blockIdx.z;
  if constexpr (BATCHED) {
    const int row_tiles = cdiv(p.M, kFatM);
    const long long g = blockIdx.z / row_tiles;
    x += g * p.M * p.K;
    w += g * p.K * p.N;
    out += g * p.M * p.N;
    rt = blockIdx.z % row_tiles;
  }
  const int n0 = blockIdx.y * kFatN, m0 = rt * kFatM;
  // this thread's loads: x row m0 + tid / 2, K values 4 (tid % 2) ..; weight
  // row tid / 32 of the tile, columns 4 (tid % 32) ..
  const int xr = tid / 2, xk = (tid % 2) * 4, wr = tid / 32, wc = (tid % 32) * 4;
  int kb1 = 0;  // the current split's end
  float xa[4], wb[4];
  auto fetch = [&](int k0) {
    const int row = m0 + xr, k = k0 + xk;
    if (x_vec && row < p.M && k < kb1) {  // K % 4 == 0: the four are in or out together
      const float4 v = *reinterpret_cast<const float4*>(x + (long long)row * p.K + k);
      xa[0] = v.x, xa[1] = v.y, xa[2] = v.z, xa[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xa[j] = row < p.M && k + j < kb1 ? x[(long long)row * p.K + k + j] : 0.f;
    }
    const int kw = k0 + wr, col = n0 + wc;
    if (w_vec && kw < kb1 && col < p.N) {  // N % 4 == 0
      const float4 v = *reinterpret_cast<const float4*>(w + (long long)kw * p.N + col);
      wb[0] = v.x, wb[1] = v.y, wb[2] = v.z, wb[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wb[j] = kw < kb1 && col + j < p.N ? w[(long long)kw * p.N + col + j] : 0.f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][xk + j][xr] = xa[j];
    *reinterpret_cast<float4*>(&Bs[buf][wr][wc]) = make_float4(wb[0], wb[1], wb[2], wb[3]);
  };
  // tile row of this thread's row r, and the offset of its output (r, c)
  auto row_of = [&](int r) { return r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4; };
  auto at = [&](int r, int c) { return row_of(r) * kFatLdp + (c < 4 ? 0 : 64) + 4 * tx + c % 4; };

  float acc[8][8];
  const int s_lo = WALK ? 0 : blockIdx.x, s_hi = WALK ? p.splits : blockIdx.x + 1;
  for (int s = s_lo; s < s_hi; ++s) {
    const int kb0 = s * p.k_per_split;
    kb1 = min(p.K, kb0 + p.k_per_split);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    const int tiles = cdiv(kb1 - kb0, kFatK);
    fetch(kb0);
    put(0);
    __syncthreads();
    for (int i = 0; i < tiles; ++i) {
      if (i + 1 < tiles) fetch(kb0 + (i + 1) * kFatK);
      const int buf = i % 2;
#pragma unroll
      for (int kk = 0; kk < kFatK; ++kk) {
        float a[8], b[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
        a[0] = a0.x, a[1] = a0.y, a[2] = a0.z, a[3] = a0.w;
        a[4] = a1.x, a[5] = a1.y, a[6] = a1.z, a[7] = a1.w;
        b[0] = b0.x, b[1] = b0.y, b[2] = b0.z, b[3] = b0.w;
        b[4] = b1.x, b[5] = b1.y, b[6] = b1.z, b[7] = b1.w;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      if (i + 1 < tiles) put((i + 1) % 2);
      __syncthreads();
    }
    // the split's tile (its sum joining the total, walking) into shared memory
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        P[at(r, c)] = WALK && s > 0 ? P[at(r, c)] + acc[r][c] : acc[r][c];
  }
  if constexpr (WALK) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = m0 + row_of(r);
      if (row >= p.M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 64 * h + 4 * tx;
        if (col < p.N)
          store4(out + (long long)row * p.N + col,
                 *reinterpret_cast<const float4*>(P + at(r, 4 * h)), p.N - col);
      }
    }
  } else {
    cluster_combine(P, kFatLdp, min(kFatM, p.M - m0), kFatN, out + (long long)m0 * p.N, p.N,
                    n0);
  }
}

// ---- host: tensor maps, launches, the plan's checks ------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no link
// against libcuda); nullptr where the driver lacks it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// G row-major bf16 [outer, inner] matrices, one after another, as a 3-D
// tensor map with a box of box_outer x 64 values (128 bytes, the swizzle's
// width) of one matrix, 128-byte swizzled; reads past a matrix's edge are
// zero-filled
cudaError_t bf16_map(CUtensorMap* m, const void* base, int inner, int outer, int G,
                     int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * outer * 2};
  const cuuint32_t box[3] = {64u, (cuuint32_t)box_outer, 1u};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// launch kKern on grid with smem bytes of dynamic shared memory; cluster > 0:
// thread-block clusters of (cluster, 1, 1)
template <auto kKern, typename... A>
cudaError_t launch(dim3 grid, int threads, int smem, int cluster, cudaStream_t st, A&&... args) {
  static int allowed[kMaxCards] = {};  // the kernel's most dynamic shared memory, per card
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kKern, smem, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (cluster > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kKern, std::forward<A>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the clusters of splits CTAs of kKern that the card can hold at once
template <auto kKern>
int max_clusters(int threads, int smem, int splits) {
  cudaError_t e = cudaFuncSetAttribute(kKern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(splits, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kKern, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// the current card's SMs, read once a card
cudaError_t sm_count(int* n) {
  static int count[kMaxCards] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxCards) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    e = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *n = count[dev];
  return cudaSuccess;
}

bool plan_ok(const Plan& p, int quantum) {
  return p.M > 0 && p.K > 0 && p.N > 0 && p.G > 0 && p.G <= 65535 && p.k_per_split > 0 &&
         p.k_per_split % quantum == 0 &&
         (p.splits == 1 || p.splits == 2 || p.splits == 4 || p.splits == kClusterMax) &&
         p.splits == cdiv(p.K, p.k_per_split) && cdiv(p.N, p.tile_n) <= 65535;
}

// The rings, by regime.  Several splits: 3 stages of 24 KB or 4 of 18 KB (T
// 128, M <= 64 or <= 16), 4 of 16 KB or 6 of 10 KB (T 64), 60-72 KB, so that
// a plan's up to 264 CTAs in clusters of 8 are all resident at once, two or
// three an SM.  One split: 8 stages, one CTA an SM walking the column tiles,
// 128-192 KB in flight an SM.  Walked: 4 stages of 32 KB.
template <int T, int XR>
struct Bf16Rings {
  static constexpr int kSplit = T == 128 ? (XR == 16 ? 4 : 3) : (XR == 16 ? 6 : 4);
  static constexpr int kWhole = 8, kWalked = 4;
};

template <int T, int XR>
cudaError_t launch_bf16_skinny(const CUtensorMap& tx, const CUtensorMap& tw,
                               __nv_bfloat16* o, const Plan& p, cudaStream_t st) {
  using R = Bf16Rings<T, XR>;
  const int tiles = cdiv(p.N, T);
  if (p.splits > 1) {
    using L = Bf16Tile<T, 1, R::kSplit, XR>;
    return launch<matmul_bf16_kernel<T, 1, true, R::kSplit, XR>>(
        dim3(p.splits, tiles, p.G), L::kThreads, L::kSmem, p.splits, st, tx, tw, o, p);
  }
  // one split: one wave of CTAs a group, one an SM, walks the group's tiles
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  using L = Bf16Tile<T, 1, R::kWhole, XR>;
  return launch<matmul_bf16_kernel<T, 1, true, R::kWhole, XR>>(
      dim3(1, min(tiles, sms), p.G), L::kThreads, L::kSmem, 1, st, tx, tw, o, p);
}

template <int T>
cudaError_t launch_bf16_tiled(const void* x, const void* w, void* out, const Plan& p,
                              cudaStream_t st) {
  // rows of x a stage loads: 16 to 16 rows (the tile's other rows are never
  // stored), the 64 of a warpgroup to 64, the 128 of two past 64
  const int xr = p.M <= 16 ? 16 : p.M <= kBf16Skinny ? 64 : 128;
  CUtensorMap tx, tw;
  cudaError_t e = bf16_map(&tx, x, p.K, p.M, p.G, xr);
  if (e == cudaSuccess) e = bf16_map(&tw, w, p.N, p.K, p.G, kBK);
  if (e != cudaSuccess) return e;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (xr == 16) return launch_bf16_skinny<T, 16>(tx, tw, o, p, st);
  if (xr == 64) return launch_bf16_skinny<T, 64>(tx, tw, o, p, st);
  using L = Bf16Tile<T, 2, Bf16Rings<T, 128>::kWalked, 128>;
  return launch<matmul_bf16_kernel<T, 2, false, Bf16Rings<T, 128>::kWalked, 128>>(
      dim3(cdiv(p.M, 128), cdiv(p.N, T), p.G), L::kThreads, L::kSmem, 0, st, tx, tw, o, p);
}

cudaError_t launch_bf16(const void* x, const void* w, void* out, const Plan& p, cudaStream_t st) {
  if (!plan_ok(p, kBK) || p.K % 8 || p.N % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  if (p.tile_n == 64) return launch_bf16_tiled<64>(x, w, out, p, st);
  if (p.tile_n == 128) return launch_bf16_tiled<128>(x, w, out, p, st);
  return cudaErrorInvalidValue;
}

template <int MT, int T, int GR>
cudaError_t launch_f32_skinny(const float* x, const float* w, float* out, const Plan& p,
                              int x_vec, cudaStream_t st) {
  return launch<matmul_f32_skinny<MT, T, GR>>(dim3(p.splits, cdiv(p.N, T), p.G), T,
                                              F32Tile<MT, T>::kSmem, p.splits, st, x, w, out, p,
                                              x_vec);
}

template <int T, int GR>
cudaError_t launch_f32_rows(const float* x, const float* w, float* out, const Plan& p, int x_vec,
                            cudaStream_t st) {
  if (p.M == 1) return launch_f32_skinny<1, T, GR>(x, w, out, p, x_vec, st);
  if (p.M == 2) return launch_f32_skinny<2, T, GR>(x, w, out, p, x_vec, st);
  if (p.M <= 4) return launch_f32_skinny<4, T, GR>(x, w, out, p, x_vec, st);
  if (p.M <= 8) return launch_f32_skinny<8, T, GR>(x, w, out, p, x_vec, st);
  return launch_f32_skinny<16, T, GR>(x, w, out, p, x_vec, st);
}

template <int T>
cudaError_t launch_f32_tiled(const float* x, const float* w, float* out, const Plan& p,
                             int x_vec, int w_vec, cudaStream_t st) {
  return w_vec ? launch_f32_rows<T, 16>(x, w, out, p, x_vec, st)
               : launch_f32_rows<T, 4>(x, w, out, p, x_vec, st);
}

cudaError_t launch_f32(const void* x_, const void* w_, void* out_, const Plan& p,
                       cudaStream_t st) {
  if (!plan_ok(p, kKT)) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  const float* w = static_cast<const float*>(w_);
  float* out = static_cast<float*>(out_);
  const int x_vec = p.K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int w_vec = p.N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (p.M > kF32Skinny) {
    // walked where the tiles alone fill the card, else split in clusters
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    const dim3 tiles(1, cdiv(p.N, kFatN), cdiv(p.M, kFatM) * p.G);
    if (tiles.z > 65535) return cudaErrorInvalidValue;
    const bool walk = p.splits == 1 || (long long)tiles.y * tiles.z * 10 >= 9LL * sms;
    if (p.G > 1)
      return walk ? launch<matmul_f32_fat<true, true>>(tiles, kFatThreads, kFatSmem, 0, st, x, w,
                                                       out, p, x_vec, w_vec)
                  : launch<matmul_f32_fat<false, true>>(dim3(p.splits, tiles.y, tiles.z),
                                                        kFatThreads, kFatSmem, p.splits, st, x, w,
                                                        out, p, x_vec, w_vec);
    return walk ? launch<matmul_f32_fat<true, false>>(tiles, kFatThreads, kFatSmem, 0, st, x, w,
                                                      out, p, x_vec, w_vec)
                : launch<matmul_f32_fat<false, false>>(dim3(p.splits, tiles.y, tiles.z),
                                                       kFatThreads, kFatSmem, p.splits, st, x, w,
                                                       out, p, x_vec, w_vec);
  }
  if (p.tile_n == 64) return launch_f32_tiled<64>(x, w, out, p, x_vec, w_vec, st);
  if (p.tile_n == 128) return launch_f32_tiled<128>(x, w, out, p, x_vec, w_vec, st);
  if (p.tile_n == 256) return launch_f32_tiled<256>(x, w, out, p, x_vec, w_vec, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x [G, M, K], w [G, K, N], out [G, M, N], contiguous, of one dtype (DT_F32
// or DT_BF16), under the plan of ops.matmul_plan(K, N, dtype): tile_n
// columns a column tile, k_per_split (a multiple of 64 in bf16, 16 in f32)
// and splits = ceil(K / k_per_split), 1, 2, 4 or 8; each group's product
// sums in that order.  bf16 takes K and N multiples of 8 and x, w 16-byte
// aligned.  No scratch: the only write is out.
REPRO_EXPORT int stream_bmm_launch(const void* x, const void* w, void* out, int G, int M, int K,
                                   int N, int tile_n, int k_per_split, int splits, int dtype,
                                   void* stream) {
  const Plan p{M, K, N, tile_n, k_per_split, splits, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == DT_BF16  ? launch_bf16(x, w, out, p, st)
                        : dtype == DT_F32 ? launch_f32(x, w, out, p, st)
                                          : cudaErrorInvalidValue;
  return (int)e;
}

// x [M, K], w [K, N], out [M, N]: the batched form with one group.
REPRO_EXPORT int stream_matmul_launch(const void* x, const void* w, void* out, int M, int K, int N,
                                      int tile_n, int k_per_split, int splits, int dtype,
                                      void* stream) {
  return stream_bmm_launch(x, w, out, 1, M, K, N, tile_n, k_per_split, splits, dtype, stream);
}

// The clusters of one skinny launch under this plan that the current card
// can hold at once (cudaOccupancyMaxActiveClusters), for chip_smoke.py's
// check that a cluster of the plan's splits is co-resident; 0 where none is.
REPRO_EXPORT int stream_matmul_max_clusters(int tile_n, int splits, int dtype) {
  if (dtype == DT_BF16 && tile_n == 64) {
    using R = Bf16Rings<64, 64>;
    using L = Bf16Tile<64, 1, R::kSplit, 64>;
    return max_clusters<matmul_bf16_kernel<64, 1, true, R::kSplit, 64>>(L::kThreads, L::kSmem,
                                                                         splits);
  }
  if (dtype == DT_BF16 && tile_n == 128) {
    using R = Bf16Rings<128, 64>;
    using L = Bf16Tile<128, 1, R::kSplit, 64>;
    return max_clusters<matmul_bf16_kernel<128, 1, true, R::kSplit, 64>>(L::kThreads,
                                                                          L::kSmem, splits);
  }
  if (dtype == DT_F32 && tile_n == 256)
    return max_clusters<matmul_f32_skinny<16, 256, 16>>(256, F32Tile<16, 256>::kSmem, splits);
  return -(int)cudaErrorInvalidValue;
}

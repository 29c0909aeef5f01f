// Masked GQA attention over a KV cache, shared by two kernels for Hopper
// (sm_90a): tree_attention.cu (a bool mask [B, n, S]) and
// decode_attention.cu (one query position per batch row, rows < length[b]).
//
// Both launch the one kernel below, which walks a query's attended keys by
// their rank among them, never by their row in the cache: key position p of
// the kernel's splits, tiles, warps and MMA k-slots is the query's p-th
// attended key.  tree_attention maps each rank to its row from the query's
// mask row (rank_map, at the block's start); decode_attention's keys are
// rows 0 .. length - 1, where rank = row.  A row's scores, its online
// softmax and its fixed-order merges are then the same operations in the
// same order wherever its attended keys lie: a tree node's verify row,
// whose ancestors sit at rows of the tree's order, carries the bits of the
// greedy decode's row (decode_step, the same keys at consecutive rows), and
// decode_attention equals tree_attention at n = 1 bit for bit.  In bf16,
// where the output's one rounding turns an ulp of the f32 sums into a
// different logit, summing by row position gave the verify and the decode
// other bits in 6 of 200 trials with one key moved a row.  Past a query's
// last attended key nothing is loaded or added (a key that does not attend
// would add exactly nothing: score -1e30, weight 0, rescale by exp(0) = 1),
// and a split that holds no attended rank need not be launched (below).
//
// What bounds it on this card.  By bytes or by operations it would take
// well under a microsecond: at the port's shapes (G = Hq/Hkv from 1 to 48
// query heads per KV head, n <= 8 tree nodes, S = 512) every K/V element
// is used by at most G*n query rows — 32 at the llama3-8b verify, 384 at
// granite-20b's (G 48 on its one KV head, 48 f32 or 24 bf16 row tiles that
// each load the same K/V tiles) — against the ~20 f32 (~295 bf16)
// operations per byte at which the card's arithmetic, not its memory, is
// the limit.  In practice it is bound by latency: the
// launch, one round trip to device memory for Q/K/V/mask, a chain of
// dependent arithmetic per row, and — when a row's keys span several
// splits — a second round trip for the combine.
// Measured on an H100 (tools/attention_variants.py, PERF.md): at a decode
// step the launch and the loads alone take about as long as
// scaled_dot_product_attention's whole call, the arithmetic adds a tenth
// more; smaller splits (more SMs per KV head) lose more to the combine
// than they gain in load time.  The design spends its effort on the
// length of those chains:
//
// * One round trip for the operands.  Q and the K and V tiles are all
//   requested before any is waited on, by 16-byte cp.async (8-byte for a
//   bf16 head size that is no multiple of 8) into a ring of shared-memory
//   stages, in their own dtype (a bf16 tile takes half the bytes of an f32
//   one), ranks past the query's last zero-filled.  The mask is read once,
//   by rank_map, before the first tile.  While a tile is computed the next
//   is in flight.  At S <= 2048 a split is 64
//   keys: one bf16 tile (one stage), two f32 tiles (two stages).
// * A split grid over live keys.  The split length is a function of S
//   alone (ops.attn_split_keys); the caller's host-int bound kv_end (the
//   decode length, or tree_attention's optional kv_bound) launches only
//   the splits below it.  A split that is not launched would have
//   published (max -1e30, sum 0, acc 0), whose combine weight
//   exp(-1e30 - m) is exactly 0, so the result is the same bit for bit
//   (up to the sign of a zero).  At the paths' lengths one split is
//   live: no partials, no ticket, no second pass.  The single-split
//   epilogue divides O / L exactly as the combine does, so it is the
//   combine with one split.
// * One query per block.  A block holds up to kRows query heads of one
//   query i and one KV head (the grid's row tile i * tpq + t takes heads
//   [t*kRows, (t+1)*kRows) of the G that share the KV head; tpq = ceil(G /
//   kRows)), so every row of a block attends the same ranks: at G 4 (the
//   8B) a bf16 block has 4 live rows of the MMA's 16.  rank_map scans the
//   query's mask row below kv_end once per block (one prefix sum over 512
//   bytes per step, stopping once the split's ranks are found) into a
//   rank -> row table in shared memory; the K and V rows of a tile are then
//   loaded through it by 16-byte cp.async, a row per key.
// * Keys across warps.  A tile holds kKeys ranks; warp w takes ranks
//   [w*kKeys/4, (w+1)*kKeys/4) of every tile with its own online softmax,
//   and the four warps merge (max, sum, acc) in shared memory in the fixed
//   order w = 0..3 at the end of the split.  No warp walks rows one after
//   another: each row's arithmetic is a fixed function of its q, its
//   attended keys in rank order and the split length, whatever n, B or Hq
//   are, whichever rows share its block and wherever the keys lie.
// * bf16 on tensor cores: mma.sync.m16n8k16 (f32 accumulate) fed by
//   ldmatrix (ldmatrix.trans for V), not wgmma — wgmma needs 64 rows and a
//   block here has at most 16 live rows (min(G, 16) at a decode step); the
//   work is bound by latency, not by the tensor cores' rate.  The 16 rows of a
//   block are the MMA's M (rows past G*n are zeros), a warp's 16 keys its
//   N, the head dim its K, zero-padded in shared memory to 16*KS.  The
//   scores stay in the accumulator fragments; a row's max and sum reduce
//   over the four lanes of a quad.  The fragments of P are the A operand
//   of P*V directly (two n8 score tiles = one k16 A tile).
//   P*V keeps the reference's f32 P (src/repro/kernels/tree_attention.py
//   multiplies f32 p by f32 v): p is split into hi = bf16(p) and
//   lo = bf16(p - hi) and both go through the MMA into one f32
//   accumulator.  Tolerance argument: |p - hi - lo| <= 2^-9 |p - hi| <=
//   2^-18 |p| (each bf16 rounding keeps 8 bits), the products with the
//   bf16 v are exact in the f32 accumulator, so P*V carries a relative
//   error of about 2^-18 ~ 4e-6 against the f32 reference — far inside
//   bf16's 2e-2, whose budget goes to the one rounding of the output
//   (2^-9 ~ 2e-3).  tests/test_torch_kernels.py writes this arithmetic out
//   in torch and holds it against the JAX package at 2e-2 and against the
//   f32 plain version at 1e-5 before the output rounding.
// * f32 on CUDA cores (TF32 would break the 2e-5 tolerance), kRows = 8 and
//   kKeys = 32: in the score loop lane (j, quarter) of warp w takes key j of
//   the warp's 8 and every fourth 16-byte column group, so each lane keeps
//   one independent partial dot per row (8 rows: 8 chains of hd/4 fmaf),
//   summed over the quarters by two shuffles; in P*V a lane owns two
//   columns of every row and walks the warp's 8 keys in order, its p from a
//   per-warp tile in shared memory.  Every row runs, padding rows included
//   (their q is zero): branches around a row's shuffle and exp chain
//   would serialise the rows.
// * Shared memory strides are padded so that ldmatrix, the f32 K reads and
//   the merge's float2 stores of the quad layout each hit distinct banks.
//
// The cross-split combine (several live splits): every block publishes its
// merged (max, sum, acc) per row, and the last block of a (b, h, row tile)
// to finish — an atomic ticket — combines them in a fixed order (at most
// 32 splits, one per lane).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 32;
constexpr int kMaxStages = 2;
constexpr float kNeg = -1e30f;

// query rows per block and keys per shared-memory tile, by dtype
template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int kRows = 8, kKeys = 32;
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kRows = 16, kKeys = 64;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, n, S]; unused by the length variant
  const int* length;    // [B] rows that attend (length variant); null: kv_end bounds every row
  int kv_end;           // keys >= kv_end attend for no row: never loaded, their splits not launched
  void* out;
  float* part_acc;  // [B*Hkv, n_rowtiles*tile_rows, n_launch, hd]; unused when n_launch == 1
  float* part_ml;   // [B*Hkv, n_rowtiles*tile_rows, n_launch, 2]
  int* counters;    // [B*Hkv, n_rowtiles], zero between launches
  int B, n, Hq, Hkv, hd, S, split_keys, n_launch, stages;
  int tpq;         // row tiles per query: ceil(G / kRows)
  int n_rowtiles;  // n * tpq
  int tile_rows;   // rows of a row tile's partials: min(kRows, G)
  float scale;
};

// Byte offsets of the dynamic shared memory.  W: the bf16 kernel's k16 steps
// over the padded head dim, or the f32 kernel's column pairs per lane.
struct Smem {
  int ldq, ldk, ldv, ldo;                  // row strides, in elements
  int stage, stage_bytes, k, v, p;         // stage s at stage + s * stage_bytes; k/v within it
  int mw, lw, aw;                          // the warps' merge area (aliases the stages)
  int map, total;                          // rank_map's table: map_keys ints, after the rest
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

template <typename T, int W>
__host__ __device__ inline Smem smem_layout(int hd, int stages, int map_keys) {
  constexpr int R = Tile<T>::kRows, NK = Tile<T>::kKeys, es = sizeof(T);
  Smem L{};
  if (std::is_same<T, float>::value) {
    // K rows 16-byte aligned and padded so that 8 lanes reading 8 keys hit 8 bank groups
    L.ldq = hd;
    L.ldk = hd + ((hd / 4) % 2 == 0 ? 4 : 0);
    L.ldv = hd;
    L.ldo = hd;
  } else {
    // padded head dim + 8: ldmatrix's 8 row addresses fall in 8 bank groups
    L.ldq = L.ldk = L.ldv = 16 * W + 8;
    L.ldo = 16 * W + 8;  // the quad layout's float2 stores: 16 lanes hit 32 banks
  }
  L.stage = align16(R * L.ldq * es);  // Q first
  L.k = 0;
  L.v = L.k + NK * L.ldk * es;
  L.stage_bytes = align16(L.v + NK * L.ldv * es);
  L.p = L.stage + stages * L.stage_bytes;  // f32: each warp's p tile [R][8]
  const int end = L.p + (std::is_same<T, float>::value ? kWarps * R * 8 * 4 : 0);
  L.mw = L.stage;
  L.lw = L.mw + kWarps * R * 4;
  L.aw = L.lw + kWarps * R * 4;
  const int merge_end = L.aw + kWarps * R * L.ldo * 4;
  L.map = align16(end > merge_end ? end : merge_end);
  L.total = L.map + map_keys * 4;
  return L;
}

// two bf16 in one register, the lower k index in the low half
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo_k, __nv_bfloat16 hi_k) {
  __nv_bfloat162 v = __halves2bfloat162(lo_k, hi_k);
  return *reinterpret_cast<unsigned*>(&v);
}

// The rows of one query's attended keys by rank: map[r - r0] is the row of
// its r-th attended key (mask byte != 0) below lim, for r in [r0, r1).
// Returns the number of attended keys below lim, or a number >= r1 where
// the scan stopped once every rank of [r0, r1) was found.  Each step takes
// 4 mask bytes a thread and one block-wide prefix sum.  Every thread of the
// block calls it; it ends with a barrier, so the table is ready.
__device__ int rank_map(const uint8_t* m, int lim, int r0, int r1, int* map) {
  __shared__ int s_tot[kWarps];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int base = 0;  // attended keys before this step's bytes (the same in every thread)
  for (int c0 = 0; c0 < lim && base < r1; c0 += kThreads * 4) {
    const int s0 = c0 + tid * 4;
    uint8_t mb[4];
    int c = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mb[j] = s0 + j < lim ? m[s0 + j] : uint8_t(0);
      c += mb[j] != 0;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) s_tot[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_tot[w] : 0;
      total += s_tot[w];
    }
    int r = base + before + incl - c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mb[j]) {
        if (r >= r0 && r < r1) map[r - r0] = s0 + j;
        ++r;
      }
    base += total;
    __syncthreads();  // s_tot is written again by the next step; the table is complete
  }
  return base;
}

// One row's online-softmax step over a warp's 8 keys on CUDA cores (the f32
// path here, and csrc/latent_attention.cu): lane (j, quarter) holds its
// quarter's partial dot of key j of the warp.  The four quarters are summed
// by two shuffles, the score scaled (kNeg where the key does not attend),
// and the row's running max and sum updated over the 8 keys in a fixed
// butterfly.  Returns key j's weight p (0 where it does not attend); alpha
// is the rescale of the row's earlier sums.
__device__ __forceinline__ float online_step8(float dot, bool key_on, float scale, float& m_run,
                                              float& l_run, float& alpha) {
  float s = dot + __shfl_xor_sync(0xffffffffu, dot, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  const float sc = key_on ? s * scale : kNeg;
  float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
  const float m_new = fmaxf(m_run, mx);
  alpha = expf(m_run - m_new);
  const float p = key_on ? expf(sc - m_new) : 0.f;
  float ps = p + __shfl_xor_sync(0xffffffffu, p, 1);
  ps += __shfl_xor_sync(0xffffffffu, ps, 2);
  ps += __shfl_xor_sync(0xffffffffu, ps, 4);
  l_run = l_run * alpha + ps;
  m_run = m_new;
  return p;
}

// ---- the kernel ----------------------------------------------------------------

// W: bf16 — k16 steps over the head dim padded to 16*W; f32 — column pairs per lane
// (2 * 32 * W >= hd).  kByLength: key s of batch row b attends iff s < length[b]
// (or kv_end), n = 1, rank = row; else the mask's attended keys, by rank.
template <typename T, int W, bool kByLength>
__global__ void __launch_bounds__(kThreads) attention_kernel(Args a) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int R = Tile<T>::kRows, NK = Tile<T>::kKeys, KW = NK / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ float s_w[kWarps][kMaxSplits];  // the combine's split weights, per warp
  __shared__ float s_wt[kWarps][16], s_m[16], s_l[16];  // the warp merge's, per row (R <= 16)

  const int hd = a.hd;
  const Smem L = smem_layout<T, W>(hd, a.stages, kByLength ? 0 : a.split_keys);
  const int bh = blockIdx.x, rt = blockIdx.y, split = blockIdx.z;
  const int b = bh / a.Hkv, h = bh % a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int qi = rt / a.tpq, g0 = (rt % a.tpq) * R;  // the block's query and its first head
  const int rows = min(R, G - g0);  // live query rows of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  T* Qs = reinterpret_cast<T*>(smem);

  // the split's ranks [s_begin, s_end): the query's attended keys among them
  const int s_begin = split * a.split_keys;
  int s_end = min(min(a.S, a.kv_end), s_begin + a.split_keys);
  int* Map = reinterpret_cast<int*>(smem + L.map);  // rank s_begin + j -> row (tree variant)
  if constexpr (kByLength) {
    if (a.length) s_end = min(s_end, a.length[b]);
  } else {
    s_end = min(s_end, rank_map(a.mask + ((long long)b * a.n + qi) * a.S, min(a.S, a.kv_end),
                                s_begin, s_begin + a.split_keys, Map));
  }
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + NK - 1) / NK : 0;
  // columns held in shared memory (bf16: padded with zeros to whole k16 steps)
  const int cols = kF32 ? hd : 16 * W;

  // row rl of the block is query qi's query head h*G + g0 + rl
  auto q_row = [&](int rl) -> long long {
    return (((long long)b * a.n + qi) * a.Hq + h * G + g0 + rl) * hd;
  };

  // Q (with the first tile) and one tile of K and V, by cp.async in granules of
  // GR bytes, one commit group; columns >= hd and keys >= s_end are zero-filled
  auto issue = [&](auto gr, int stage, int t0, bool with_q) {
    constexpr int GR = decltype(gr)::value, GE = GR / sizeof(T);
    const int rg = cols / GE;  // granules per row
    const int dj = kThreads / rg, dg = kThreads % rg;  // a thread's step in (row, granule)
    unsigned char* st = smem + L.stage + stage * L.stage_bytes;
    T* Ks = reinterpret_cast<T*>(st + L.k);
    T* Vs = reinterpret_cast<T*>(st + L.v);
    if (with_q) {
      for (int rl = tid / rg, gi = tid % rg; rl < R;) {
        const int e = gi * GE;
        const bool ok = rl < rows && e < hd;
        cp_async<GR>(Qs + rl * L.ldq + e, q + (ok ? q_row(rl) + e : 0), ok);
        rl += dj;
        gi += dg;
        if (gi >= rg) gi -= rg, ++rl;
      }
    }
    const int live = s_end - t0;  // ranks of this tile that are loaded
    // rank t0 + j's row: itself (length variant), or the query's map
    auto key_at = [&](int j) -> long long {
      const int row = kByLength ? t0 + j : Map[t0 - s_begin + j];
      return (((long long)b * a.S + row) * a.Hkv + h) * hd;
    };
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const T* src = part == 0 ? k : v;
      T* dst = part == 0 ? Ks : Vs;
      const int ld = part == 0 ? L.ldk : L.ldv;
      for (int j = tid / rg, gi = tid % rg; j < NK;) {
        const int e = gi * GE;
        const bool ok = j < live && e < hd;
        cp_async<GR>(dst + j * ld + e, src + (ok ? key_at(j) + e : 0), ok);
        j += dj;
        gi += dg;
        if (gi >= rg) gi -= rg, ++j;
      }
    }
    cp_async_commit();
  };
  auto issue_tile = [&](int stage, int t0, bool with_q) {
    if (kF32 || hd % 8 == 0)
      issue(std::integral_constant<int, 16>{}, stage, t0, with_q);
    else
      issue(std::integral_constant<int, 8>{}, stage, t0, with_q);
  };
  // per-warp online softmax state: bf16 — rows g and g+8 of the quad layout
  // (l a per-lane partial until the end); f32 — every row, replicated
  constexpr int NR = kF32 ? R : 2;
  constexpr int NACC = kF32 ? R * W * 2 : 2 * W * 4;
  float m_run[NR], l_run[NR], acc[NACC];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if (n_tiles > 0) issue_tile(0, s_begin, true);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % a.stages, t0 = s_begin + it * NK;
    unsigned char* st = smem + L.stage + stage * L.stage_bytes;
    // the next tile goes in flight before this one is computed (a split of
    // several tiles always has two stages)
    if (it + 1 < n_tiles) {
      issue_tile((it + 1) % a.stages, t0 + NK, false);
      cp_async_wait<1>();  // this tile landed; the next may not have
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = reinterpret_cast<const T*>(st + L.k);
    const T* Vs = reinterpret_cast<const T*>(st + L.v);

    if constexpr (!kF32) {
      // ---- bf16: S = Q K^T for the warp's 16 keys on tensor cores ----
      const int g = lane / 4, t = lane % 4, mi = lane / 8, mr = lane % 8;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < W; ++ks) {
        unsigned qa[4], kb[4];
        ldsm_x4(qa, Qs + (mr + (mi & 1) * 8) * L.ldq + ks * 16 + (mi >> 1) * 8);
        ldsm_x4(kb, Ks + (warp * KW + (mi >> 1) * 8 + mr) * L.ldk + ks * 16 + (mi & 1) * 8);
        mma_bf16(sc[0], qa, kb[0], kb[1]);
        mma_bf16(sc[1], qa, kb[2], kb[3]);
      }
      // online softmax on the fragments: sc[nt][e] is row g + 8*(e/2), key
      // warp*16 + 8*nt + 2*t + e%2 of the tile
      unsigned ph[4], pl[4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        bool on[2][2];
        float mx = kNeg;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = warp * KW + nt * 8 + 2 * t + e;
            on[nt][e] = t0 + j < s_end;  // every row of the block attends the same ranks
            sc[nt][2 * hr + e] = on[nt][e] ? sc[nt][2 * hr + e] * a.scale : kNeg;
            mx = fmaxf(mx, sc[nt][2 * hr + e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hr], mx);
        const float alpha = expf(m_run[hr] - m_new);
        float p[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            p[nt][e] = on[nt][e] ? expf(sc[nt][2 * hr + e] - m_new) : 0.f;
        l_run[hr] = l_run[hr] * alpha + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
        m_run[hr] = m_new;
#pragma unroll
        for (int dt = 0; dt < 2 * W; ++dt) {
          acc[dt * 4 + 2 * hr] *= alpha;
          acc[dt * 4 + 2 * hr + 1] *= alpha;
        }
        // A fragments of P: reg hr = row g + 8*hr, keys 2t..; reg 2 + hr = keys 8 + 2t..
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16 h0 = __float2bfloat16_rn(p[nt][0]);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(p[nt][1]);
          ph[2 * nt + hr] = pack2(h0, h1);
          pl[2 * nt + hr] = pack2(__float2bfloat16_rn(p[nt][0] - __bfloat162float(h0)),
                                  __float2bfloat16_rn(p[nt][1] - __bfloat162float(h1)));
        }
      }
      // ---- O += P V: hi then lo, two n8 column tiles per ldmatrix.trans ----
#pragma unroll
      for (int pp = 0; pp < W; ++pp) {
        unsigned vb[4];
        ldsm_x4_trans(vb, Vs + (warp * KW + (mi & 1) * 8 + mr) * L.ldv + pp * 16 + (mi >> 1) * 8);
        float(&o0)[4] = *reinterpret_cast<float(*)[4]>(acc + (2 * pp) * 4);
        float(&o1)[4] = *reinterpret_cast<float(*)[4]>(acc + (2 * pp + 1) * 4);
        mma_bf16(o0, ph, vb[0], vb[1]);
        mma_bf16(o0, pl, vb[0], vb[1]);
        mma_bf16(o1, ph, vb[2], vb[3]);
        mma_bf16(o1, pl, vb[2], vb[3]);
      }
    } else {
      // ---- f32: lane (j, quarter) — key warp*8 + j, column groups quarter + 4i ----
      const float* Qf = reinterpret_cast<const float*>(Qs);
      const float* Kf = reinterpret_cast<const float*>(Ks);
      const float* Vf = reinterpret_cast<const float*>(Vs);
      float* Pw = reinterpret_cast<float*>(smem + L.p) + warp * R * 8;
      const int j = lane % 8, quarter = lane / 8, key = warp * KW + j;
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
      const float* kr = Kf + key * L.ldk;
      for (int d = 4 * quarter; d < hd; d += 16) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(Qf + r * L.ldq + d);
          dot[r] = fmaf(qv.x, kk.x, dot[r]);
          dot[r] = fmaf(qv.y, kk.y, dot[r]);
          dot[r] = fmaf(qv.z, kk.z, dot[r]);
          dot[r] = fmaf(qv.w, kk.w, dot[r]);
        }
      }
      float alpha[R];
      const bool key_on = t0 + key < s_end;
#pragma unroll
      for (int r = 0; r < R; ++r) {  // every row, so the rows' chains interleave
        const float p = online_step8(dot[r], key_on, a.scale, m_run[r], l_run[r], alpha[r]);
        if (quarter == 0) Pw[r * 8 + j] = p;
      }
      __syncwarp();
      // O += P V: lane owns columns 2c, 2c+1 for c = lane + 32u
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int c = 2 * (lane + 32 * u);
        if (c < hd) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[(r * W + u) * 2] *= alpha[r];
            acc[(r * W + u) * 2 + 1] *= alpha[r];
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 vv = *reinterpret_cast<const float2*>(Vf + (warp * KW + jj) * L.ldv + c);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float p = Pw[r * 8 + jj];
              acc[(r * W + u) * 2] = fmaf(p, vv.x, acc[(r * W + u) * 2]);
              acc[(r * W + u) * 2 + 1] = fmaf(p, vv.y, acc[(r * W + u) * 2 + 1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage and the p tiles are free for the next tile
  }

  // ---- merge the four warps' (max, sum, acc) in the order w = 0..3 ----
  float* Mw = reinterpret_cast<float*>(smem + L.mw);  // [kWarps][R]
  float* Lw = reinterpret_cast<float*>(smem + L.lw);  // [kWarps][R]
  float* Aw = reinterpret_cast<float*>(smem + L.aw);  // [kWarps][R][ldo]
  if constexpr (!kF32) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float l = l_run[hr] + __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (t == 0) {
        Mw[warp * R + g + 8 * hr] = m_run[hr];
        Lw[warp * R + g + 8 * hr] = l;
      }
    }
#pragma unroll
    for (int dt = 0; dt < 2 * W; ++dt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (g + 8 * hr < rows)  // a padding row's acc is never read
          *reinterpret_cast<float2*>(Aw + (warp * R + g + 8 * hr) * L.ldo + dt * 8 + 2 * t) =
              make_float2(acc[dt * 4 + 2 * hr], acc[dt * 4 + 2 * hr + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        Mw[warp * R + r] = m_run[r];
        Lw[warp * R + r] = l_run[r];
      }
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int c = 2 * (lane + 32 * u);
        if (c < hd)
          *reinterpret_cast<float2*>(Aw + (warp * R + r) * L.ldo + c) =
              make_float2(acc[(r * W + u) * 2], acc[(r * W + u) * 2 + 1]);
      }
    }
  }
  __syncthreads();

  if (tid < rows) {  // per row: the warps' weights exp(m_w - m), and the merged sum
    float m_all = kNeg, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, Mw[w * R + tid]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(Mw[w * R + tid] - m_all);
      s_wt[w][tid] = wt;
      l = fmaf(Lw[w * R + tid], wt, l);
    }
    s_m[tid] = m_all;
    s_l[tid] = l;
  }
  __syncthreads();

  // partials of this row tile
  const long long row0 = ((long long)bh * a.n_rowtiles + rt) * a.tile_rows;
  for (int idx = tid; idx < rows * hd; idx += kThreads) {
    const int rl = idx / hd, c = idx % hd;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(Aw[(w * R + rl) * L.ldo + c], s_wt[w][rl], o);
    if (a.n_launch == 1) {  // the combine of one split: O / L
      out[q_row(rl) + c] = from_f32<T>(s_l[rl] > 0.f ? o / s_l[rl] : 0.f);
    } else {
      const long long p = (row0 + rl) * a.n_launch + split;
      a.part_acc[p * hd + c] = o;
      if (c == 0) {
        a.part_ml[2 * p] = s_m[rl];
        a.part_ml[2 * p + 1] = s_l[rl];
      }
    }
  }
  if (a.n_launch == 1) return;

  // --- several live splits: the last block of the row tile combines them ---
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ctr = a.counters + (long long)bh * a.n_rowtiles + rt;
    const int ticket = atomicAdd(ctr, 1);
    s_last = ticket == a.n_launch - 1;
    if (s_last) *ctr = 0;  // every split has counted: ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  for (int rl = warp; rl < rows; rl += kWarps) {
    // lane sp holds split sp's (max, sum); the sums meet in a fixed order
    const long long p0 = (row0 + rl) * a.n_launch;
    const bool mine = lane < a.n_launch;
    const float m_sp = mine ? __ldcg(a.part_ml + 2 * (p0 + lane)) : kNeg;
    const float l_sp = mine ? __ldcg(a.part_ml + 2 * (p0 + lane) + 1) : 0.f;
    const float m_all = warp_max(m_sp);
    const float w_sp = mine ? expf(m_sp - m_all) : 0.f;
    const float l = warp_sum(l_sp * w_sp);
    s_w[warp][lane] = w_sp;
    __syncwarp();
    const long long o_row = q_row(rl);
    for (int c = lane; c < hd; c += 32) {
      float o = 0.f;
      for (int sp = 0; sp < a.n_launch; ++sp)
        o = fmaf(__ldcg(a.part_acc + (p0 + sp) * hd + c), s_w[warp][sp], o);
      out[o_row + c] = from_f32<T>(l > 0.f ? o / l : 0.f);
    }
    __syncwarp();
  }
}

template <typename T, int W, bool kByLength>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  static int allowed[kMaxCards] = {};  // the most dynamic shared memory, per card
  const int smem = smem_layout<T, W>(a.hd, a.stages, kByLength ? 0 : a.split_keys).total;
  auto kern = attention_kernel<T, W, kByLength>;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  dim3 grid(a.B * a.Hkv, a.n_rowtiles, a.n_launch);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The variant is chosen by dtype and head size only, never by n.  f32: column
// pairs per lane; bf16: k16 steps of the zero-padded head dim (hd 64 -> 4,
// 80 -> 5, 128 -> 8; a head dim between the listed ones is padded up).
template <bool kByLength>
cudaError_t launch_dtype(const Args& a, int dtype, cudaStream_t stream) {
  if (dtype == DT_F32) {
    switch ((a.hd + 63) / 64) {
      case 1: return launch_typed<float, 1, kByLength>(a, stream);
      case 2: return launch_typed<float, 2, kByLength>(a, stream);
      case 3: return launch_typed<float, 3, kByLength>(a, stream);
      case 4: return launch_typed<float, 4, kByLength>(a, stream);
      default: return cudaErrorInvalidValue;  // hd > 256
    }
  }
  if (dtype == DT_BF16) {
    if (a.hd <= 32) return launch_typed<__nv_bfloat16, 2, kByLength>(a, stream);
    if (a.hd <= 64) return launch_typed<__nv_bfloat16, 4, kByLength>(a, stream);
    if (a.hd <= 80) return launch_typed<__nv_bfloat16, 5, kByLength>(a, stream);
    if (a.hd <= 128) return launch_typed<__nv_bfloat16, 8, kByLength>(a, stream);
    if (a.hd <= 256) return launch_typed<__nv_bfloat16, 16, kByLength>(a, stream);
  }
  return cudaErrorInvalidValue;
}

// Checks the shapes and the launch plan and launches on ``stream``: float32
// (DT_F32) or bfloat16 (DT_BF16), hd % 4 == 0, splits of split_keys (a
// multiple of 64) keys, n_launch of them (1..32) covering every key below
// min(kv_end, S).
template <bool kByLength>
cudaError_t attention_launch(Args a, int dtype, cudaStream_t stream) {
  const int rows = dtype == DT_F32 ? Tile<float>::kRows : Tile<__nv_bfloat16>::kRows;
  const int keys = dtype == DT_F32 ? Tile<float>::kKeys : Tile<__nv_bfloat16>::kKeys;
  a.tpq = (a.Hkv > 0 && a.Hq % a.Hkv == 0 ? a.Hq / a.Hkv + rows - 1 : 0) / rows;
  a.n_rowtiles = a.n * a.tpq;
  a.tile_rows = a.tpq > 0 ? min(rows, a.Hq / a.Hkv) : 0;
  a.stages = a.split_keys > keys ? kMaxStages : 1;  // a ring only where a split has two tiles
  const int live = min(a.kv_end, a.S);
  if (a.split_keys % 64 != 0 || a.Hq % a.Hkv != 0 || a.hd % 4 != 0 || a.n_launch < 1 ||
      a.n_rowtiles < 1 || a.n_rowtiles > 65535 ||
      a.n_launch > kMaxSplits || (long long)a.n_launch * a.split_keys < live ||
      (a.n_launch > 1 && (long long)(a.n_launch - 1) * a.split_keys >= live))
    return cudaErrorInvalidValue;
  return launch_dtype<kByLength>(a, dtype, stream);
}

}  // namespace

// query rows per block of the kernel for dtype (DT_F32 / DT_BF16): a block
// holds at most this many query heads of one query
REPRO_EXPORT int attention_rows_per_block(int dtype) {
  return dtype == DT_F32 ? Tile<float>::kRows : Tile<__nv_bfloat16>::kRows;
}

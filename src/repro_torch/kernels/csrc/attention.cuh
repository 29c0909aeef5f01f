// Masked GQA attention over a KV cache, shared by two kernels for Hopper
// (sm_90a): tree_attention.cu (a bool mask [B, n, S]) and
// decode_attention.cu (one query position per batch row, rows < length[b]).
//
// Both launch the one kernel below.  decode_attention is its n = 1 case
// with the mask computed from the length: a row's scores, its online
// softmax and its fixed-order split combine are then the same operations
// in the same order as tree_attention's at n = 1, so the greedy decode
// (decode_step, n = 1) and the chain verify (n = k) round alike bit for
// bit.  The length variant also stops each split's key loop at the length,
// so it reads only the K/V rows that attend: a tile or split past the
// length would add exactly nothing in tree_attention (every key masked:
// score -1e30, weight 0, rescale by exp(0) = 1).
//
// What bounds it: bytes.  At the port's shapes (G = Hq/Hkv <= 4 query heads
// per KV head, n <= 8 tree nodes, S = 512) every K/V element is used by at
// most G*n = 32 query rows, far below the ~20 f32 operations per byte at
// which the card's CUDA cores, not its memory, would be the limit.
//
// Design: the TPU kernels walk S as a sequential grid axis with the running
// max/sum/accumulator in VMEM.  Here S is split across thread blocks, as
// the paper's GPU kernel does: grid (B*Hkv, row tiles, S splits); each
// block holds up to 16 query rows of one KV head (row rl on warp rl % 4, so
// the G <= 4 rows of a decode step run on separate warps), streams its S split
// through shared memory in tiles of 32 keys (one key per lane for the
// scores, one head-dim slice per lane for the accumulator) and keeps an
// online softmax per row in registers.  The work is small and latency
// bound, so every global read is a 16-byte vector issued in an unrolled
// batch before it is used.  The last block of a (b, h, row tile) to
// finish — an atomic ticket — combines the splits' partial (max, sum, acc)
// in a fixed order (at most 32 splits, one per lane), so a row's result is
// the same whatever n is.  The split length is a function of S alone.
#pragma once

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                     // keys per shared-memory tile
constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, n, S]; unused by the length variant
  const int* length;    // [B] rows that attend (length variant); null: length_all for every row
  int length_all;
  void* out;
  float* part_acc;  // [B*Hkv, n_rowtiles*kRows, n_splits, hd]
  float* part_ml;   // [B*Hkv, n_rowtiles*kRows, n_splits, 2]
  int* counters;    // [B*Hkv, n_rowtiles], zero between launches
  int B, n, Hq, Hkv, hd, S, split_keys, n_splits, n_rowtiles;
  float scale;
};

// kByLength: key s of batch row b attends iff s < length[b] (n = 1); else the mask
template <typename T, int DPL, bool kByLength>
__global__ void __launch_bounds__(kThreads) attention_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int hd = a.hd, hd4 = hd / 4, ldk = hd + 1;  // +1: lanes read K rows bank-conflict free
  float* Ks = smem;                                 // [kTile][hd+1]
  float* Vs = Ks + kTile * ldk;                     // [kTile][hd], 16-byte aligned (hd % 4 == 0)
  float* Qs = Vs + kTile * hd;                      // [kRows][hd], 16-byte aligned

  const int bh = blockIdx.x, rt = blockIdx.y, split = blockIdx.z;
  const int b = bh / a.Hkv, h = bh % a.Hkv;
  const int G = a.Hq / a.Hkv, GN = G * a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  // row r of a (b, h) is query i = r / G of query head h*G + r % G;
  // kRows * hd / 4 <= kThreads * DPL vectors
#pragma unroll
  for (int it = 0; it < DPL; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (idx < kRows * hd4) {
      const int rl = idx / hd4, d = (idx % hd4) * 4, r = rt * kRows + rl;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < GN) val = load4(q + (((long long)b * a.n + r / G) * a.Hq + h * G + r % G) * hd + d);
      *reinterpret_cast<float4*>(Qs + rl * hd + d) = val;
    }
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[rr][t] = 0.f;
  }

  const int s_begin = split * a.split_keys;
  int s_end = min(a.S, s_begin + a.split_keys);
  if (kByLength) s_end = min(s_end, a.length ? a.length[b] : a.length_all);
  for (int t0 = s_begin; t0 < s_end; t0 += kTile) {
    // the tile's K and V into registers (kTile * hd / 4 <= 2 * kThreads * DPL vectors) ...
    float4 kr4[2 * DPL], vr4[2 * DPL];
#pragma unroll
    for (int it = 0; it < 2 * DPL; ++it) {
      const int idx = threadIdx.x + it * kThreads, j = idx / hd4, s = t0 + j;
      kr4[it] = vr4[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < kTile * hd4 && s < s_end) {
        const long long off = (((long long)b * a.S + s) * a.Hkv + h) * hd + (idx % hd4) * 4;
        kr4[it] = load4(k + off);
        vr4[it] = load4(v + off);
      }
    }
    __syncthreads();  // ... then into shared memory once the previous tile is consumed
#pragma unroll
    for (int it = 0; it < 2 * DPL; ++it) {
      const int idx = threadIdx.x + it * kThreads, j = idx / hd4, d = (idx % hd4) * 4;
      if (idx < kTile * hd4) {
        float* kp = Ks + j * ldk + d;
        kp[0] = kr4[it].x;
        kp[1] = kr4[it].y;
        kp[2] = kr4[it].z;
        kp[3] = kr4[it].w;
        *reinterpret_cast<float4*>(Vs + j * hd + d) = vr4[it];
      }
    }
    __syncthreads();
    const int s = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int rl = rr * kWarps + warp, r = rt * kRows + rl;
      if (r >= GN) continue;  // uniform across the warp
      const int i = r / G;
      const bool on = s < s_end && (kByLength || a.mask[((long long)b * a.n + i) * a.S + s] != 0);
      const float* qr = Qs + rl * hd;
      const float* kr = Ks + lane * ldk;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float sc = on ? dot * a.scale : kNeg;
      const float m_new = fmaxf(m[rr], warp_max(sc));
      // a masked key contributes exactly 0, also while every key so far is masked
      const float p = on ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int t = 0; t < DPL; ++t) acc[rr][t] *= alpha;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) acc[rr][t] = fmaf(pj, Vs[j * hd + d], acc[rr][t]);
        }
      }
      m[rr] = m_new;
    }
  }

  if (a.n_splits == 1) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rt * kRows + rr * kWarps + warp;
      if (r >= GN) continue;
      const int i = r / G, g = r % G;
      const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
      T* o = out + (((long long)b * a.n + i) * a.Hq + h * G + g) * hd;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) o[d] = from_f32<T>(l[rr] > 0.f ? acc[rr][t] * inv : 0.f);
      }
    }
    return;
  }

  // --- split-S: publish this split's partials, the last block combines ---
  const long long row0 = ((long long)bh * a.n_rowtiles + rt) * kRows;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int rl = rr * kWarps + warp;
    if (rt * kRows + rl >= GN) continue;
    const long long p = (row0 + rl) * a.n_splits + split;
    if (lane == 0) {
      a.part_ml[2 * p] = m[rr];
      a.part_ml[2 * p + 1] = l[rr];
    }
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) a.part_acc[p * hd + d] = acc[rr][t];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ctr = a.counters + (long long)bh * a.n_rowtiles + rt;
    const int ticket = atomicAdd(ctr, 1);
    s_last = ticket == a.n_splits - 1;
    if (s_last) *ctr = 0;  // every split has counted: ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int rl = rr * kWarps + warp, r = rt * kRows + rl;
    if (r >= GN) continue;
    // lane sp holds split sp's (max, sum); the sums meet in a fixed order
    const long long p0 = (row0 + rl) * a.n_splits;
    const bool mine = lane < a.n_splits;
    const float m_sp = mine ? __ldcg(a.part_ml + 2 * (p0 + lane)) : kNeg;
    const float l_sp = mine ? __ldcg(a.part_ml + 2 * (p0 + lane) + 1) : 0.f;
    const float m_all = warp_max(m_sp);
    const float w_sp = mine ? expf(m_sp - m_all) : 0.f;
    const float L = warp_sum(l_sp * w_sp);
    float o[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) o[t] = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < a.n_splits; ++sp) {
      const float w = __shfl_sync(0xffffffffu, w_sp, sp);
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane + 32 * t;
        if (d < hd) o[t] = fmaf(__ldcg(a.part_acc + (p0 + sp) * hd + d), w, o[t]);
      }
    }
    const int i = r / G, g = r % G;
    T* op = out + (((long long)b * a.n + i) * a.Hq + h * G + g) * hd;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) op[d] = from_f32<T>(L > 0.f ? o[t] / L : 0.f);
    }
  }
}

template <typename T, int DPL, bool kByLength>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(kTile * (a.hd + 1) + kTile * a.hd + kRows * a.hd) * sizeof(float);
  auto kern = attention_kernel<T, DPL, kByLength>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.B * a.Hkv, a.n_rowtiles, a.n_splits);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kByLength>
cudaError_t launch_dpl(const Args& a, cudaStream_t stream) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch_typed<T, 1, kByLength>(a, stream);
    case 2: return launch_typed<T, 2, kByLength>(a, stream);
    case 3: return launch_typed<T, 3, kByLength>(a, stream);
    case 4: return launch_typed<T, 4, kByLength>(a, stream);
    case 5: return launch_typed<T, 5, kByLength>(a, stream);
    case 6: return launch_typed<T, 6, kByLength>(a, stream);
    case 7: return launch_typed<T, 7, kByLength>(a, stream);
    case 8: return launch_typed<T, 8, kByLength>(a, stream);
    default: return cudaErrorInvalidValue;  // hd > 256
  }
}

// Checks the shapes, fills the split and tile counts and launches on
// ``stream``: float32 (DT_F32) or bfloat16 (DT_BF16), hd % 4 == 0, at most
// 32 splits of split_keys (a multiple of 32) keys.
template <bool kByLength>
cudaError_t attention_launch(Args a, int dtype, cudaStream_t stream) {
  a.n_splits = (a.S + a.split_keys - 1) / a.split_keys;
  a.n_rowtiles = ((a.Hq / a.Hkv) * a.n + kRows - 1) / kRows;
  if (a.split_keys % kTile != 0 || a.Hq % a.Hkv != 0 || a.hd % 4 != 0 || a.n_splits > 32)
    return cudaErrorInvalidValue;
  return dtype == DT_F32    ? launch_dpl<float, kByLength>(a, stream)
         : dtype == DT_BF16 ? launch_dpl<__nv_bfloat16, kByLength>(a, stream)
                            : cudaErrorInvalidValue;
}

}  // namespace

REPRO_EXPORT int attention_rows_per_block() { return kRows; }

// Tree-masked GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel tree_attention_pallas
// (src/repro/kernels/tree_attention.py:82, body _kernel at :32): the paper's
// non-square masked attention, q [B, n, Hq, hd] against the whole cache
// k/v [B, S, Hkv, hd] under a bool mask [B, n, S], f32 softmax, scale
// 1/sqrt(hd), a fully masked query row returns exactly 0.
//
// What bounds it: bytes.  At the slice's shapes (G = Hq/Hkv = 4 query heads
// per KV head, n <= 8 tree nodes, S = 512) every K/V element is used by at
// most G*n = 32 query rows, far below the ~20 f32 operations per byte at
// which the card's CUDA cores, not its memory, would be the limit.
//
// Design: the TPU kernel walks S as a sequential grid axis with its running
// max/sum/accumulator in VMEM.  Here S is split across thread blocks, as
// the paper's GPU kernel does: grid (B*Hkv, row tiles, S splits); each
// block holds up to 16 query rows of one KV head, streams its S split
// through shared memory in tiles of 32 keys (one key per lane for the
// scores, one head-dim slice per lane for the accumulator) and keeps an
// online softmax per row in registers.  The work is small and latency
// bound, so every global read is a 16-byte vector issued in an unrolled
// batch before it is used.  The last block of a (b, h, row tile) to
// finish — an atomic ticket — combines the splits' partial (max, sum, acc)
// in a fixed order (at most 32 splits, one per lane), so a row's result is
// the same whatever n is.  The split length is a function of S alone.
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
  const uint8_t* mask;
  void* out;
  float* part_acc;  // [B*Hkv, n_rowtiles*kRows, n_splits, hd]
  float* part_ml;   // [B*Hkv, n_rowtiles*kRows, n_splits, 2]
  int* counters;    // [B*Hkv, n_rowtiles], zero between launches
  int B, n, Hq, Hkv, hd, S, split_keys, n_splits, n_rowtiles;
  float scale;
};

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) tree_attention_kernel(Args a) {
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
  const int s_end = min(a.S, s_begin + a.split_keys);
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
      const int rl = warp * kRowsPerWarp + rr, r = rt * kRows + rl;
      if (r >= GN) continue;  // uniform across the warp
      const int i = r / G;
      const bool on = s < s_end && a.mask[((long long)b * a.n + i) * a.S + s] != 0;
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
      const int r = rt * kRows + warp * kRowsPerWarp + rr;
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
    const int rl = warp * kRowsPerWarp + rr;
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
    const int rl = warp * kRowsPerWarp + rr, r = rt * kRows + rl;
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

template <typename T, int DPL>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)(kTile * (a.hd + 1) + kTile * a.hd + kRows * a.hd) * sizeof(float);
  auto kern = tree_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.B * a.Hkv, a.n_rowtiles, a.n_splits);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpl(const Args& a, cudaStream_t stream) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch_typed<T, 1>(a, stream);
    case 2: return launch_typed<T, 2>(a, stream);
    case 3: return launch_typed<T, 3>(a, stream);
    case 4: return launch_typed<T, 4>(a, stream);
    case 5: return launch_typed<T, 5>(a, stream);
    case 6: return launch_typed<T, 6>(a, stream);
    case 7: return launch_typed<T, 7>(a, stream);
    case 8: return launch_typed<T, 8>(a, stream);
    default: return cudaErrorInvalidValue;  // hd > 256
  }
}

}  // namespace

REPRO_EXPORT int tree_attention_rows_per_block() { return kRows; }

// q [B, n, Hq, hd], k/v [B, S, Hkv, hd], mask [B, n, S] (bytes), out like q;
// all contiguous and 16-byte aligned (8 for bf16), hd % 4 == 0, at most 32
// splits of split_keys (a multiple of 32) keys.  part_acc/part_ml/counters sized by the caller from
// rows_per_block (counters zeroed once; the kernel leaves them zero).
REPRO_EXPORT int tree_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* part_acc,
                                       void* part_ml, void* counters, int B, int n, int Hq,
                                       int Hkv, int hd, int S, int split_keys, float scale,
                                       int dtype, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.n = n;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.S = S;
  a.split_keys = split_keys;
  a.n_splits = (S + split_keys - 1) / split_keys;
  a.n_rowtiles = ((Hq / Hkv) * n + kRows - 1) / kRows;
  a.scale = scale;
  if (split_keys % kTile != 0 || Hq % Hkv != 0 || hd % 4 != 0 || a.n_splits > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == DT_F32    ? launch_dpl<float>(a, st)
                  : dtype == DT_BF16 ? launch_dpl<__nv_bfloat16>(a, st)
                                     : cudaErrorInvalidValue;
  return (int)e;
}

// MLA's absorbed attention over the latent cache, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes it with XLA einsums
// (src/repro/models/mla.py:116-127, mla_cached); the port had left it to
// torch.einsum, whose reductions over the cache's keys and over the latent
// width pick their order by the number of query rows.  In bf16 a verify row
// among n then took other bits than the greedy decode's row alone.
//
// What it computes.  Every head of a query attends the same keys: one
// shared latent row ckv [KL] and rotary key krope [RD] a cache row.  Head h
// of query i has q_lat = q_nope W_uk (the absorbed query, [KL]) and q_rope
// [RD]; its score against row s is (q_lat . ckv[s] + q_rope . krope[s]) *
// scale, its softmax runs in f32 over the rows its mask row attends, and
// its output is the probability-weighted sum of ckv rows, lat [KL] (W_uv is
// applied after, by the batched serving product).  A query that sees no
// row gives 0.
//
// Its order of summation is set by the query's attended keys' ranks, as in
// attention.cuh (whose per-query rank scan, rank_map, and f32 online
// softmax step, online_step8, it shares): rank p of a query's attended keys
// is key position p of the kernel's tiles, warps and lanes, wherever the
// key lies in the cache, and a block holds the heads of one query, so a
// row's scores, its softmax and its merges are the same operations in the
// same order whatever n, B or the heads beside it are, and a key moved one
// row changes nothing.
//
// Design (a simple kernel: it is bound by latency at the serving shapes,
// minicpm3-4b's H 40, KL 256, RD 32 over S 512 with a few dozen live keys,
// far below both the card's byte and operation rates).  A block of 4 warps
// takes kRows = 8 heads of one query: grid (B x n, ceil(H / 8)).  The
// query rows [8][KL + RD] and a tile of 32 keys [32][KL + RD] sit in shared
// memory in f32 (bf16 inputs converted as they are staged; every product
// and sum runs in f32 on CUDA cores, as the f32 path of attention.cuh: lane
// (j, quarter) of warp w takes key w*8 + j of the tile and every fourth
// 16-byte column group, one independent partial dot per row, then
// online_step8).  The values are the key tile's first KL columns (the
// latent rows themselves): each lane owns two columns of every 64 and walks
// the warp's 8 keys in order.  The ranks are mapped to rows a window of
// kMapKeys at a time.  At the end the four warps' (max, sum, acc) merge in
// the fixed order w = 0..3, and the output is rounded once to the dtype.
#include "attention.cuh"

namespace {

constexpr int kLatRows = 8;     // heads of one query a block
constexpr int kLatKeys = 32;    // keys a tile: 8 a warp
constexpr int kMapKeys = 1024;  // ranks mapped to rows at a time
constexpr int kLoadBatch = 6;   // a thread's 4-value granules of a key tile in flight at once

struct LatentArgs {
  const void* q_lat;   // [B, n, H, KL]
  const void* q_rope;  // [B, n, H, RD]
  const void* ckv;     // [B, S, KL]
  const void* krope;   // [B, S, RD]
  const uint8_t* mask;  // [B, n, S]
  void* out;           // [B, n, H, KL]
  int B, n, H, KL, RD, S;
  float scale;
};

// dynamic shared memory, in floats: Q [kLatRows][ld], K [kLatKeys][ldk],
// P [kWarps][kLatRows][8], the rank map (ints); the warps' merge (Mw, Lw
// [kWarps][kLatRows], Aw [kWarps][kLatRows][KL]) reuses K's room
struct LatentSmem {
  int ld, ldk, q, k, p, map, mw, lw, aw, total;  // offsets in 4-byte words
};

__host__ __device__ inline LatentSmem latent_layout(int KL, int RD) {
  LatentSmem L{};
  const int D = KL + RD;
  L.ld = D;
  L.ldk = D + ((D / 4) % 2 == 0 ? 4 : 0);  // 8 lanes reading 8 keys hit 8 bank groups
  L.q = 0;
  L.k = L.q + kLatRows * L.ld;
  L.p = L.k + kLatKeys * L.ldk;
  L.map = L.p + kWarps * kLatRows * 8;
  L.mw = L.k;
  L.lw = L.mw + kWarps * kLatRows;
  L.aw = L.lw + kWarps * kLatRows;
  const int merge_end = L.aw + kWarps * kLatRows * KL;
  const int end = L.map + kMapKeys;
  L.total = (merge_end > end ? merge_end : end) * 4;
  return L;
}

// four consecutive values at src (16-byte aligned for f32, 8 for bf16) as f32
__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// W: column pairs a lane owns in the values, 2 * 32 * W >= KL
template <typename T, int W>
__global__ void __launch_bounds__(kThreads) latent_attention_kernel(LatentArgs a) {
  constexpr int R = kLatRows, NK = kLatKeys, KW = NK / kWarps;
  extern __shared__ __align__(16) float sm[];
  __shared__ float s_wt[kWarps][R], s_l[R];
  const LatentSmem L = latent_layout(a.KL, a.RD);
  const int KL = a.KL, RD = a.RD, D = KL + RD;
  const int bq = blockIdx.x, b = bq / a.n, h0 = blockIdx.y * R;
  const int rows = min(R, a.H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* ql = static_cast<const T*>(a.q_lat);
  const T* qr = static_cast<const T*>(a.q_rope);
  const T* ckv = static_cast<const T*>(a.ckv);
  const T* kr = static_cast<const T*>(a.krope);
  float* Qs = sm + L.q;
  float* Ks = sm + L.k;
  int* Map = reinterpret_cast<int*>(sm + L.map);

  // the block's query rows: head h0 + r of query bq, zeros past the heads
  const int g4 = D / 4;  // 4-value granules a row
  for (int idx = tid; idx < R * g4; idx += kThreads) {
    const int r = idx / g4, e = (idx % g4) * 4;
    const long long row = (long long)bq * a.H + h0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = e < KL ? load4(ql + row * KL + e) : load4(qr + row * RD + e - KL);
    *reinterpret_cast<float4*>(Qs + r * L.ld + e) = v;
  }

  float m_run[R], l_run[R], acc[R * W * 2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNeg;
    l_run[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < R * W * 2; ++i) acc[i] = 0.f;

  const uint8_t* mrow = a.mask + (long long)bq * a.S;
  const int j = lane % 8, quarter = lane / 8, key = warp * KW + j;
  float* Pw = sm + L.p + warp * R * 8;
  for (int r0 = 0;; r0 += kMapKeys) {
    // ranks [r0, end) of the query's attended keys, mapped to their rows
    const int found = rank_map(mrow, a.S, r0, r0 + kMapKeys, Map);
    const int end = min(found, r0 + kMapKeys);
    for (int t0 = r0; t0 < end; t0 += NK) {
      __syncthreads();  // the previous tile is spent (and Q staged, at the first)
      // a thread's granules kLoadBatch at a time: their loads in flight together
      for (int base = tid; base < NK * g4; base += kThreads * kLoadBatch) {
        float4 v[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int idx = base + u * kThreads, jj = idx / g4, e = (idx % g4) * 4;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (idx < NK * g4 && t0 + jj < end) {
            const long long row = (long long)b * a.S + Map[t0 - r0 + jj];
            v[u] = e < KL ? load4(ckv + row * KL + e) : load4(kr + row * RD + e - KL);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int idx = base + u * kThreads;
          if (idx < NK * g4)
            *reinterpret_cast<float4*>(Ks + idx / g4 * L.ldk + (idx % g4) * 4) = v[u];
        }
      }
      __syncthreads();
      // scores of the warp's 8 keys: one partial dot a row a lane, over every
      // fourth 16-byte column group
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
      const float* krow = Ks + key * L.ldk;
      for (int d = 4 * quarter; d < D; d += 16) {
        const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + r * L.ld + d);
          dot[r] = fmaf(qv.x, kk.x, dot[r]);
          dot[r] = fmaf(qv.y, kk.y, dot[r]);
          dot[r] = fmaf(qv.z, kk.z, dot[r]);
          dot[r] = fmaf(qv.w, kk.w, dot[r]);
        }
      }
      const bool key_on = t0 + key < end;
      float alpha[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {  // every row, so the rows' chains interleave
        const float p = online_step8(dot[r], key_on, a.scale, m_run[r], l_run[r], alpha[r]);
        if (quarter == 0) Pw[r * 8 + j] = p;
      }
      __syncwarp();
      // acc += p v over the warp's 8 keys in order: lane owns columns 2c, 2c + 1
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int c = 2 * (lane + 32 * u);
        if (c < KL) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[(r * W + u) * 2] *= alpha[r];
            acc[(r * W + u) * 2 + 1] *= alpha[r];
          }
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 vv = *reinterpret_cast<const float2*>(Ks + (warp * KW + jj) * L.ldk + c);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float p = Pw[r * 8 + jj];
              acc[(r * W + u) * 2] = fmaf(p, vv.x, acc[(r * W + u) * 2]);
              acc[(r * W + u) * 2 + 1] = fmaf(p, vv.y, acc[(r * W + u) * 2 + 1]);
            }
          }
        }
      }
      __syncwarp();  // the warp's p tile is read before the next tile writes it
    }
    if (found < r0 + kMapKeys) break;
  }
  __syncthreads();  // the key tile's room takes the merge

  // ---- merge the four warps' (max, sum, acc) in the order w = 0..3 ----
  float* Mw = sm + L.mw;
  float* Lw = sm + L.lw;
  float* Aw = sm + L.aw;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      Mw[warp * R + r] = m_run[r];
      Lw[warp * R + r] = l_run[r];
    }
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const int c = 2 * (lane + 32 * u);
      if (c < KL)
        *reinterpret_cast<float2*>(Aw + (warp * R + r) * KL + c) =
            make_float2(acc[(r * W + u) * 2], acc[(r * W + u) * 2 + 1]);
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
    s_l[tid] = l;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int idx = tid; idx < rows * KL; idx += kThreads) {
    const int rl = idx / KL, c = idx % KL;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o = fmaf(Aw[(w * R + rl) * KL + c], s_wt[w][rl], o);
    out[((long long)bq * a.H + h0 + rl) * KL + c] = from_f32<T>(s_l[rl] > 0.f ? o / s_l[rl] : 0.f);
  }
}

template <typename T, int W>
cudaError_t launch_latent(const LatentArgs& a, cudaStream_t stream) {
  static int allowed[kMaxCards] = {};
  const int smem = latent_layout(a.KL, a.RD).total;
  auto kern = latent_attention_kernel<T, W>;
  cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.B * a.n, (a.H + kLatRows - 1) / kLatRows), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_latent_typed(const LatentArgs& a, cudaStream_t stream) {
  switch ((a.KL + 63) / 64) {
    case 1: return launch_latent<T, 1>(a, stream);
    case 2: return launch_latent<T, 2>(a, stream);
    case 3: return launch_latent<T, 3>(a, stream);
    case 4: return launch_latent<T, 4>(a, stream);
    default: return cudaErrorInvalidValue;  // KL > 256
  }
}

}  // namespace

// q_lat [B, n, H, KL], q_rope [B, n, H, RD], ckv [B, S, KL], krope [B, S, RD],
// mask [B, n, S] (bytes), out [B, n, H, KL]; all contiguous, of one dtype
// (DT_F32 or DT_BF16), 16-byte aligned; KL and RD multiples of 4, KL <= 256.
// scale multiplies every score.  No scratch: the only write is out.
REPRO_EXPORT int latent_attention_launch(const void* q_lat, const void* q_rope, const void* ckv,
                                         const void* krope, const void* mask, void* out, int B,
                                         int n, int H, int KL, int RD, int S, float scale,
                                         int dtype, void* stream) {
  LatentArgs a{q_lat, q_rope, ckv, krope, static_cast<const uint8_t*>(mask), out,
               B, n, H, KL, RD, S, scale};
  if (B < 1 || n < 1 || H < 1 || S < 1 || KL < 4 || KL % 4 || RD < 0 || RD % 4 ||
      (long long)B * n > 2147483647LL || (H + kLatRows - 1) / kLatRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == DT_BF16  ? launch_latent_typed<__nv_bfloat16>(a, st)
                        : dtype == DT_F32 ? launch_latent_typed<float>(a, st)
                                          : cudaErrorInvalidValue;
  return (int)e;
}

// AWQ groupwise int4 dequant-GEMM for Hopper (sm_90a): out = x @ ((q - z) * s).
//
// Replaces the Pallas kernel int4_matmul_pallas
// (src/repro/kernels/int4_matmul.py:52, body _kernel at :23): the weight
// streams from device memory packed, two 4-bit values per byte along K
// (low nibble even k), and is dequantized next to the product; the dense
// weight never reaches device memory.
//
// What bounds it: bytes, in principle.  At the serving paths' M (1 to 16
// rows of x) the kernel is a stream over the packed weight plus 8 bytes of
// scale and zero per column and group (12.5 % on top at group 128): 0.0099
// ms for llama3-8b's wg (K 4096, N 14336) at 3.35 TB/s.  In practice the
// unpacking: on an H100 the stream alone reads wg in the time of torch's
// _weight_int4pack_mm, and the conversions and MMAs that follow each ring
// stage add about 0.01 ms (tools/weight_stream_variants.py, PERF.md).
//
// Design: weight_stream.cuh (the split grid over all SMs in whole groups,
// the cp.async ring, x staged once, the in-kernel split combine in a fixed
// order).  The arithmetic is factored per group g and column n:
//
//   sum_k x_k (q_k - z) s  =  s * (d - z * X),  d = sum_k x_k q_k,  X = sum_k x_k,
//
// so a nibble costs its conversion and its multiply-adds; the subtract and
// the multiply run once per group and column, and X once per row and group
// (in stage_x).  The dequantized weight is never rounded.  The scales and
// zeros of the block's groups travel with the first stage of the ring, so
// no warp waits on them at a group boundary.
// * bf16, group % 16 == 0 (Int4Mma): d on tensor cores.  A nibble is exact
//   in bf16: byte j of a word and of the word shifted by 4 become the bf16
//   pair (128 + q_lo, 128 + q_hi) by one PRMT and one LOP3 under the
//   exponent byte 0x43, and one bf16x2 FMA takes 128 off — three
//   instructions per two nibbles, and a shift per four.  The products x * q
//   are exact in the MMA's f32 sum.  A stage is 32 packed rows (64 values of
//   K) of the 256-column tile, 5 stages; the 16-byte granules of a row are
//   permuted by the row mod 4 (Swz), so that the lanes' 4-byte reads fall in
//   32 banks without padding (padded rows were slower).  Warp w
//   owns columns 32w..32w+31 through a permutation of the MMA's n: lane
//   (g, t) reads the word of columns 32w + 4g .. 4g+3, and byte j of it is
//   column 4g + j of n8 tile j, so one 4-byte read serves four MMAs and a
//   lane's results are the eight neighbouring columns 32w + 8t .. 8t+7.
// * f32, and bf16 with another group (Int4Generic<T, MT>): CUDA cores.  Lane
//   l owns columns 4l..4l+3 of its warp's 128 (one 4-byte read per packed
//   row), and the four warps that share them split the packed rows by
//   phase (p mod 4); per nibble one PRMT under the exponent of 2^23 and one
//   subtract make the float, then MT fmaf.  A warp folds d into its sum at
//   the end of each group with the X of its own rows; the phases meet in
//   shared memory in order.  MT is the fewest of 1, 2, 4, 8 that hold M
//   (halved while x would not fit in shared memory); a row's chain is the
//   same for every MT.
// A ragged N, or a packed base, scales or zeros that no 16-byte copy fits,
// takes byte loads for the packed rows and 4-byte copies for the scales.
#include "weight_stream.cuh"

namespace {

template <typename T_>
struct Int4Args {
  const T_* x;
  const uint8_t* qw;  // [K/2, N]
  const float* scales;
  const float* zeros;  // [K/group, N]
  T_* out;
  Split sp;
  int group;
  int xr;     // Int4Mma: rows of x held in shared memory, min(M, 16)
  int x_vec;  // Int4Mma: x rows load 16 bytes at a time
};

// The packed rows of stage `step` (and with the first stage the block's
// scales and zeros) into shared memory.
template <bool kVec, int KTP, int LDQ, class Z, typename T>
__device__ __forceinline__ void load_q(const Int4Args<T>& a, const Block& b, unsigned char* ring,
                                        unsigned char* sz, int step, int slot) {
  const int N = a.sp.N, p0 = b.kb0 / 2 + step * KTP, p1 = b.kb1 / 2;
  unsigned char* dst = ring + slot * (KTP * LDQ);
  if constexpr (kVec)
    copy_rows<16, kTileN, Z>(dst, LDQ, a.qw, N, p0, KTP, p1, b.n0, N);
  else
    copy_rows_bytes<kTileN, Z>(dst, LDQ, a.qw, N, p0, KTP, p1, b.n0, N);
  if (step == 0) {
    const int g0 = b.kb0 / a.group, ng = (b.kb1 - b.kb0) / a.group;
    const int gb = a.sp.k_per_split / a.group;  // rows of the scale and zero tiles
    constexpr int GR = kVec ? 16 : 4;
    copy_rows<GR, kTileN * 4>(sz, kTileN * 4, a.scales, 4LL * N, g0, ng, g0 + ng, 4 * b.n0, 4 * N);
    copy_rows<GR, kTileN * 4>(sz + gb * kTileN * 4, kTileN * 4, a.zeros, 4LL * N, g0, ng, g0 + ng,
                              4 * b.n0, 4 * N);
  }
}

// byte j of w (low nibble: even k) and of w4 = w >> 4 (high nibble: odd k)
// as the bf16 pair (q_lo, q_hi): each nibble under the exponent byte 0x43
// is the bf16 128 + q (bf16 keeps 7 bits of mantissa, so the high nibble
// has to move down first), and one bf16x2 FMA takes 128 off, exactly
__device__ __forceinline__ unsigned nibbles_bf16x2(uint32_t w, uint32_t w4, int j) {
  const uint32_t v = (__byte_perm(w, w4, 0x0400u + 0x0101u * j) & 0x000F000Fu) | 0x43004300u;
  const uint32_t one = 0x3F803F80u, bias = 0xC300C300u;  // (1, 1) and (-128, -128)
  const __nv_bfloat162 r =
      __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&one),
              *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const unsigned*>(&r);
}

// nibble c of four (one per byte of ``nib``, each 0..15) as a float: byte c
// moved under the exponent byte of 2^23 (one PRMT), then 2^23 taken off, exactly
__device__ __forceinline__ float nibble_to_f32(uint32_t nib, int c) {
  return __uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7650u + c)) - 8388608.f;
}

// ---- bf16, group % 16 == 0: d on tensor cores -------------------------------------

template <bool kVec>
struct Int4Mma {
  using T = __nv_bfloat16;
  using Args = Int4Args<T>;
  static constexpr int P = 1, kStages = 5, kRows = kRowTile;
  static constexpr int KTP = 32;            // packed rows per stage (64 values of K)
  static constexpr int LDQ = kTileN;  // rows unpadded, granules permuted by row mod 4
  using Z = Swz<4, 1>;                // granule j ^ 2 (r mod 4): lanes t = 0..3 in 32 banks

  // [ring][scales gb x 256][zeros gb x 256][X gb x 16][x xr x ldx bf16]
  __host__ __device__ static int ldx(int k_per_split) { return k_per_split + 8; }
  static int smem_bytes(int k_per_split, int group, int xr) {
    const int gb = k_per_split / group;
    return kStages * KTP * LDQ + gb * (2 * kTileN + kRowTile) * 4 +
           xr * ldx(k_per_split) * 2;
  }

  const Args& a;
  Block b;
  unsigned char* smem;
  float* sc;  // scales, then zeros at sc + gb * kTileN
  float* sx;  // X [group][16]
  T* xs;
  int gb, ldx_, gi, left;  // groups per split, x stride, group in progress, k16 steps left in it
  float d[4][4], acc[4][4];  // n8 tile j, fragment e: row g + 8 (e / 2), column 8t + 4 (e % 2) + j

  __device__ Int4Mma(const Args& a_, unsigned char* sm) : a(a_), smem(sm) {
    b = block_of(a.sp, kRows);
    gb = a.sp.k_per_split / a.group;
    ldx_ = ldx(a.sp.k_per_split);
    sc = reinterpret_cast<float*>(smem + kStages * KTP * LDQ);
    sx = sc + 2 * gb * kTileN;
    xs = reinterpret_cast<T*>(sx + gb * kRowTile);
    gi = 0;
    left = a.group / 16;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[j][e] = acc[j][e] = 0.f;
  }
  __device__ int steps() const { return ((b.kb1 - b.kb0) / 2 + KTP - 1) / KTP; }

  __device__ void load_stage(int step, int slot) {
    load_q<kVec, KTP, LDQ, Z>(a, b, smem, reinterpret_cast<unsigned char*>(sc), step, slot);
  }

  __device__ void stage_x() {
    const int nk = b.kb1 - b.kb0;
    stage_rows_bf16(xs, ldx_, a.xr, nk, a.x, a.sp.K, a.sp.M, b.m0, b.kb0, b.kb1, a.x_vec);
    __syncthreads();
    // X per (group, row) in a fixed order: eight interleaved chains, then a tree
    const int ng = nk / a.group;
    for (int i = threadIdx.x; i < ng * kRowTile; i += kThreads) {
      const int g = i / kRowTile, r = i % kRowTile;
      float s = 0.f;
      if (r < b.rows) {
        float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const T* xr = xs + r * ldx_ + g * a.group;
        for (int k = 0; k < a.group; k += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xr + k);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(h[q]);
            c[2 * q] += f.x;
            c[2 * q + 1] += f.y;
          }
        }
        s = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5]) + (c[6] + c[7]));
      }
      sx[i] = s;
    }
  }

  __device__ void compute(int it, int slot) {
    const unsigned char* q = smem + slot * KTP * LDQ;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int mi = lane / 8, mr = lane % 8, row = mr + (mi & 1) * 8;
    const int nk = b.kb1 - b.kb0;
#pragma unroll
    for (int ks = 0; ks < KTP / 8; ++ks) {
      const int kl = it * 2 * KTP + ks * 16;
      if (kl >= nk) break;  // the same for the whole block
      unsigned xa[4];
      // rows past the tile's read row 0: their sums are never stored
      ldsm_x4(xa, xs + (row < b.rows ? row : 0) * ldx_ + kl + (mi >> 1) * 8);
      // rows ks*8 + t and + 4 (the same mod 4), columns 32 warp + 4g .. 4g+3
      const unsigned char* qr = q + (ks * 8 + t) * LDQ + Z::at(t, warp * 32 + g * 4);
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(qr);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(qr + 4 * LDQ);
      const uint32_t w04 = w0 >> 4, w14 = w1 >> 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(d[j], xa, nibbles_bf16x2(w0, w04, j), nibbles_bf16x2(w1, w14, j));
      if (--left == 0) end_group();
    }
  }

  // acc += s * (d - z * X) for the group just finished
  __device__ void end_group() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* s = sc + gi * kTileN + warp * 32 + 8 * t;
    const float* z = s + gb * kTileN;
    const float4 s0 = *reinterpret_cast<const float4*>(s);
    const float4 s1 = *reinterpret_cast<const float4*>(s + 4);
    const float4 z0 = *reinterpret_cast<const float4*>(z);
    const float4 z1 = *reinterpret_cast<const float4*>(z + 4);
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
    const float x0 = sx[gi * kRowTile + g], x1 = sx[gi * kRowTile + g + 8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (e & 1) + j;
        acc[j][e] = fmaf(sv[c], fmaf(-zv[c], e < 2 ? x0 : x1, d[j][e]), acc[j][e]);
        d[j][e] = 0.f;
      }
    ++gi;
    left = a.group / 16;
  }

  __device__ void finish() {}

  template <class F>
  __device__ void emit(F&& f) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v[4] = {acc[0][e], acc[1][e], acc[2][e], acc[3][e]};
      f(g + 8 * (e >> 1), warp * 32 + 8 * t + 4 * (e & 1), std::integral_constant<int, 4>{}, v);
    }
  }

  static __device__ __forceinline__ float value(const float (&v)[1]) { return v[0]; }
};

// ---- f32 (and bf16 of another group) on CUDA cores ---------------------------------

constexpr int kHalfN = 128;  // Int4Generic: the columns of a warp (32 lanes x 4) ...
constexpr int kPhases = 4;   // ... and the warps that share them, each a phase of K

// Int4Generic: warp w owns columns (w / kPhases) * kHalfN + 4 * lane and
// the K phase w % kPhases.  The phases' sums v[MT][4] are added in the order
// ((p0 + p1) + p2) + p3 into phase 0's v, through red ((kPhases - 1) * MT *
// kTileN floats of shared memory, free once every thread has arrived).
__device__ __forceinline__ int phase_col() {
  return (threadIdx.x / 32 / kPhases) * kHalfN + (threadIdx.x % 32) * 4;
}
template <int MT>
__device__ __forceinline__ void sum_phases(float (&v)[MT][4], float* red) {
  const int phase = threadIdx.x / 32 % kPhases, col = phase_col();
  __syncthreads();
  if (phase > 0) {
#pragma unroll
    for (int r = 0; r < MT; ++r)
      *reinterpret_cast<float4*>(red + ((phase - 1) * MT + r) * kTileN + col) =
          make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
  }
  __syncthreads();
  if (phase == 0) {
#pragma unroll
    for (int p = 0; p < kPhases - 1; ++p)
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        const float4 t = *reinterpret_cast<const float4*>(red + (p * MT + r) * kTileN + col);
        v[r][0] += t.x;
        v[r][1] += t.y;
        v[r][2] += t.z;
        v[r][3] += t.w;
      }
  }
  __syncthreads();
}


template <typename T_, int MT, bool kVec>
struct Int4Generic {
  using T = T_;
  using Args = Int4Args<T>;
  static constexpr int P = 1, kStages = MT >= 8 ? 4 : 6, kRows = MT;
  static constexpr int KTP = 32;      // packed rows per stage
  static constexpr int LDQ = kTileN;  // a warp reads 128 neighbouring bytes: no bank conflict

  // [ring][scales gb x 128][zeros gb x 128][X gb x 4 x MT][x k_per_split x MT f32, K to 4]
  static int smem_bytes(int k_per_split, int group) {
    const int gb = k_per_split / group;
    const int main = kStages * KTP * LDQ + gb * (2 * kTileN + kPhases * MT) * 4 +
                     round_up(k_per_split, 4) * MT * 4;
    const int red = (kPhases - 1) * MT * kTileN * 4;  // sum_phases, after the ring
    return main > red ? main : red;
  }

  const Args& a;
  Block b;
  unsigned char* smem;
  float* sc;   // scales, then zeros at sc + gb * kTileN
  float* sxw;  // X per (group, phase, row): over the packed rows of the phase
  float* xs;   // [k][MT]
  int gb, gp, cur, gend;  // groups per split, packed rows per group, group in progress, its end
  float d[MT][4], acc[MT][4];

  __device__ Int4Generic(const Args& a_, unsigned char* sm) : a(a_), smem(sm) {
    b = block_of(a.sp, kRows);
    gb = a.sp.k_per_split / a.group;
    gp = a.group / 2;
    cur = -1;
    gend = 0;
    sc = reinterpret_cast<float*>(smem + kStages * KTP * LDQ);
    sxw = sc + 2 * gb * kTileN;
    xs = sxw + gb * kPhases * MT;
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) d[r][c] = acc[r][c] = 0.f;
  }
  __device__ int steps() const { return ((b.kb1 - b.kb0) / 2 + KTP - 1) / KTP; }

  __device__ void load_stage(int step, int slot) {
    load_q<kVec, KTP, LDQ, NoSwz>(a, b, smem, reinterpret_cast<unsigned char*>(sc), step, slot);
  }

  __device__ void stage_x() {
    const int nk = b.kb1 - b.kb0;
    stage_cols_f32<T, MT>(xs, round_up(nk, 4), a.x, a.sp.K, a.sp.M, b.m0, b.kb0, b.kb1);
    __syncthreads();
    // X per (group, phase, row) over the packed rows p = phase mod 4 of the group
    const int ng = nk / a.group;
    for (int i = threadIdx.x; i < ng * kPhases * MT; i += kThreads) {
      const int r = i % MT, w = (i / MT) % kPhases, g = i / (MT * kPhases);
      float s = 0.f;
      for (int p = g * gp + ((w - g * gp) % kPhases + kPhases) % kPhases; p < (g + 1) * gp;
           p += kPhases) {
        s += xs[2 * p * MT + r];
        s += xs[(2 * p + 1) * MT + r];
      }
      sxw[i] = s;
    }
  }

  __device__ void end_group() {
    if (cur < 0) return;
    const int phase = threadIdx.x / 32 % kPhases, col = phase_col();
    const float4 s4 = *reinterpret_cast<const float4*>(sc + cur * kTileN + col);
    const float4 z4 = *reinterpret_cast<const float4*>(sc + (gb + cur) * kTileN + col);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float X = sxw[(cur * kPhases + phase) * MT + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(sv[c], fmaf(-zv[c], X, d[r][c]), acc[r][c]);
        d[r][c] = 0.f;
      }
    }
  }

  __device__ void compute(int it, int slot) {
    const unsigned char* q = smem + slot * KTP * LDQ;
    const int phase = threadIdx.x / 32 % kPhases, col = phase_col();
    const int np = (b.kb1 - b.kb0) / 2;
#pragma unroll 2
    for (int i = phase; i < KTP; i += kPhases) {
      const int p = it * KTP + i;
      if (p >= np) break;  // the same for the whole warp
      if (p >= gend) {     // a new group (the division runs once per group)
        end_group();
        cur = p / gp;
        gend = (cur + 1) * gp;
      }
      const uint32_t w = *reinterpret_cast<const uint32_t*>(q + i * LDQ + col);
      float xl[MT], xh[MT];
      load_x<MT>(xl, xs + 2 * p * MT);
      load_x<MT>(xh, xs + (2 * p + 1) * MT);
      const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float ql = nibble_to_f32(lo, c), qh = nibble_to_f32(hi, c);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          d[r][c] = fmaf(xl[r], ql, d[r][c]);
          d[r][c] = fmaf(xh[r], qh, d[r][c]);
        }
      }
    }
  }

  __device__ void finish() {
    end_group();
    sum_phases<MT>(acc, reinterpret_cast<float*>(smem));
  }

  template <class F>
  __device__ void emit(F&& f) const {
    if (threadIdx.x / 32 % kPhases) return;  // phase 0 holds the block's sums
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      const float v[4] = {acc[r][0], acc[r][1], acc[r][2], acc[r][3]};
      f(r, phase_col(), std::integral_constant<int, 4>{}, v);
    }
  }

  static __device__ __forceinline__ float value(const float (&v)[1]) { return v[0]; }
};

template <typename T, bool kVec, int MT>
cudaError_t launch_generic_mt(const Int4Args<T>& a, cudaStream_t st) {
  using Op = Int4Generic<T, MT, kVec>;
  return launch_op<Op>(a, Op::smem_bytes(a.sp.k_per_split, a.group), st);
}

template <typename T, bool kVec>
cudaError_t launch_generic(const Int4Args<T>& a, int rows, cudaStream_t st) {
  // rows per block: the fewest that hold M, halved while x does not fit
  int mt = rows == 1 ? 1 : rows == 2 ? 2 : rows <= 4 ? 4 : 8;
  auto bytes = [&](int m) {
    switch (m) {
      case 1: return Int4Generic<T, 1, kVec>::smem_bytes(a.sp.k_per_split, a.group);
      case 2: return Int4Generic<T, 2, kVec>::smem_bytes(a.sp.k_per_split, a.group);
      case 4: return Int4Generic<T, 4, kVec>::smem_bytes(a.sp.k_per_split, a.group);
      default: return Int4Generic<T, 8, kVec>::smem_bytes(a.sp.k_per_split, a.group);
    }
  };
  while (mt > 1 && bytes(mt) > kSmemMax) mt /= 2;
  switch (mt) {
    case 1: return launch_generic_mt<T, kVec, 1>(a, st);
    case 2: return launch_generic_mt<T, kVec, 2>(a, st);
    case 4: return launch_generic_mt<T, kVec, 4>(a, st);
    default: return launch_generic_mt<T, kVec, 8>(a, st);
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* qw, const void* sc, const void* zr, void* out,
                         float* part, int* counters, int M, int K, int N, int group,
                         int k_per_split, int splits, int rows_per_pass, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sc) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(zr) % 16 == 0;
  // the path is a function of the dtype, the group and the split alone, never of M
  const bool mma = kBf16 && group % 16 == 0 &&
                   Int4Mma<true>::smem_bytes(k_per_split, group, kRowTile) <= kSmemMax;
  // with a split, rows pass through the partials [splits, rows_per_pass, ldp] in turn
  const int pass = splits > 1 ? rows_per_pass : M;
  for (int r0 = 0; r0 < M; r0 += pass) {
    const int rows = min(pass, M - r0);
    Int4Args<T> a;
    a.x = static_cast<const T*>(x) + (long long)r0 * K;
    a.qw = static_cast<const uint8_t*>(qw);
    a.scales = static_cast<const float*>(sc);
    a.zeros = static_cast<const float*>(zr);
    a.out = static_cast<T*>(out) + (long long)r0 * N;
    a.sp = Split{rows, K, N, k_per_split, splits, part, counters, round_up(N, 4)};
    a.group = group;
    a.xr = min(rows, kRowTile);
    a.x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
    cudaError_t e;
    if constexpr (kBf16) {
      if (mma)
        e = vec ? launch_op<Int4Mma<true>>(a, Int4Mma<true>::smem_bytes(k_per_split, group, a.xr),
                                           st)
                : launch_op<Int4Mma<false>>(
                      a, Int4Mma<false>::smem_bytes(k_per_split, group, a.xr), st);
      else
        e = vec ? launch_generic<T, true>(a, rows, st) : launch_generic<T, false>(a, rows, st);
    } else {
      e = vec ? launch_generic<T, true>(a, rows, st) : launch_generic<T, false>(a, rows, st);
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// x [M, K] (f32 or bf16), qweight uint8/int8 [K/2, N] packed (low nibble
// even k), scales/zeros f32 [K/group, N], out [M, N] in x's type; all
// contiguous.  K splits of k_per_split (a multiple of the group, from
// ops.stream_plan); with splits > 1, part is an f32 [splits,
// min(M, rows_per_pass), N rounded up to 4] and counters holds a zero per
// (row tile, column tile) of a pass.
REPRO_EXPORT int int4_matmul_launch(const void* x, const void* qweight, const void* scales,
                                    const void* zeros, void* out, void* part, void* counters,
                                    int M, int K, int N, int group, int k_per_split, int splits,
                                    int rows_per_pass, int dtype, void* stream) {
  if (group <= 0 || group % 2 || K % group ||
      !plan_ok(M, K, N, k_per_split, splits, group, rows_per_pass) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  cudaError_t e =
      dtype == DT_F32 ? launch_typed<float>(x, qweight, scales, zeros, out, p, c, M, K, N, group,
                                            k_per_split, splits, rows_per_pass, st)
      : dtype == DT_BF16
          ? launch_typed<__nv_bfloat16>(x, qweight, scales, zeros, out, p, c, M, K, N, group,
                                        k_per_split, splits, rows_per_pass, st)
          : cudaErrorInvalidValue;
  return (int)e;
}

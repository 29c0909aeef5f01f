// KV-cache row moves for Hopper (sm_90a): for every row leaf i of a cache,
// out_i[u, b, dst[b, m]] = arr_i[u, b, src[b, m]] for every active move m,
// as a parallel assignment, all leaves in one launch.
//
// Replaces the Pallas kernel kv_move_rows_pallas
// (src/repro/kernels/kv_moves.py:112, body _kv_move_kernel at :58), which
// verify compaction and the draft re-root run on every row leaf [U, B, S, F]
// of the caches.  A move is active when its mask is set and 0 <= src, dst < S;
// everything else is dropped.  copy_through = 0 moves in place (out == arr:
// the donating path); copy_through = 1 writes a fresh out and never writes
// arr (the snapshot-preserving path): the rows that no active move writes
// are copied from arr, the TPU kernel's slab DMA.
//
// What bounds it: bytes — pure data movement, one read and one write of the
// U*B*A*F elements of the A active moves (plus, copying through, one read
// and one write of every other row).  At the paths' shapes that is 0.5-20
// MB, a few microseconds: the launch, the plan and the latency of one round
// trip to memory are the cost to cut.
//
// Design:
// - One launch for all row leaves: the leaves travel in a pointer table
//   passed by value (each its own U and row length F; B, S, dtype and the
//   plan shared), and the grid is one flat run of blocks, leaf by leaf.
// - A block owns one column chunk (the wrapper picks its width from the
//   shapes, ops.kv_move_plan) of one (leaf, u, b) slab, for all rows.  All
//   of its reads complete before its first write, so overlapping source and
//   destination windows stay a parallel assignment; no two blocks touch the
//   same bytes.  Chunks are small enough that the grid fills the card
//   several blocks deep, so one block's stores overlap another's loads.
// - The plan is read once per block and compacted (warp ballots) into a
//   list of active (src, dst) pairs in shared memory: the copy loops carry
//   no predicate, no plan reads and no division by a runtime width.
// - 16-byte rows move with Hopper's bulk copies (1-D TMA, no tensor map):
//   one cp.async.bulk per active row segment into shared memory, all
//   completing on one mbarrier, then one bulk store per segment.  In place
//   that pays where a segment is 256 bytes or more: 128-byte segments moved
//   faster through registers there (tools/kv_move_variants.py).  Other
//   widths and short in-place segments stage through registers, kBatch
//   elements in flight per thread.
// - Copying through, the same blocks also copy the slab: block c of a slab
//   takes the c-th range of rows, whole rows, and skips the rows that an
//   active move writes (a bitmap in shared memory), so copy and scatter
//   write disjoint rows and both only read arr.  Contiguous runs of rows go
//   through a ring of shared-memory stages with bulk copies, streamed by
//   the block's last thread; the moves are bulk copies too when copying
//   through, so no block barrier holds that thread back.
// Elements move as raw bytes, so any dtype moves exactly.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;            // register path: elements in flight per thread
constexpr int kMaxLeaves = 16;       // ops._KV_MAX_LEAVES
constexpr int kRing = 4;             // slab copy: stages of the ring ...
constexpr int kStageBytes = 8192;    // ... of this many bytes each
constexpr bool kBulk = true;         // 16-byte rows by bulk copies (false: registers): the
constexpr int kBulkMoveBytes = 256;  // slab always, moves copying through or from this chunk up

struct KvMoveTable {
  const void* arr[kMaxLeaves];  // [U, B, S, F] leaf
  void* out[kMaxLeaves];        // arr itself (in place) or a fresh leaf
  long long F[kMaxLeaves];      // row length, in elements of the kernel's width
  int U[kMaxLeaves];
  int chunks[kMaxLeaves];       // column chunks of a row = row ranges of the slab copy
  int block0[kMaxLeaves + 1];   // first block of each leaf; block0[L] is the grid
  int L;
};

struct KvMovePlan {
  const int* src;       // [B, M]
  const int* dst;       // [B, M]
  const uint8_t* mask;  // [B, M]
  int B, S, M;
  int chunk;            // columns of a block, in elements (a power of two)
  int chunk_shift;      // log2(chunk)
  int copy_through;
};

// shared memory of one block, in bytes from the base
struct Layout {
  unsigned bars, counts, pairs, map, stage, ring, total;
};

__host__ __device__ inline unsigned align_up(unsigned x, unsigned a) { return (x + a - 1) / a * a; }

__host__ __device__ inline Layout layout(int M, int S, int chunk_bytes, bool ring) {
  Layout l;
  l.bars = 0;                                   // 1 + kRing mbarriers
  l.counts = 8 * (1 + kRing);                   // active moves of each warp
  l.pairs = align_up(l.counts + 4 * kWarps, 16);  // M (src, dst) pairs
  l.map = l.pairs + 8 * (unsigned)M;            // S bits: rows an active move writes
  l.stage = align_up(l.map + 4 * (unsigned)((S + 31) / 32), 128);  // M segments
  l.ring = align_up(l.stage + (unsigned)M * (unsigned)chunk_bytes, 128);
  l.total = l.ring + (ring ? kRing * kStageBytes : 0);
  return l;
}

// ---- the kernel -----------------------------------------------------------------

// E: the width rows move in (16 bytes, or the widest the rows allow);
// BULK: the moves by bulk copies (E = uint4 only) or through registers.  The
// slab copy takes bulk copies whenever E is 16 bytes.
template <typename E, bool BULK>
__global__ void __launch_bounds__(kThreads)
    kv_move_leaves_kernel(const KvMoveTable t, const KvMovePlan p) {
  constexpr bool kBulkCopy = kBulk && sizeof(E) == 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this block's leaf, slab (u, b) and chunk c
  int leaf = 0;
  while ((int)blockIdx.x >= t.block0[leaf + 1]) ++leaf;
  const int C = t.chunks[leaf];
  const int rem = (int)blockIdx.x - t.block0[leaf];
  const int c = rem % C, b = (rem / C) % p.B, u = rem / C / p.B;
  const long long F = t.F[leaf];
  const long long slab = ((long long)u * p.B + b) * p.S * F;
  const E* a = static_cast<const E*>(t.arr[leaf]) + slab;
  E* o = static_cast<E*>(t.out[leaf]) + slab;

  const Layout l = layout(p.M, p.S, p.chunk * (int)sizeof(E), kBulkCopy && p.copy_through);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bars);
  int* counts = reinterpret_cast<int*>(smem + l.counts);
  int2* pairs = reinterpret_cast<int2*>(smem + l.pairs);
  unsigned* map = reinterpret_cast<unsigned*>(smem + l.map);
  unsigned char* stage = smem + l.stage;

  // the plan of row b, compacted to its active (src, dst) pairs in order
  if (p.copy_through)
    for (int i = tid; i < (p.S + 31) / 32; i += kThreads) map[i] = 0u;
  const int* sb = p.src + (long long)b * p.M;
  const int* db = p.dst + (long long)b * p.M;
  const uint8_t* mb = p.mask + (long long)b * p.M;
  int A = 0;
  for (int m0 = 0; m0 < p.M; m0 += kThreads) {
    const int m = m0 + tid;
    int s = 0, d = 0;
    bool act = false;
    if (m < p.M) {
      s = sb[m];
      d = db[m];
      act = mb[m] && s >= 0 && s < p.S && d >= 0 && d < p.S;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, act);
    if (lane == 0) counts[warp] = __popc(ball);
    __syncthreads();
    int before = A, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (act) pairs[before + __popc(ball & ((1u << lane) - 1u))] = make_int2(s, d);
    A += total;
    __syncthreads();  // counts are rewritten by the next pass
  }
  if (p.copy_through) {
    for (int i = tid; i < A; i += kThreads)
      atomicOr(&map[pairs[i].y >> 5], 1u << (pairs[i].y & 31));
  }
  __syncthreads();

  // ---- the moves: this chunk's columns of every active source row, then
  // of every destination row
  const long long f0 = (long long)c * p.chunk;
  const int fc = (int)min((long long)p.chunk, F - f0);
  if constexpr (BULK) {
    const unsigned seg = (unsigned)fc * 16u, pitch = (unsigned)p.chunk * 16u;
    if (A > 0) {
      if (tid == 0) {
        mbar_init(&bars[0], 1);
        fence_barrier_init();
        mbar_expect_tx(&bars[0], (unsigned)A * seg);
      }
      __syncthreads();
      for (int i = tid; i < A; i += kThreads)
        bulk_load(stage + (size_t)i * pitch, a + (long long)pairs[i].x * F + f0, seg, &bars[0]);
      if (tid < A) {  // a thread without a segment goes on (to the slab copy) at once
        mbar_wait(&bars[0], 0);
        for (int i = tid; i < A; i += kThreads)
          bulk_store(o + (long long)pairs[i].y * F + f0, stage + (size_t)i * pitch, seg);
        bulk_commit();
      }
    }
  } else {
    E* st = reinterpret_cast<E*>(stage);
    const int n = A << p.chunk_shift, cm = p.chunk - 1;
    for (int i0 = tid; i0 < n; i0 += kThreads * kBatch) {
      E r[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads, col = i & cm;
        if (i < n && col < fc) r[j] = a[(long long)pairs[i >> p.chunk_shift].x * F + f0 + col];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n && (i & cm) < fc) st[i] = r[j];
      }
    }
    __syncthreads();  // every source segment of this block is staged
    for (int i = tid; i < n; i += kThreads) {
      const int col = i & cm;
      if (col < fc) o[(long long)pairs[i >> p.chunk_shift].y * F + f0 + col] = st[i];
    }
  }

  // ---- copying through: the c-th range of whole rows, but for the rows an
  // active move writes
  if (p.copy_through) {
    const int per = (p.S + C - 1) / C;
    const int r0 = min(p.S, c * per), r1 = min(p.S, r0 + per);
    auto moved = [&](int r) { return (map[r >> 5] >> (r & 31)) & 1u; };
    if constexpr (kBulkCopy) {
      // the block's last thread streams the slab through the ring: piece q
      // of at most kStageBytes in stage q % kRing, and a stage refilled as
      // soon as its store has read it
      if (tid == kThreads - 1) {
        uint64_t* rb = &bars[1];
        unsigned char* ring = smem + l.ring;
        for (int k = 0; k < kRing; ++k) mbar_init(&rb[k], 1);
        fence_barrier_init();
        const long long row_bytes = F * 16;
        const unsigned char* ab = reinterpret_cast<const unsigned char*>(a);
        unsigned char* ob = reinterpret_cast<unsigned char*>(o);
        int r = r0;  // bytes [pos, end) of the current run of unmoved rows
        long long pos = 0, end = 0, off[kRing];
        unsigned len[kRing];
        auto load_next = [&](int q) {  // piece q into its stage; false when none is left
          if (pos == end) {
            while (r < r1 && moved(r)) ++r;
            if (r == r1) return false;
            int e = r;
            while (e < r1 && !moved(e)) ++e;
            pos = r * row_bytes;
            end = e * row_bytes;
            r = e;
          }
          const int k = q % kRing;
          off[k] = pos;
          len[k] = (unsigned)min((long long)kStageBytes, end - pos);
          pos += len[k];
          mbar_expect_tx(&rb[k], len[k]);
          bulk_load(ring + k * kStageBytes, ab + off[k], len[k], &rb[k]);
          return true;
        };
        int n = 0;  // pieces loaded
        while (n < kRing && load_next(n)) ++n;
        for (int q = 0; q < n; ++q) {
          const int k = q % kRing;
          mbar_wait(&rb[k], (unsigned)(q / kRing) & 1u);
          bulk_store(ob + off[k], ring + k * kStageBytes, len[k]);
          bulk_commit();
          if (q >= 1 && n == q - 1 + kRing) {  // refill the stage of piece q - 1
            bulk_wait_read<1>();
            if (load_next(n)) ++n;
          }
        }
      }
    } else {
      for (int r = r0 + warp; r < r1; r += kWarps) {
        if (moved(r)) continue;
        const E* s = a + (long long)r * F;
        E* d = o + (long long)r * F;
        for (long long i0 = lane; i0 < F; i0 += 32 * kBatch) {
          E v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const long long i = i0 + j * 32;
            if (i < F) v[j] = s[i];
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const long long i = i0 + j * 32;
            if (i < F) d[i] = v[j];
          }
        }
      }
    }
  }
  if constexpr (BULK || kBulkCopy) bulk_wait_read<0>();  // smem stays until the stores read it
}

template <typename E, bool BULK>
cudaError_t launch_typed(const KvMoveTable& t, const KvMovePlan& p, cudaStream_t stream) {
  const Layout l = layout(p.M, p.S, p.chunk * (int)sizeof(E),
                          kBulk && sizeof(E) == 16 && p.copy_through);
  auto kern = kv_move_leaves_kernel<E, BULK>;
  if (l.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)l.total);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)t.block0[t.L], kThreads, l.total, stream>>>(t, p);
  return cudaGetLastError();
}

}  // namespace

// leaves: L rows (arr, out, F, U) of int64, 1 <= L <= kMaxLeaves: arr and
// out [U, B, S, F] contiguous leaves (out == arr for the in-place move), F
// counted in elements of elem_bytes (1, 2, 4, 8 or 16; 16 needs 16-byte
// aligned bases); src/dst int32 [B, M]; mask bytes [B, M]; chunk_bytes:
// the columns of one block, a power of two and a multiple of elem_bytes;
// M*chunk_bytes bytes of shared memory stage the moved segments.
REPRO_EXPORT int kv_move_leaves_launch(const long long* leaves, int L, const void* src,
                                       const void* dst, const void* mask, int B, int S, int M,
                                       int elem_bytes, int chunk_bytes, int copy_through,
                                       void* stream) {
  if (L < 1 || L > kMaxLeaves || B < 1 || S < 1 || M < 1 || elem_bytes < 1 ||
      chunk_bytes < elem_bytes || chunk_bytes % elem_bytes != 0 ||
      (chunk_bytes & (chunk_bytes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  KvMoveTable t{};
  KvMovePlan p{static_cast<const int*>(src), static_cast<const int*>(dst),
               static_cast<const uint8_t*>(mask), B, S, M, chunk_bytes / elem_bytes, 0,
               copy_through ? 1 : 0};
  while ((1 << p.chunk_shift) < p.chunk) ++p.chunk_shift;
  long long blocks = 0;
  for (int i = 0; i < L; ++i) {
    const long long* row = leaves + 4 * i;
    if (row[0] == 0 || row[1] == 0 || row[2] < 0 || row[3] < 1 || row[3] > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const long long chunks = (row[2] + p.chunk - 1) / p.chunk;
    t.arr[i] = reinterpret_cast<const void*>(row[0]);
    t.out[i] = reinterpret_cast<void*>(row[1]);
    t.F[i] = row[2];
    t.U[i] = (int)row[3];
    t.chunks[i] = (int)chunks;
    t.block0[i] = (int)blocks;
    blocks += row[3] * B * chunks;
    if (chunks > 0x7fffffffLL || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  t.block0[L] = (int)blocks;
  t.L = L;
  if (blocks == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return (int)launch_typed<uint8_t, false>(t, p, st);
    case 2: return (int)launch_typed<uint16_t, false>(t, p, st);
    case 4: return (int)launch_typed<uint32_t, false>(t, p, st);
    case 8: return (int)launch_typed<uint64_t, false>(t, p, st);
    case 16:  // copying through, bulk moves let the ring start at once (no block barrier)
      return kBulk && (copy_through || chunk_bytes >= kBulkMoveBytes)
                 ? (int)launch_typed<uint4, true>(t, p, st)
                 : (int)launch_typed<uint4, false>(t, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

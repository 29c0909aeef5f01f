// KV-cache row moves for Hopper (sm_90a): out[u, b, dst[b, m]] = arr[u, b, src[b, m]]
// for every active move m, as a parallel assignment.
//
// Replaces the Pallas kernel kv_move_rows_pallas
// (src/repro/kernels/kv_moves.py:112, body _kv_move_kernel at :58), which
// verify compaction and the draft re-root run on every row leaf [U, B, S, F]
// of the caches.  A move is active when its mask is set and 0 <= src, dst < S;
// everything else is dropped.  copy_through = 0 moves in place (out == arr:
// the donating path); copy_through = 1 first copies the whole slab into a
// fresh out and never writes arr (the snapshot-preserving path).
//
// What bounds it: bytes — it is pure data movement, O(U*B*M*F) elements
// (plus one slab copy when copy_through).
//
// Design: the TPU kernel stages all M source rows of one (u, b) in VMEM,
// waits, then scatters.  Shared memory cannot hold a whole move at the
// slice's widths (M = 73 rows of F = 1024 f32 is 292 KB), so the grid is
// (F chunks, B, U): each block stages every active source row of its own F
// columns, __syncthreads(), then scatters them.  A block owns its columns for
// all rows, so all reads still precede all writes for each element and the
// assignment stays parallel when src and dst windows overlap.  Elements are
// moved as raw bytes of their width, so any dtype moves exactly; the wrapper
// passes rows as 16-byte elements whenever their width and alignment allow.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // loads in flight per thread

// a move is active when its mask is set and both rows lie in [0, S)
__device__ __forceinline__ bool active(const uint8_t* mb, const int* sb, const int* db, int m,
                                       int S) {
  const int s = sb[m], d = db[m];
  return mb[m] && s >= 0 && s < S && d >= 0 && d < S;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    kv_move_rows_kernel(const E* arr, E* out, const int* __restrict__ src,
                        const int* __restrict__ dst, const uint8_t* __restrict__ mask, int B,
                        int S, long long F, int M, int FC, int copy_through) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* stage = reinterpret_cast<E*>(smem_raw);  // [M][FC]
  const int b = blockIdx.y, u = blockIdx.z;
  const long long f0 = (long long)blockIdx.x * FC;
  const int fc = (int)min((long long)FC, F - f0);
  const long long slab = ((long long)u * B + b) * S * F + f0;
  const E* a = arr + slab;
  E* o = out + slab;
  const int* sb = src + (long long)b * M;
  const int* db = dst + (long long)b * M;
  const uint8_t* mb = mask + (long long)b * M;

  // the flattened (row, column) space in batches of kBatch elements per
  // thread: all loads of a batch are issued before the first is stored, so a
  // block keeps many independent reads in flight
  const int n = M * fc;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    E r[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads, m = i / fc;
      if (i < n && active(mb, sb, db, m, S)) r[j] = a[(long long)sb[m] * F + i % fc];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads, m = i / fc;
      if (i < n && active(mb, sb, db, m, S)) stage[(long long)m * FC + i % fc] = r[j];
    }
  }
  if (copy_through) {
    for (int i0 = threadIdx.x; i0 < S * fc; i0 += kThreads * kBatch) {
      E r[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < S * fc) r[j] = a[(long long)(i / fc) * F + i % fc];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < S * fc) o[(long long)(i / fc) * F + i % fc] = r[j];
      }
    }
  }
  __syncthreads();  // every source row of this block's columns is staged
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int m = i / fc;
    if (active(mb, sb, db, m, S)) o[(long long)db[m] * F + i % fc] = stage[(long long)m * FC + i % fc];
  }
}

template <typename E>
cudaError_t launch_typed(const void* arr, void* out, const int* src, const int* dst,
                         const uint8_t* mask, int U, int B, int S, long long F, int M, int FC,
                         int copy_through, cudaStream_t stream) {
  const size_t smem = (size_t)M * FC * sizeof(E);
  auto kern = kv_move_rows_kernel<E>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)((F + FC - 1) / FC), B, U);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const E*>(arr), static_cast<E*>(out), src,
                                         dst, mask, B, S, F, M, FC, copy_through);
  return cudaGetLastError();
}

}  // namespace

// arr/out [U, B, S, F] contiguous (out == arr for the in-place move);
// src/dst int32 [B, M]; mask bytes [B, M]; F counted in elements of
// elem_bytes (1, 2, 4, 8 or 16); FC columns per block, M*FC*elem_bytes bytes
// of shared memory.
REPRO_EXPORT int kv_move_rows_launch(const void* arr, void* out, const void* src, const void* dst,
                                     const void* mask, int U, int B, int S, long long F, int M,
                                     int elem_bytes, int FC, int copy_through, void* stream) {
  if (M <= 0 || FC <= 0 || U <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return (int)launch_typed<uint8_t>(arr, out, s, d, mk, U, B, S, F, M, FC, copy_through, st);
    case 2: return (int)launch_typed<uint16_t>(arr, out, s, d, mk, U, B, S, F, M, FC, copy_through, st);
    case 4: return (int)launch_typed<uint32_t>(arr, out, s, d, mk, U, B, S, F, M, FC, copy_through, st);
    case 8: return (int)launch_typed<uint64_t>(arr, out, s, d, mk, U, B, S, F, M, FC, copy_through, st);
    case 16: return (int)launch_typed<uint4>(arr, out, s, d, mk, U, B, S, F, M, FC, copy_through, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

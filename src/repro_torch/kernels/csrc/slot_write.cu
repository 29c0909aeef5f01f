// Slot lifecycle writes for Hopper (sm_90a): for every leaf i of a cache,
// out_i[u, slot] = donor_i[u, 0] (install), or 0 (zero: a null donor), in
// one launch for all leaves, in place.
//
// Replaces the Pallas kernel slot_write_rows_pallas
// (src/repro/kernels/kv_moves.py:182, body _slot_write_kernel at :164),
// which continuous batching runs when a request is admitted (its solo
// prefill cache installed into batch row ``slot`` of the serving caches) and
// when it retires (the row zeroed with an all-zeros donor).  Here zeroing
// passes no donor at all: the kernel writes zeros and reads nothing, so the
// zeroing bound is half the install bound.
//
// What bounds it: bytes — pure data movement, one read and one write of
// U*R elements per leaf (R = the elements of one [S, Hkv, hd] row).
//
// Design: row ``slot`` of layer u of a contiguous [U, B, ...] leaf is one
// contiguous run of R elements, so the work is sum_i U_i contiguous copies.
// The grid is (chunk of the row, layer u, leaf): each block copies one
// chunk of kThreads*kBatch elements, all loads of a thread issued before its
// first store.  The leaves travel in a pointer table passed by value as the
// kernel argument (at most kMaxLeaves), and elements move as raw bytes of
// the width the wrapper picks: 16 bytes whenever every row length and base
// pointer allows it, so any dtype is copied exactly.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // elements in flight per thread
constexpr int kMaxLeaves = 16;

struct SlotWriteTable {
  void* dst[kMaxLeaves];        // [U, B, R] cache leaf, written in place
  const void* src[kMaxLeaves];  // [U, 1, R] donor leaf, or null: write zeros
  long long row[kMaxLeaves];    // R, in elements of the kernel's width
  int U[kMaxLeaves];
  int B[kMaxLeaves];
};

template <typename E>
__global__ void __launch_bounds__(kThreads)
    slot_write_rows_kernel(const SlotWriteTable t, int slot) {
  const int leaf = blockIdx.z, u = blockIdx.y;
  if (u >= t.U[leaf]) return;
  const long long R = t.row[leaf];
  const long long c0 = (long long)blockIdx.x * (kThreads * kBatch);
  if (c0 >= R) return;
  E* o = static_cast<E*>(t.dst[leaf]) + ((long long)u * t.B[leaf] + slot) * R;
  const E* s = t.src[leaf] == nullptr ? nullptr : static_cast<const E*>(t.src[leaf]) + u * R;
  E r[kBatch];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const long long i = c0 + threadIdx.x + j * kThreads;
    r[j] = (s != nullptr && i < R) ? s[i] : E{};
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const long long i = c0 + threadIdx.x + j * kThreads;
    if (i < R) o[i] = r[j];
  }
}

template <typename E>
cudaError_t launch_typed(const SlotWriteTable& t, int L, int slot, cudaStream_t stream) {
  int max_u = 0;
  long long max_row = 0;
  for (int i = 0; i < L; ++i) {
    max_u = max(max_u, t.U[i]);
    max_row = max(max_row, t.row[i]);
  }
  const long long chunks = (max_row + kThreads * kBatch - 1) / (kThreads * kBatch);
  if (chunks == 0) return cudaSuccess;
  if (chunks > 0x7fffffffLL || max_u > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)max_u, (unsigned)L);
  slot_write_rows_kernel<E><<<grid, kThreads, 0, stream>>>(t, slot);
  return cudaGetLastError();
}

}  // namespace

// The most leaves one launch takes (the pointer table's size).
REPRO_EXPORT int slot_write_rows_max_leaves() { return kMaxLeaves; }

// dst[i]: [U[i], B[i], ...] contiguous cache leaves; src[i]: [U[i], 1, ...]
// contiguous donor leaves of the same row length, or null (write zeros);
// row[i]: elements of one row, counted in elem_bytes (1, 2, 4, 8 or 16);
// 0 <= slot < B[i] for every leaf; 1 <= L <= kMaxLeaves.
REPRO_EXPORT int slot_write_rows_launch(void* const* dst, const void* const* src,
                                        const long long* row, const int* U, const int* B, int L,
                                        int slot, int elem_bytes, void* stream) {
  if (L < 1 || L > kMaxLeaves) return (int)cudaErrorInvalidValue;
  SlotWriteTable t{};
  for (int i = 0; i < L; ++i) {
    if (dst[i] == nullptr || U[i] < 1 || B[i] < 1 || row[i] < 0 || slot < 0 || slot >= B[i])
      return (int)cudaErrorInvalidValue;
    t.dst[i] = dst[i];
    t.src[i] = src[i];
    t.row[i] = row[i];
    t.U[i] = U[i];
    t.B[i] = B[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: return (int)launch_typed<uint8_t>(t, L, slot, st);
    case 2: return (int)launch_typed<uint16_t>(t, L, slot, st);
    case 4: return (int)launch_typed<uint32_t>(t, L, slot, st);
    case 8: return (int)launch_typed<uint64_t>(t, L, slot, st);
    case 16: return (int)launch_typed<uint4>(t, L, slot, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

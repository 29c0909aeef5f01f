// Tree-masked GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel tree_attention_pallas
// (src/repro/kernels/tree_attention.py:82, body _kernel at :32): the paper's
// non-square masked attention, q [B, n, Hq, hd] against the whole cache
// k/v [B, S, Hkv, hd] under a bool mask [B, n, S], f32 softmax, scale
// 1/sqrt(hd), a fully masked query row returns exactly 0.  The kernel and
// its design are in attention.cuh, shared with decode_attention.cu.
#include "attention.cuh"

// q [B, n, Hq, hd], k/v [B, S, Hkv, hd], mask [B, n, S] (bytes), out like q;
// all contiguous and 16-byte aligned.  Keys >= kv_end attend for no row
// (the caller's bound; S without one); the splits of split_keys keys below
// it are launched, n_launch of them.  part_acc/part_ml/counters sized by the
// caller from attention_rows_per_block and n_launch (unused, and may be
// null, when n_launch is 1; counters zeroed once, the kernel leaves them zero).
REPRO_EXPORT int tree_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, void* part_acc,
                                       void* part_ml, void* counters, int B, int n, int Hq,
                                       int Hkv, int hd, int S, int split_keys, int n_launch,
                                       int kv_end, float scale, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const uint8_t*>(mask);
  a.kv_end = kv_end;
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
  a.n_launch = n_launch;
  a.scale = scale;
  return (int)attention_launch<false>(a, dtype, static_cast<cudaStream_t>(stream));
}

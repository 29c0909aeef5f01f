// Split-KV decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel decode_attention_pallas
// (src/repro/kernels/decode_attention.py:76, body _kernel at :28): one query
// position per batch row, q [B, Hq, hd] against k/v [B, S, Hkv, hd], keys
// s < length[b] attend, f32 softmax, scale 1/sqrt(hd), length 0 gives
// exactly 0.  The Pallas kernel walks the KV splits as its minor grid axis
// and combines them in VMEM; here the splits are thread blocks combined in
// a fixed order by the last to finish (attention.cuh).  The docstring of
// the Pallas file speaks of fused RoPE, but its kernel applies none, and
// neither does this one: q and k arrive rotated.
//
// It is the length variant of the kernel in attention.cuh: no mask tensor
// is read, the key loop of each split ends at the length (the K/V rows past
// it are never loaded, and a host-int length launches only the splits
// below it), and a row rounds exactly as tree_attention's at n = 1 under
// the mask cols < length.
#include "attention.cuh"

// q [B, Hq, hd], k/v [B, S, Hkv, hd], out like q; all contiguous and
// 16-byte aligned.  length: int32 [B] on the device (kv_end = S), or null
// with the host length in kv_end for every row.  split_keys, n_launch,
// part_acc/part_ml/counters as for tree_attention_launch with n = 1.
REPRO_EXPORT int decode_attention_launch(const void* q, const void* k, const void* v,
                                         const void* length, void* out, void* part_acc,
                                         void* part_ml, void* counters, int B, int Hq, int Hkv,
                                         int hd, int S, int split_keys, int n_launch, int kv_end,
                                         float scale, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.length = static_cast<const int*>(length);
  a.kv_end = kv_end;
  a.out = out;
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.counters = static_cast<int*>(counters);
  a.B = B;
  a.n = 1;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.S = S;
  a.split_keys = split_keys;
  a.n_launch = n_launch;
  a.scale = scale;
  return (int)attention_launch<true>(a, dtype, static_cast<cudaStream_t>(stream));
}

// Contiguous single-query decode attention (B8's decode route in the port's
// kernel table).
//
// Replaces, for one query token (T == 1), the JAX package's Pallas TPU
// kernel `flash_attention_fwd` (src/repro/kernels/flash_attn/kernel.py:276,
// body `_kernel` :26): q (B, 1, H, Dh) over the first `len` keys of k
// (B, S, KV, Dh) and v (B, S, KV, Dv), which may be the written prefix of a
// longer arena (key j of row b at arena row b * s_stride + j), query head h
// reading kv head h / (H / KV), out (B, 1, H, Dv) in q's type, bf16 or
// float32 (the f32 parity of the static engine runs it too). The static
// engine's dense decode calls it every step over the written prefix.
//
// Bound by the bytes of the live keys and values; the design (one warp per
// run of keys, register-resident softmax and accumulator, splits merged by
// the last block) is single_query.cuh's, with the dense loader.
#include "single_query.cuh"

extern "C" int flash_decode_launch(int is_bf16, const void* q, const void* k, const void* v,
                                   void* out, void* part, void* counters, int B, int H,
                                   int KV, int Dh, int Dv, long q_sb, int s_stride, int len,
                                   int splits, int split_keys, float scale, void* stream) {
  using namespace single_query;
  if (KV < 1 || H % KV != 0 || reinterpret_cast<uintptr_t>(k) % 16 ||
      reinterpret_cast<uintptr_t>(v) % 16)
    return cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.KV = KV;
  p.G = H / KV;
  p.Dh = Dh;
  p.Dv = Dv;
  p.len = len;
  p.s_stride = s_stride;
  p.splits = splits;
  p.split_keys = split_keys;
  p.q_sb = q_sb;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (is_bf16) {
    DenseKV<__nv_bfloat16> kvl{static_cast<const __nv_bfloat16*>(k),
                               static_cast<const __nv_bfloat16*>(v)};
    return launch<DenseKV<__nv_bfloat16>, __nv_bfloat16, 8>(p, kvl, stream);
  }
  DenseKV<float> kvl{static_cast<const float*>(k), static_cast<const float*>(v)};
  return launch<DenseKV<float>, float, 8>(p, kvl, stream);
}

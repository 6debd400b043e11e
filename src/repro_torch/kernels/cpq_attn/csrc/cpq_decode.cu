// Contiguous T2 decode attention over int8 CPQ codes (B10 of the port's
// kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `cpq_decode_fwd`
// (src/repro/kernels/cpq_dequant_attn/kernel.py:338, body `_kernel` :41).
// One query token per row attends the row's first `length` tokens of
// contiguous code arenas: q (B, KV, G, Dh) float32, codes (B, N, KV,
// Dh|Dv) int8, levels (B, N, KV) int32, tables (B, L, KV, Dh|Dv) float32 and
// one host length for every row -> out (B, KV, G, Dv) float32. A stored -128
// (pruned) dequantizes to exactly 0, any other code to (c - 1) * scale +
// zero of its level, and a level outside [0, L) reads scale = zero = 0, as
// the TPU kernel's one-hot lookup does; a length of 0 gives zeros.
//
// `round_tiles` selects the compile-time switch kRound: off, the dequantized
// values stay float32 (the TPU kernel's function and that of
// cpq_decode_ref); on, they are rounded to bf16 and back, the function of
// cpq_chunked_decode_attention, the contiguous T2 decode the static engine
// serves.
//
// Bound by the bytes of the live codes and levels (one byte per K/V
// element, a level word per token). The design is the single-query decode
// of ../../flash_attn/csrc/single_query.cuh with the code loader: a lane
// loads 16 codes at once and each token's level once, the row's tables are
// copied into shared memory once per block (a block covers a split of
// hundreds of keys, not 64), every code is dequantized in registers by one
// fused multiply-add, and no float tile ever goes to shared memory; the
// last block of a (row, kv head) merges the splits.
#include "../../flash_attn/csrc/single_query.cuh"

extern "C" int cpq_decode_launch(int round_tiles, const void* q, const void* codes_k,
                                 const void* codes_v, const void* level_k,
                                 const void* level_v, const void* scale_k,
                                 const void* zero_k, const void* scale_v,
                                 const void* zero_v, void* out, void* part, void* counters,
                                 int B, int KV, int G, int Dh, int Dv, int N, int L,
                                 int length, int splits, int split_keys, float scale,
                                 void* stream) {
  using namespace single_query;
  if (KV < 1 || G < 1 || N < 1 || L < 1 || length < 0 || length > N ||
      reinterpret_cast<uintptr_t>(codes_k) % 16 || reinterpret_cast<uintptr_t>(codes_v) % 16)
    return cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.Dh = Dh;
  p.Dv = Dv;
  p.len = length;
  p.s_stride = N;
  p.splits = splits;
  p.split_keys = split_keys;
  p.q_sb = (long)KV * G * Dh;
  p.scale_log2 = scale * 1.4426950408889634f;
  const auto fill = [&](auto& kvl) {
    kvl.ck = static_cast<const int8_t*>(codes_k);
    kvl.cv = static_cast<const int8_t*>(codes_v);
    kvl.lk = static_cast<const int*>(level_k);
    kvl.lv = static_cast<const int*>(level_v);
    kvl.sk = static_cast<const float*>(scale_k);
    kvl.zk = static_cast<const float*>(zero_k);
    kvl.sv = static_cast<const float*>(scale_v);
    kvl.zv = static_cast<const float*>(zero_v);
    kvl.L = L;
  };
  if (round_tiles) {
    CodeKV<true> kvl{};
    fill(kvl);
    return launch<CodeKV<true>, float, 4>(p, kvl, stream);
  }
  CodeKV<false> kvl{};
  fill(kvl);
  return launch<CodeKV<false>, float, 4>(p, kvl, stream);
}

// Contiguous T2 decode attention over int8 CPQ codes (B10 of the port's
// kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `cpq_decode_fwd`
// (src/repro/kernels/cpq_dequant_attn/kernel.py:338, body `_kernel` :41).
// One query token per row attends the row's first `length` tokens of
// contiguous code arenas, dequantizing each tile in shared memory with the
// row's own scale/zero tables: q (B, KV, G, Dh) float32, codes (B, N, KV,
// Dh|Dv) int8, levels (B, N, KV) int32, tables (B, L, KV, Dh|Dv) float32 and
// one host length for every row -> out (B, KV, G, Dv) float32. A stored -128
// (pruned) dequantizes to exactly 0, any other code to (c - 1) * scale +
// zero of its level, and a level outside [0, L) reads scale = zero = 0, as
// the TPU kernel's one-hot lookup does.
//
// `round_tiles` selects the compile-time switch kRound of cpq_attn.cuh: off,
// the dequantized tiles stay float32 (the TPU kernel's function and that of
// cpq_decode_ref); on, they are rounded to bf16 and back, the function of
// cpq_chunked_decode_attention, the contiguous T2 decode the static engine
// serves. It runs the paged kernel B5's sweep (cpq_attn.cuh) with no block
// table (token t of row b at arena row b * N + t): splits of 64 keys, one
// block per (split, kv head, row), and a merge pass. Bound by device-memory
// traffic: the live codes and levels, one read each.
#include "cpq_attn.cuh"

extern "C" int cpq_decode_launch(int round_tiles, const void* q, const void* codes_k,
                                 const void* codes_v, const void* level_k,
                                 const void* level_v, const void* scale_k,
                                 const void* zero_k, const void* scale_v,
                                 const void* zero_v, void* out, void* part, int B, int KV,
                                 int G, int Dh, int Dv, int N, int L, int length,
                                 int split_tokens, float scale, void* stream) {
  if (KV < 1 || G < 1 || N < 1 || length < 0 || length > N || split_tokens < 1)
    return cudaErrorInvalidValue;
  cpq_attn::Params c{};
  paged_attn::Params& p = c.p;
  p.q = q;
  p.out = out;
  p.block_table = nullptr;  // contiguous: token t of row b at arena row b * N + t
  p.lengths = nullptr;
  p.len_host = length;
  p.part = static_cast<float*>(part);
  p.causal_offset = -1;
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.R = G;
  p.Dh = Dh;
  p.Dv = Dv;
  p.page = 1;
  p.nb = N;
  p.pages_per_split = split_tokens;
  p.q_sb = (long)KV * G * Dh;
  p.o_sb = (long)KV * G * Dv;
  p.scale = scale;
  c.ck = static_cast<const int8_t*>(codes_k);
  c.cv = static_cast<const int8_t*>(codes_v);
  c.lk = static_cast<const int*>(level_k);
  c.lv = static_cast<const int*>(level_v);
  c.sk = static_cast<const float*>(scale_k);
  c.zk = static_cast<const float*>(zero_k);
  c.sv = static_cast<const float*>(scale_v);
  c.zv = static_cast<const float*>(zero_v);
  c.tables_per_row = 1;
  c.L = L;
  c.page_splits = (N + split_tokens - 1) / split_tokens;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return round_tiles ? cpq_attn::launch<float, true>(c, s)
                     : cpq_attn::launch<float, false>(c, s);
}

// Paged T2 decode attention over int8 CPQ code pages (B5 of the port's
// kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_cpq_decode_fwd`
// (src/repro/kernels/cpq_dequant_attn/kernel.py:281, body `_paged_kernel`
// :85). One query token per request row attends that row's live code pages
// through the block table, dequantizing each tile in shared memory with the
// row's own scale/zero tables: q (B, 1, H, Dh), codes (P, page, KV, Dh|Dv)
// int8, levels (P, page, KV) int32, tables (B, L, KV, Dh|Dv) float32,
// block_table (B, nb) int32, lengths (B,) int32 -> out (B, 1, H, Dv) in q's
// dtype. Positions at or past lengths[b] contribute nothing; a row of
// length 0 returns zeros. Bound by device-memory traffic: the live codes
// and levels (see cpq_attn.cuh for the design).
#include "cpq_attn.cuh"

extern "C" int paged_cpq_decode_launch(
    int is_bf16, const void* q, const void* codes_k, const void* codes_v,
    const void* level_k, const void* level_v, const void* scale_k, const void* zero_k,
    const void* scale_v, const void* zero_v, const void* block_table,
    const void* lengths, void* out, void* part, int B, int H, int KV, int Dh, int Dv,
    int page, int nb, int L, int pages_per_split, float scale, void* stream) {
  if (KV < 1 || H % KV != 0) return cudaErrorInvalidValue;
  cpq_attn::Params c{};
  paged_attn::Params& p = c.p;
  p.q = q;
  p.out = out;
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.part = static_cast<float*>(part);
  p.causal_offset = -1;
  p.B = B;
  p.KV = KV;
  p.G = H / KV;
  p.R = p.G;
  p.Dh = Dh;
  p.Dv = Dv;
  p.page = page;
  p.nb = nb;
  p.pages_per_split = pages_per_split;
  p.q_sb = (long)H * Dh;
  p.o_sb = (long)H * Dv;
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
  c.page_splits = pages_per_split > 0 ? (nb + pages_per_split - 1) / pages_per_split : 0;
  return cpq_attn::dispatch(is_bf16, c, stream);
}

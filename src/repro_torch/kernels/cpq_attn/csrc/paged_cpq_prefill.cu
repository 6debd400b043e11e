// Chunked paged T2 prefill attention for one request slot (B6 of the port's
// kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_cpq_prefill_fwd`
// (src/repro/kernels/cpq_dequant_attn/kernel.py:213, body
// `_paged_prefill_kernel` :142). The C queries of one admission chunk attend
// (1) the slot's earlier code pages, positions < offset, dequantized in
// shared memory with the slot's scale/zero tables (what decode will read),
// then (2) the chunk's own raw K/V, col < valid and col <= the query's chunk
// token, unrounded. q (1, C, H, Dh); codes, levels as the decode kernel;
// tables (L, KV, Dh|Dv) of the slot; k_raw/v_raw (C, KV, Dh|Dv) in q's
// dtype; block_row (nb,) int32 -> out (1, C, H, Dv). Per kv head the rows
// are token-major, R = C * G. For a first chunk (offset 0) no page is live
// and only the raw tail counts. `offset`, `valid` and the number of page
// splits are host integers. Bound by device-memory traffic: the slot's live
// codes and levels and the chunk's raw K/V (see cpq_attn.cuh).
#include "cpq_attn.cuh"

extern "C" int paged_cpq_prefill_launch(
    int is_bf16, const void* q, const void* codes_k, const void* codes_v,
    const void* level_k, const void* level_v, const void* scale_k, const void* zero_k,
    const void* scale_v, const void* zero_v, const void* k_raw, const void* v_raw,
    const void* block_row, void* out, void* part, int C, int H, int KV, int Dh, int Dv,
    int page, int nb, int L, int pages_per_split, int page_splits, int offset,
    int valid, float scale, void* stream) {
  if (KV < 1 || H % KV != 0 || offset < 0 || valid < 1 || valid > C || page_splits < 0)
    return cudaErrorInvalidValue;
  cpq_attn::Params c{};
  paged_attn::Params& p = c.p;
  p.q = q;
  p.out = out;
  p.block_table = static_cast<const int*>(block_row);
  p.lengths = nullptr;
  p.len_host = offset;  // code pages serve the positions before the chunk
  p.part = static_cast<float*>(part);
  p.causal_offset = -1;
  p.B = 1;
  p.KV = KV;
  p.G = H / KV;
  p.R = C * p.G;
  p.Dh = Dh;
  p.Dv = Dv;
  p.page = page;
  p.nb = nb;
  p.pages_per_split = pages_per_split;
  p.q_stok = (long)H * Dh;
  p.o_stok = (long)H * Dv;
  p.scale = scale;
  c.ck = static_cast<const int8_t*>(codes_k);
  c.cv = static_cast<const int8_t*>(codes_v);
  c.lk = static_cast<const int*>(level_k);
  c.lv = static_cast<const int*>(level_v);
  c.sk = static_cast<const float*>(scale_k);
  c.zk = static_cast<const float*>(zero_k);
  c.sv = static_cast<const float*>(scale_v);
  c.zv = static_cast<const float*>(zero_v);
  c.tables_per_row = 0;
  c.L = L;
  c.page_splits = page_splits;
  c.k_raw = k_raw;
  c.v_raw = v_raw;
  c.C = C;
  c.valid = valid;
  return cpq_attn::dispatch(is_bf16, c, stream);
}

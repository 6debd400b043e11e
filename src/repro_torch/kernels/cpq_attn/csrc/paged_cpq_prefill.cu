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
//
// Two routes, chosen by the wrapper (cpq_attn/ops.py) from dtype, widths and
// levels: paged_cpq_prefill_launch, the CUDA-core sweep of cpq_attn.cuh
// (float32, and what the other route does not take), and
// paged_cpq_prefill_mma_launch, the tensor-core route of
// ../../paged_attn/csrc/paged_chunk.cuh (bf16, Dh and Dv multiples of 8 up
// to 256, tables of up to 16 levels).
#include "cpq_attn.cuh"
#include "../../paged_attn/csrc/paged_chunk.cuh"

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

// The tensor-core route: q, k_raw, v_raw, out bf16 (k_raw, v_raw (C, KV,
// Dh|Dv)); tables (L, KV, Dh|Dv) of the slot; part holds KV * 16 *
// ceil(C * G / 16) * splits * (Dv + 2) floats; counters as
// paged_chunk::launch says.
extern "C" int paged_cpq_prefill_mma_launch(
    const void* q, const void* codes_k, const void* codes_v, const void* level_k,
    const void* level_v, const void* scale_k, const void* zero_k, const void* scale_v,
    const void* zero_v, const void* k_raw, const void* v_raw, const void* block_row,
    void* out, void* part, void* counters, int C, int H, int KV, int Dh, int Dv, int page,
    int nb, int L, int offset, int valid, int splits, int split_keys, float scale,
    void* stream) {
  if (page < 1 || nb < 1 || L < 1 || L > 16 || valid < 1 || offset < 0 ||
      offset > nb * page || !paged_chunk::aligned16(codes_k) ||
      !paged_chunk::aligned16(codes_v) || !paged_chunk::aligned16(k_raw) ||
      !paged_chunk::aligned16(v_raw))
    return cudaErrorInvalidValue;
  paged_chunk::Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.H = H;
  p.KV = KV;
  p.Dh = Dh;
  p.Dv = Dv;
  p.offset = offset;
  p.end = offset + valid;
  p.splits = splits;
  p.split_keys = split_keys;
  paged_chunk::CodeKV kvl{};
  kvl.ck = static_cast<const int8_t*>(codes_k);
  kvl.cv = static_cast<const int8_t*>(codes_v);
  kvl.lk = static_cast<const int*>(level_k);
  kvl.lv = static_cast<const int*>(level_v);
  kvl.sk = static_cast<const float*>(scale_k);
  kvl.zk = static_cast<const float*>(zero_k);
  kvl.sv = static_cast<const float*>(scale_v);
  kvl.zv = static_cast<const float*>(zero_v);
  kvl.k_raw = static_cast<const __nv_bfloat16*>(k_raw);
  kvl.v_raw = static_cast<const __nv_bfloat16*>(v_raw);
  kvl.block_row = static_cast<const int*>(block_row);
  kvl.page = page;
  kvl.L = L;
  return paged_chunk::launch(p, kvl, C, scale, stream);
}

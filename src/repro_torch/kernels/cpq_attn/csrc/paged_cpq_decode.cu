// Paged T2 decode attention over int8 CPQ code pages (B5 of the port's
// kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_cpq_decode_fwd`
// (src/repro/kernels/cpq_dequant_attn/kernel.py:281, body `_paged_kernel`
// :85). One query token per request row attends that row's live code pages
// through the block table, dequantized with the row's own scale/zero
// tables and rounded to bf16 as the TPU kernel rounds its tiles: q
// (B, 1, H, Dh), codes (P, page, KV, Dh|Dv) int8, levels (P, page, KV)
// int32, tables (B, L, KV, Dh|Dv) float32, block_table (B, nb) int32,
// lengths (B,) int32 -> out (B, 1, H, Dv) in q's dtype. Positions at or
// past lengths[b] contribute nothing; a row of length 0 returns zeros; a
// stored -128 is exactly 0 and a level outside [0, L) reads 0 without a
// read out of bounds (the tiered engine's CPQ arm sweeps the null page for
// the dense tier's rows).
//
// Bound by device-memory traffic: the live codes and levels, and each row's
// tables. Two routes, picked by the wrapper before the launch (ops.py,
// cpq_decode_route):
//
//   * single_query (Dh and Dv multiples of 16 up to 256, bf16 or float32 q;
//     paged_cpq_decode_sq_launch): the single-query decode of
//     ../../flash_attn/csrc/single_query.cuh with the code loader
//     (CodeKV<true>: 16-byte code loads with several batches in flight,
//     dequantization in registers against tables in swizzled shared
//     memory) and the paged addressing (PagedRows: the splits planned from
//     the capacity, the block-table entries of a split in shared memory,
//     the live splits merged by the last block to arrive);
//   * sweep (other widths; paged_cpq_decode_launch): cpq_attn.cuh's
//     split-and-merge sweep, which dequantizes each tile into shared memory.
#include "../../flash_attn/csrc/single_query.cuh"
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

// The single_query route: part holds B * H * splits * (Dv + 2) floats and the
// counters B * KV * ceil(H / KV / 4) zeros; splits x split_keys cover nb * page.
extern "C" int paged_cpq_decode_sq_launch(
    int is_bf16, const void* q, const void* codes_k, const void* codes_v,
    const void* level_k, const void* level_v, const void* scale_k, const void* zero_k,
    const void* scale_v, const void* zero_v, const void* block_table,
    const void* lengths, void* out, void* part, void* counters, int B, int H, int KV,
    int Dh, int Dv, int page, int nb, int L, int splits, int split_keys, float scale,
    void* stream) {
  using namespace single_query;
  if (KV < 1 || H % KV != 0 || L < 1 || reinterpret_cast<uintptr_t>(codes_k) % 16 ||
      reinterpret_cast<uintptr_t>(codes_v) % 16)
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
  p.len = nb * page;
  p.s_stride = nb * page;
  p.splits = splits;
  p.split_keys = split_keys;
  p.q_sb = (long)H * Dh;
  p.scale_log2 = scale * 1.4426950408889634f;
  CodeKV<true> kvl{};
  kvl.ck = static_cast<const int8_t*>(codes_k);
  kvl.cv = static_cast<const int8_t*>(codes_v);
  kvl.lk = static_cast<const int*>(level_k);
  kvl.lv = static_cast<const int*>(level_v);
  kvl.sk = static_cast<const float*>(scale_k);
  kvl.zk = static_cast<const float*>(zero_k);
  kvl.sv = static_cast<const float*>(scale_v);
  kvl.zv = static_cast<const float*>(zero_v);
  kvl.L = L;
  const PagedRows rows{static_cast<const int*>(block_table), static_cast<const int*>(lengths),
                       page, nb};
  if (is_bf16) return launch<CodeKV<true>, __nv_bfloat16, 4>(p, kvl, stream, rows);
  return launch<CodeKV<true>, float, 4>(p, kvl, stream, rows);
}

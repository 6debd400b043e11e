// Paged single-token decode attention (B1 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_flash_decode_fwd`
// (src/repro/kernels/flash_attn/kernel.py:223, body `_paged_decode_kernel`).
// One query token per request row attends that row's live pages through the
// block table: q (B, 1, H, Dh), arenas (P, page, KV, Dh|Dv), block_table
// (B, nb) int32, lengths (B,) int32 -> out (B, 1, H, Dv) in q's dtype. The
// G = H / KV query heads of a kv head are the R = G rows of one unit of
// work. Bound by device-memory traffic: the bytes of the live K/V pages
// (see paged_attn.cuh for the design).
#include "paged_attn.cuh"

extern "C" int paged_decode_launch(int is_bf16, const void* q, const void* k,
                                   const void* v, const void* block_table,
                                   const void* lengths, void* out, void* part,
                                   int B, int H, int KV, int Dh, int Dv, int page,
                                   int nb, int pages_per_split, float scale,
                                   void* stream) {
  if (KV < 1 || H % KV != 0) return cudaErrorInvalidValue;
  paged_attn::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
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
  return paged_attn::dispatch(is_bf16, p, stream);
}

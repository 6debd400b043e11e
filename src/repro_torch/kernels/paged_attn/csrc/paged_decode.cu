// Paged single-token decode attention (B1 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_flash_decode_fwd`
// (src/repro/kernels/flash_attn/kernel.py:223, body `_paged_decode_kernel`).
// One query token per request row attends that row's live pages through the
// block table: q (B, 1, H, Dh), arenas (P, page, KV, Dh|Dv), block_table
// (B, nb) int32, lengths (B,) int32 -> out (B, 1, H, Dv) in q's dtype. The
// G = H / KV query heads of a kv head are the R = G rows of one unit of
// work. Two routes, picked by the wrapper (../ops.py decode_route): "ring"
// (Dh and Dv multiples of 16 up to 256, bf16 or float32: one launch over a
// ring of asynchronous copies, paged_token.cuh) and "sweep" (other widths:
// the split sweep and its merge pass, paged_attn.cuh).
#include "paged_attn.cuh"
#include "paged_token.cuh"

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

// The ring route: one block per (row, kv head, head group) and cluster rank;
// cs ranks (1, 2, 4 or 8) split a unit's keys and merge through distributed
// shared memory. No scratch buffer, no counters.
extern "C" int paged_decode_ring_launch(int is_bf16, const void* q, const void* k,
                                        const void* v, const void* block_table,
                                        const void* lengths, void* out, int B, int H,
                                        int KV, int Dh, int Dv, int page, int nb, int cs,
                                        float scale, void* stream) {
  if (KV < 1 || H % KV != 0) return cudaErrorInvalidValue;
  paged_token::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.B = B;
  p.KV = KV;
  p.G = H / KV;
  p.Dh = Dh;
  p.Dv = Dv;
  p.page = page;
  p.nb = nb;
  p.cs = cs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? paged_token::launch<__nv_bfloat16>(p, scale, s)
                 : paged_token::launch<float>(p, scale, s);
}

// Paged T1 decomposed decode attention (B3 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_decomposed_decode_fwd`
// (src/repro/kernels/decomposed_attn/kernel.py:244, body `_paged_kernel`
// :73). One query token per request row attends that row's live X pages
// through the block table: r (B, H, Dm) = q_nope W_K^T, q_rope (B, H, Rr),
// x_pages (P, page, Dm), kr_pages (P, page, kv_r, Rr) with kv_r == 1 (a
// shared roped key, MLA) or per kv head, block_table (B, nb) int32,
// lengths (B,) int32 -> P (B, H, Dm) in the arena dtype; the caller applies
// W_V. One block reads each X page once for the 16 heads it holds. Bound by
// device-memory traffic: the live X and roped-key bytes (see
// paged_decomposed.cuh for the design).
#include "paged_decomposed.cuh"

extern "C" int paged_decomposed_decode_launch(
    int is_bf16, const void* r, const void* q_rope, const void* x_pages,
    const void* kr_pages, const void* block_table, const void* lengths, void* out,
    void* part, int B, int H, int kv_r, int Rr, int Dm, int page, int nb,
    int pages_per_split, float scale, void* stream) {
  decomposed_attn::Params p{};
  p.r = r;
  p.qr = q_rope;
  p.x = x_pages;
  p.kr = kr_pages;
  p.out = out;
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.part = static_cast<float*>(part);
  p.prefill = 0;
  p.B = B;
  p.C = 1;
  p.H = H;
  p.kv_r = kv_r;
  p.Rr = Rr;
  p.Dm = Dm;
  p.page = page;
  p.nb = nb;
  p.pages_per_split = pages_per_split;
  p.scale = scale;
  if (B < 1) return cudaErrorInvalidValue;
  return decomposed_attn::dispatch(is_bf16, p, stream);
}

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
//
// Two routes, picked by the wrapper before the launch (t1_decode_route in
// ../ops.py): bf16 calls of the widths t1_token.cuh takes run on the tensor
// cores (paged_decomposed_decode_mma_launch); float32 calls and other widths
// run the CUDA-core sweep of paged_decomposed.cuh
// (paged_decomposed_decode_launch), described above.
#include "paged_decomposed.cuh"
#include "t1_token.cuh"

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

// The tensor-core route: r, q_rope, x_pages, kr_pages, out bf16; part and
// counters and the splits as t1_token::launch says (splits planned from the
// capacity nb * page).
extern "C" int paged_decomposed_decode_mma_launch(
    const void* r, const void* q_rope, const void* x_pages, const void* kr_pages,
    const void* block_table, const void* lengths, void* out, void* part, void* counters,
    int B, int H, int kv_r, int Rr, int Dm, int page, int nb, int splits, int split_keys,
    float scale, void* stream) {
  using t1_token::bf16;
  if (page < 1 || nb < 1) return cudaErrorInvalidValue;
  t1_token::Params p{};
  p.r = static_cast<const bf16*>(r);
  p.qr = static_cast<const bf16*>(q_rope);
  p.x = static_cast<const bf16*>(x_pages);
  p.kr = static_cast<const bf16*>(kr_pages);
  p.out = static_cast<bf16*>(out);
  p.part = static_cast<float*>(part);
  p.counters = static_cast<int*>(counters);
  p.B = B;
  p.H = H;
  p.kv_r = kv_r;
  p.Rr = Rr;
  p.Dm = Dm;
  p.splits = splits;
  p.split_keys = split_keys;
  t1_token::PagedRows rows{static_cast<const int*>(block_table),
                           static_cast<const int*>(lengths), page, nb};
  return t1_token::launch(p, rows, nb * page, scale, static_cast<cudaStream_t>(stream));
}

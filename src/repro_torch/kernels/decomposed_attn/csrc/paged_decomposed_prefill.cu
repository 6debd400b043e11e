// Chunked paged T1 decomposed prefill attention for one request slot (B4 of
// the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_decomposed_prefill_fwd`
// (src/repro/kernels/decomposed_attn/kernel.py:187, body
// `_paged_prefill_kernel` :129). The C queries of one admission chunk, whose
// own X rows and roped keys were just written into the slot's pages, attend
// the pages [0, offset + valid): r (C, H, Dm), q_rope (C, H, Rr), x_pages
// (P, page, Dm), kr_pages (P, page, kv_r, Rr), block_row (nb,) int32 -> P
// (C, H, Dm). The H * C query rows are taken head-major (h * C + i) as the
// TPU kernel takes them, 16 to a block; row (h, i) sees position pos iff
// pos < offset + valid and pos <= offset + i. Rows past `valid` are padding
// whose output is never read. `offset` and `valid` are host integers.
//
// The TPU kernel keeps all H * C rows' (H * C, Dm) float32 accumulator in
// VMEM (1 MiB at qwen1.5-0.5b's widths). No block holds that on Hopper, so
// the rows are cut into blocks of 16, each sweeping the slot's X pages of
// its key split again (from L2 after the first block). Bound by the slot's
// live X and roped-key bytes; near the bf16 tensor-core ridge in flops
// (see paged_decomposed.cuh for the design).
//
// Two routes, picked by the wrapper before the launch (t1_prefill_route in
// ../ops.py): bf16 chunks of the widths paged_decomposed_chunk.cuh takes run
// on the tensor cores (paged_decomposed_prefill_mma_launch); float32 chunks
// and other widths run the CUDA-core sweep of paged_decomposed.cuh
// (paged_decomposed_prefill_launch), described above.
#include "paged_decomposed.cuh"
#include "paged_decomposed_chunk.cuh"

extern "C" int paged_decomposed_prefill_launch(
    int is_bf16, const void* r, const void* q_rope, const void* x_pages,
    const void* kr_pages, const void* block_row, void* out, void* part, int C,
    int H, int kv_r, int Rr, int Dm, int page, int nb, int pages_per_split,
    int offset, int valid, float scale, void* stream) {
  if (C < 1 || offset < 0 || valid < 1 || valid > C) return cudaErrorInvalidValue;
  decomposed_attn::Params p{};
  p.r = r;
  p.qr = q_rope;
  p.x = x_pages;
  p.kr = kr_pages;
  p.out = out;
  p.block_table = static_cast<const int*>(block_row);
  p.lengths = nullptr;
  p.part = static_cast<float*>(part);
  p.prefill = 1;
  p.B = 1;
  p.C = C;
  p.H = H;
  p.kv_r = kv_r;
  p.Rr = Rr;
  p.Dm = Dm;
  p.page = page;
  p.nb = nb;
  p.offset = offset;
  p.valid = valid;
  p.pages_per_split = pages_per_split;
  p.scale = scale;
  return decomposed_attn::dispatch(is_bf16, p, stream);
}

// The tensor-core route: r, q_rope, x_pages, kr_pages, out bf16; splits and
// split_keys as decomposed_chunk::launch says.
extern "C" int paged_decomposed_prefill_mma_launch(
    const void* r, const void* q_rope, const void* x_pages, const void* kr_pages,
    const void* block_row, void* out, int C, int H, int kv_r, int Rr, int Dm, int page,
    int nb, int offset, int valid, int splits, int split_keys, float scale, void* stream) {
  if (valid < 1 || valid > C) return cudaErrorInvalidValue;
  using decomposed_chunk::bf16;
  decomposed_chunk::Params p{};
  p.r = static_cast<const bf16*>(r);
  p.qr = static_cast<const bf16*>(q_rope);
  p.x = static_cast<const bf16*>(x_pages);
  p.kr = static_cast<const bf16*>(kr_pages);
  p.block_row = static_cast<const int*>(block_row);
  p.out = static_cast<bf16*>(out);
  p.C = C;
  p.H = H;
  p.kv_r = kv_r;
  p.Rr = Rr;
  p.Dm = Dm;
  p.page = page;
  p.offset = offset;
  p.end = offset + valid;
  p.splits = splits;
  p.split_keys = split_keys;
  return decomposed_chunk::launch(p, nb, scale, stream);
}

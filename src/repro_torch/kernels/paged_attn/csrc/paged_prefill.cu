// Chunked paged prefill attention for one request slot (B2 of the port's
// kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `paged_flash_prefill_fwd`
// (src/repro/kernels/flash_attn/kernel.py:170, body `_paged_prefill_kernel`).
// The C queries of one admission chunk, whose own K/V were just written into
// the slot's pages, attend the pages [0, offset + valid): q (1, C, H, Dh),
// arenas (P, page, KV, Dh|Dv), block_row (nb,) int32 -> out (1, C, H, Dv).
// Per kv head the rows are token-major, R = C * G, and row r may see
// position pos iff pos < offset + valid and pos <= offset + r / G. Rows past
// `valid` are padding whose output is never read. `offset` and `valid` are
// host integers, so the launch needs no device-to-host copy. Bound by
// device-memory traffic: the bytes of the slot's live K/V pages (see
// paged_attn.cuh for the design).
//
// Two routes, chosen by the wrapper (paged_attn/ops.py) from dtype and
// widths: paged_prefill_launch, the CUDA-core sweep of paged_attn.cuh (float32,
// and bf16 widths the other route does not take), and
// paged_prefill_mma_launch, the tensor-core route of paged_chunk.cuh (bf16,
// Dh and Dv multiples of 8 up to 256).
#include "paged_attn.cuh"
#include "paged_chunk.cuh"

extern "C" int paged_prefill_launch(int is_bf16, const void* q, const void* k,
                                    const void* v, const void* block_row,
                                    void* out, void* part, int C, int H, int KV,
                                    int Dh, int Dv, int page, int nb,
                                    int pages_per_split, int offset, int valid,
                                    float scale, void* stream) {
  if (KV < 1 || H % KV != 0 || offset < 0 || valid < 1 || valid > C)
    return cudaErrorInvalidValue;
  paged_attn::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.block_table = static_cast<const int*>(block_row);
  p.lengths = nullptr;
  p.part = static_cast<float*>(part);
  p.len_host = offset + valid;
  p.causal_offset = offset;
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
  return paged_attn::dispatch(is_bf16, p, stream);
}

// The tensor-core route: q, k, v, out bf16; part holds KV * 16 * ceil(C * G
// / 16) * splits * (Dv + 2) floats; counters as paged_chunk::launch says.
extern "C" int paged_prefill_mma_launch(const void* q, const void* k, const void* v,
                                        const void* block_row, void* out, void* part,
                                        void* counters, int C, int H, int KV, int Dh,
                                        int Dv, int page, int nb, int offset, int valid,
                                        int splits, int split_keys, float scale,
                                        void* stream) {
  if (page < 1 || nb < 1 || valid < 1 || offset < 0 || offset + valid > nb * page ||
      !paged_chunk::aligned16(k) || !paged_chunk::aligned16(v))
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
  paged_chunk::PageKV kvl{};
  kvl.k = static_cast<const __nv_bfloat16*>(k);
  kvl.v = static_cast<const __nv_bfloat16*>(v);
  kvl.block_row = static_cast<const int*>(block_row);
  kvl.page = page;
  return paged_chunk::launch(p, kvl, C, scale, stream);
}

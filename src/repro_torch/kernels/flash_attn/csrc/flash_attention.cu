// Contiguous flash attention forward (B8 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attn/kernel.py:276, body `_kernel` :26): GQA
// attention of q (B, T, H, Dh) over k (B, S, KV, Dh) and v (B, S, KV, Dv),
// query head h reading kv head h / (H / KV), causal (query token i sees keys
// j <= i) or not, out (B, T, H, Dv) in q's dtype. The TPU kernel pads T and
// S up to its block sizes and masks keys past S; here every tile and split
// ends at S and every row block at T, which masks the same keys without
// copying anything. Like the TPU kernel, a causal block skips the key tiles
// its rows all mask: a row block stops at the last key its last row sees,
// and a split that starts past it exits at once.
//
// The work is the dense paged kernels' own (../../paged_attn/csrc/
// paged_attn.cuh): per (kv head, row b) the query rows are token-major,
// R = T * G, row r being token r / G and head kv * G + r % G; each block
// stages 16 query rows and tiles of 64 keys in shared memory and runs the
// online softmax in float32 on CUDA cores; the key range is cut into splits
// whose partials a second pass merges. Without a block table the arenas are
// read as one page of one token per row: key j of row b is arena row
// b * s_stride + j, so k and v may be the written prefix of a longer arena
// (the static engine's dense decode hands the kernel k[:, :L]).
//
// What bounds it: at the static prefill shape (8 rows of 512 tokens, 16
// heads of 64, causal) the operations, 8.6 GFLOP, about 9 us at the bf16
// tensor-core peak, while this first version computes in float32 on CUDA
// cores (tensor-core tiles are later work); at the dense decode shape (one
// query token over up to 575 keys) the K/V bytes, one read of each.
#include "../../paged_attn/csrc/paged_attn.cuh"

extern "C" int flash_attention_launch(int is_bf16, const void* q, const void* k,
                                      const void* v, void* out, void* part, int B,
                                      int T, int S, int H, int KV, int Dh, int Dv,
                                      long q_sb, long q_stok, int s_stride,
                                      int split_tokens, int causal, float scale,
                                      void* stream) {
  if (KV < 1 || H % KV != 0 || B < 1 || T < 1 || S < 1 || s_stride < S)
    return cudaErrorInvalidValue;
  paged_attn::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.block_table = nullptr;  // contiguous: key j of row b at arena row b * s_stride + j
  p.lengths = nullptr;
  p.part = static_cast<float*>(part);
  p.len_host = S;
  p.causal_offset = causal ? 0 : -1;
  p.B = B;
  p.KV = KV;
  p.G = H / KV;
  p.R = T * p.G;
  p.Dh = Dh;
  p.Dv = Dv;
  p.page = 1;
  p.nb = s_stride;
  p.pages_per_split = split_tokens;
  p.q_sb = q_sb;
  p.q_stok = q_stok;
  p.o_sb = (long)T * H * Dv;
  p.o_stok = (long)H * Dv;
  p.scale = scale;
  return paged_attn::dispatch(is_bf16, p, stream);
}

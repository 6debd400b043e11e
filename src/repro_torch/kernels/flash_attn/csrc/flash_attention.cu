// Contiguous flash attention forward in float32 (B8's float32 prompt route
// in the port's kernel table).
//
// Replaces, for a float32 prompt, the JAX package's Pallas TPU kernel
// `flash_attention_fwd` (src/repro/kernels/flash_attn/kernel.py:276, body
// `_kernel` :26): GQA attention of q (B, T, H, Dh) over k (B, S, KV, Dh) and
// v (B, S, KV, Dv), query head h reading kv head h / (H / KV), causal (query
// token i sees keys j <= i) or not, out (B, T, H, Dv). A bf16 prompt runs
// the tensor-core forward (flash_prompt.cu) and a decode token the
// single-query kernel (flash_decode.cu); float32 stays on CUDA cores, the
// only route that meets the float32 gate (TF32 tensor cores keep about three
// decimal digits). The TPU kernel pads T and S up to its block sizes and
// masks keys past S; here every tile and split ends at S and every row
// block at T, which masks the same keys without copying anything. Like the
// TPU kernel, a causal block skips the key tiles its rows all mask: a row
// block stops at the last key its last row sees, and a split that starts
// past it exits at once.
//
// The work is the dense paged kernels' own (../../paged_attn/csrc/
// paged_attn.cuh): per (kv head, row b) the query rows are token-major,
// R = T * G, row r being token r / G and head kv * G + r % G; each block
// stages 16 query rows and tiles of 64 keys in shared memory and runs the
// online softmax in float32 on CUDA cores; the key range is cut into splits
// whose partials a second pass merges. Without a block table the arenas are
// read as one page of one token per row: key j of row b is arena row
// b * s_stride + j, so k and v may be the written prefix of a longer arena.
//
// What bounds it: for a prompt of hundreds of tokens, the float32
// operations on CUDA cores (67 TFLOP/s at the H100's peak).
#include "../../paged_attn/csrc/paged_attn.cuh"

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, void* part, int B, int T, int S, int H,
                                      int KV, int Dh, int Dv, long q_sb, long q_stok,
                                      int s_stride, int split_tokens, int causal,
                                      float scale, void* stream) {
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
  return paged_attn::launch<float>(p, static_cast<cudaStream_t>(stream));
}

// Contiguous T1 decomposed decode attention (B9 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `decomposed_decode_fwd`
// (src/repro/kernels/decomposed_attn/kernel.py:298, body `_kernel` :32).
// One query token per row attends the row's first `length` tokens of a
// contiguous X arena: r (B, H, Dm) = q_nope W_K^T, q_rope (B, H, Rr),
// x (B, N, Dm), k_rope (B, N, kv_r, Rr) and one host length for every row
// -> P (B, H, Dm) in x's dtype; the caller applies W_V. The TPU kernel takes
// one roped key per token shared by every head (kv_r == 1, the MLA layout)
// or Rr == 0; this kernel also takes a roped key per kv head (kv_r == KV),
// the layout of qwen's T1 cache, where head h reads group h / (H / kv_r).
//
// It runs the T1 sweep of the paged kernel B3 (paged_decomposed.cuh): one
// block holds the 16 heads of one row over a split of 16 keys, X goes from
// device memory to registers once and serves both cascaded products, the
// online softmax runs in float32 and a second pass merges the splits. Here
// the arenas are read with no block table (key t of row b is arena row
// b * N + t) and positions at or past `length` are never read. Where the
// TPU kernel rounds the softmax weights to x's dtype before the value
// product, they stay float32 here, as in B3. Bound by device-memory
// traffic: the live X rows and roped keys, one read each.
//
// Two routes, picked by the wrapper before the launch (t1_decode_route in
// ../ops.py): bf16 calls of the widths t1_token.cuh takes run on the tensor
// cores (decomposed_decode_mma_launch, B3's tensor-core kernel over
// contiguous rows); float32 calls and other widths run the sweep described
// above (decomposed_decode_launch).
#include "paged_decomposed.cuh"
#include "t1_token.cuh"

extern "C" int decomposed_decode_launch(int is_bf16, const void* r, const void* q_rope,
                                        const void* x, const void* k_rope, void* out,
                                        void* part, int B, int H, int kv_r, int Rr,
                                        int Dm, int N, int length, int split_tokens,
                                        float scale, void* stream) {
  if (B < 1 || N < 1 || length < 0 || length > N) return cudaErrorInvalidValue;
  decomposed_attn::Params p{};
  p.r = r;
  p.qr = q_rope;
  p.x = x;
  p.kr = k_rope;
  p.out = out;
  p.block_table = nullptr;  // contiguous: key t of row b at arena row b * N + t
  p.lengths = nullptr;
  p.valid = length;         // the one length of every row
  p.part = static_cast<float*>(part);
  p.prefill = 0;
  p.B = B;
  p.C = 1;
  p.H = H;
  p.kv_r = kv_r;
  p.Rr = Rr;
  p.Dm = Dm;
  p.page = 1;
  p.nb = N;
  p.pages_per_split = split_tokens;
  p.scale = scale;
  return decomposed_attn::dispatch<true>(is_bf16, p, stream);
}

// The tensor-core route: r, q_rope, x, k_rope, out bf16; part and counters
// and the splits (planned from `length`) as t1_token::launch says.
extern "C" int decomposed_decode_mma_launch(const void* r, const void* q_rope, const void* x,
                                            const void* k_rope, void* out, void* part,
                                            void* counters, int B, int H, int kv_r, int Rr,
                                            int Dm, int N, int length, int splits,
                                            int split_keys, float scale, void* stream) {
  using t1_token::bf16;
  if (N < 1 || length < 0 || length > N) return cudaErrorInvalidValue;
  t1_token::Params p{};
  p.r = static_cast<const bf16*>(r);
  p.qr = static_cast<const bf16*>(q_rope);
  p.x = static_cast<const bf16*>(x);
  p.kr = static_cast<const bf16*>(k_rope);
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
  return t1_token::launch(p, t1_token::ContigRows{N, length}, length, scale,
                          static_cast<cudaStream_t>(stream));
}

// T3 proxy scores over int8 key-code pages (B7 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `proxy_scores_fwd`
// (src/repro/kernels/topk_retrieval/kernel.py:39, body `_kernel` :28): the
// associative-match sweep of retrieval attention over ALL cached keys,
//
//   out[b, kv, g, n] = qs[b, kv, g, :] . (code[b, n, kv, :] + 128) + qz[b, kv, g]
//
// for n < lengths[b], and -1e30 from there to N. qs (B, KV, G, Dp) float32
// (= q * proxy scale), qz (B, KV, G) float32 (= q . proxy zero), code pages
// (P, page, KV, Dp) int8 read through block_table (B, nb) int32, lengths
// (B,) int32 -> out (B, KV, G, N) float32, N <= nb * page. The TPU kernel
// reads a contiguous (B, N, KV, Dp) code array with one scalar length; that
// is this kernel with one page of N keys per row (table [[0], [1], ...]).
// Keys at or past a row's length read no page, so the null page 0, which
// only unmapped blocks name, is never read.
//
// What bounds it: device-memory traffic. Each live key costs Dp code bytes
// (64 on qwen1.5-0.5b) and 2 * G * Dp float32 operations, and each output
// score 4 bytes: about one operation per byte, far below the card's balance
// point. It is a GEMV, not a tensor-core tile (G = 1 on an MHA model). The
// design keeps every load independent and coalesced at the output:
//
//   * one thread per key: a block of 128 threads sweeps 128 neighbouring
//     positions of one (row, kv head); neighbouring threads score
//     neighbouring keys and write neighbouring scores;
//   * a thread issues all of its key's Dp / 16 16-byte code loads before it
//     converts any (the number of loads is a template argument), then
//     accumulates G dot products in float32 registers;
//   * the block's G query rows sit in shared memory, where every thread
//     reads the same word at once (a broadcast, no bank conflict);
//   * a block whose 128 positions all lie past the row's length writes its
//     -1e30s without staging the query rows or touching a page.
//
// G = 1, 2, 4 and 8 are instantiations; any other G (phi4-mini has 24 heads
// over 8 kv heads, G = 3) runs proxy_scores_any_g, which sums one query row
// at a time over the key's codes, held in registers once, reading the rows'
// factors through the read-only cache (every thread reads the same word).
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk_retrieval {

constexpr int kThreads = 128;
constexpr int kMaxDp = 256;
constexpr float kNegInf = -1e30f;

struct Params {
  const float* qs;          // (B, KV, G, Dp)
  const float* qz;          // (B, KV, G)
  const int8_t* codes;      // (P, page, KV, Dp)
  const int* block_table;   // (B, nb)
  const int* lengths;       // (B,)
  float* out;               // (B, KV, G, N)
  int KV, page, nb, N;
};

// G query rows per kv head, NC 16-byte chunks of codes per key (Dp = 16 NC)
template <int G, int NC>
__global__ void __launch_bounds__(kThreads) proxy_scores_kernel(Params p) {
  constexpr int Dp = 16 * NC;
  __shared__ __align__(16) float qs[G * Dp];
  __shared__ float qz[G];
  const int kv = blockIdx.y, b = blockIdx.z;
  const long head = (long)b * p.KV + kv;
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + threadIdx.x;
  const int len = p.lengths[b];
  float* o = p.out + head * G * (long)p.N + n;
  if (n0 >= len) {  // the whole tile is past the row's length
    if (n < p.N) {
#pragma unroll
      for (int g = 0; g < G; ++g) o[(long)g * p.N] = kNegInf;
    }
    return;
  }
  for (int i = threadIdx.x; i < G * Dp; i += kThreads) qs[i] = p.qs[head * G * Dp + i];
  if (threadIdx.x < G) qz[threadIdx.x] = p.qz[head * G + threadIdx.x];
  __syncthreads();
  if (n >= p.N) return;
  if (n >= len) {
#pragma unroll
    for (int g = 0; g < G; ++g) o[(long)g * p.N] = kNegInf;
    return;
  }
  const int blk = n / p.page;
  const int slot = n - blk * p.page;
  const long pg = p.block_table[(long)b * p.nb + blk];
  const uint4* src = reinterpret_cast<const uint4*>(
      p.codes + ((pg * p.page + slot) * p.KV + kv) * (long)Dp);
  uint4 chunk[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) chunk[c] = __ldg(src + c);
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int8_t* code = reinterpret_cast<const int8_t*>(&chunk[c]);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float cv = (float)code[i] + 128.f;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(qs[g * Dp + c * 16 + i], cv, acc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) o[(long)g * p.N] = acc[g] + qz[g];
}

// G query rows per kv head, G a runtime value: one row at a time over the
// key's codes, held in registers once
template <int NC>
__global__ void __launch_bounds__(kThreads) proxy_scores_any_g(Params p, int G) {
  constexpr int Dp = 16 * NC;
  const int kv = blockIdx.y, b = blockIdx.z;
  const long head = (long)b * p.KV + kv;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int len = p.lengths[b];
  float* o = p.out + head * G * (long)p.N + n;
  if (n >= p.N) return;
  if (n >= len) {
    for (int g = 0; g < G; ++g) o[(long)g * p.N] = kNegInf;
    return;
  }
  const int blk = n / p.page;
  const int slot = n - blk * p.page;
  const long pg = p.block_table[(long)b * p.nb + blk];
  const uint4* src = reinterpret_cast<const uint4*>(
      p.codes + ((pg * p.page + slot) * p.KV + kv) * (long)Dp);
  uint4 chunk[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) chunk[c] = __ldg(src + c);
  for (int g = 0; g < G; ++g) {
    const float* qs = p.qs + (head * G + g) * Dp;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int8_t* code = reinterpret_cast<const int8_t*>(&chunk[c]);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc = fmaf(__ldg(qs + c * 16 + i), (float)code[i] + 128.f, acc);
    }
    o[(long)g * p.N] = acc + __ldg(p.qz + head * G + g);
  }
}

template <int NC>
cudaError_t launch_any_g(const Params& p, int G, int B, cudaStream_t stream) {
  const dim3 grid((p.N + kThreads - 1) / kThreads, p.KV, B);
  proxy_scores_any_g<NC><<<grid, kThreads, 0, stream>>>(p, G);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_g(const Params& p, int Dp, int B, cudaStream_t stream) {
  const dim3 grid((p.N + kThreads - 1) / kThreads, p.KV, B);
  switch (Dp / 16) {
    case 1: proxy_scores_kernel<G, 1><<<grid, kThreads, 0, stream>>>(p); break;
    case 2: proxy_scores_kernel<G, 2><<<grid, kThreads, 0, stream>>>(p); break;
    case 4: proxy_scores_kernel<G, 4><<<grid, kThreads, 0, stream>>>(p); break;
    case 8: proxy_scores_kernel<G, 8><<<grid, kThreads, 0, stream>>>(p); break;
    case 16: proxy_scores_kernel<G, 16><<<grid, kThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace topk_retrieval

// Dp must be 16, 32, 64, 128 or 256 and G at least 1; returns the CUDA
// error of the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int proxy_scores_launch(const void* qs, const void* qz, const void* codes,
                                   const void* block_table, const void* lengths,
                                   void* out, int B, int KV, int G, int Dp, int page,
                                   int nb, int N, void* stream) {
  using namespace topk_retrieval;
  if (B < 0 || KV < 1 || G < 1 || page < 1 || nb < 1 || N < 0 ||
      (long)N > (long)nb * page || Dp % 16 != 0 || Dp > kMaxDp)
    return cudaErrorInvalidValue;
  if (B == 0 || N == 0) return cudaSuccess;
  Params p{};
  p.qs = static_cast<const float*>(qs);
  p.qz = static_cast<const float*>(qz);
  p.codes = static_cast<const int8_t*>(codes);
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.KV = KV;
  p.page = page;
  p.nb = nb;
  p.N = N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1: return launch_g<1>(p, Dp, B, s);
    case 2: return launch_g<2>(p, Dp, B, s);
    case 4: return launch_g<4>(p, Dp, B, s);
    case 8: return launch_g<8>(p, Dp, B, s);
  }
  switch (Dp / 16) {
    case 1: return launch_any_g<1>(p, G, B, s);
    case 2: return launch_any_g<2>(p, G, B, s);
    case 4: return launch_any_g<4>(p, G, B, s);
    case 8: return launch_any_g<8>(p, G, B, s);
    case 16: return launch_any_g<16>(p, G, B, s);
    default: return cudaErrorInvalidValue;
  }
}

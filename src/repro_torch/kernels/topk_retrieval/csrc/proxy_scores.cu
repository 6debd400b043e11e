// T3 proxy scores over int8 key codes (B7 of the port's kernel table).
//
// Replaces the JAX package's Pallas TPU kernel `proxy_scores_fwd`
// (src/repro/kernels/topk_retrieval/kernel.py:39, body `_kernel` :28): the
// associative-match sweep of retrieval attention over ALL cached keys,
//
//   out[b, kv, g, n] = qs[b, kv, g, :] . (code[b, n, kv, :] + 128) + qz[b, kv, g]
//
// for n below row b's length, and -1e30 from there to N; out (B, KV, G, N)
// float32. Code pages (P, page, KV, Dp) int8 are read through block_table
// (B, nb) int32 with per-row lengths (B,) int32 (the served call), or, with
// no block table, contiguous codes (B, N, KV, Dp) with one length (the TPU
// kernel's contract: row b is page b of N keys). Keys at or past a row's
// length are never read, so the null page 0 is never read.
//
// Two entry points, one kernel:
//   * proxy_scores_launch: the query factors given, qs (B, KV, G, Dp) and
//     qz (B, KV, G) float32 (B7's own contract);
//   * proxy_scores_fused_launch: the factors formed in the kernel's
//     prologue from q (B, H, Dp) in q's type (bf16 or float32, rows at any
//     stride) and the slot's proxy scale and zero (B, KV, Dp) float32, as
//     the served call's query_factors does: qs = float(q) * scale, the same
//     single float32 multiply (bit-identical), and qz = float(q) . zero,
//     summed as four-term fused multiply-adds and then across them in a
//     warp, an order of summation other than the einsum's (within 1e-7 of
//     it, relative). With q_mul the query is first multiplied by q_mul and
//     rounded to q's type, as the eager `q * scale` of the served call is.
//
// What bounds it: at the served shape (qwen1.5-0.5b, 8 rows, KV = 16, G =
// 1, Dp = 64, N = 1024 positions over 64 pages of 16) a call moves ~1.4 MB,
// half of it the scores written: 0.4 us at 3.35 TB/s. The cost is latency:
// the old wrapper's four launches for the query factors, then a kernel
// whose threads each waited on the length, then on a block-table entry,
// then on their codes. Here one launch and two dependent round trips:
//
//   * one thread per key: a block of 128 threads sweeps 128 neighbouring
//     positions of one (row, kv head); neighbouring threads write
//     neighbouring scores;
//   * round trip 1: the row's length, each thread's block-table entry
//     (whatever the length: entries past it are never used) and the kv
//     head's factor inputs (G query rows of Dp, the slot's scale and zero
//     rows). A block wholly past the length writes its -1e30s and leaves;
//   * round trip 2: each live key's Dp / 16 16-byte code loads, all issued
//     before any is used; the block forms qs and qz in shared memory while
//     they arrive;
//   * each thread sums its key's G dot products in float32 (two chains of
//     fused multiply-adds each), the factors read from shared memory where
//     every thread of a warp reads the same word (a broadcast).
//
// (Measured on an H100, PERF.md section 6: blocks over runs of positions
// of a row across every kv head, the codes staged by bulk copies, took
// 6.6-7.7 us a call: each block formed the factors of all 16 heads, more
// bytes than its codes, behind three block barriers.)
//
// G up to 1, 4 or 8 runs the instantiation with that many heads a pass
// (phi4-mini's G = 3 the 4-head one); more heads take passes of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk_retrieval {

constexpr int kThreads = 128;      // keys a block
constexpr int kMaxDp = 256;
constexpr int kQuads = 4;          // factor quads a thread has in flight (2 measured slower)
constexpr float kNegInf = -1e30f;

// the factors: given (qs, qz), or formed from q and the tables
enum Factors { kGiven = 0, kFusedF32 = 1, kFusedBF16 = 2 };

struct Params {
  const int8_t* codes;      // (P, page, KV, Dp); no block table: (B, N, KV, Dp)
  const int* block_table;   // (B, nb), or null: row b is page b of `page` = N keys
  const int* lengths;       // row b's at lengths[b * len_stride], or null: len
  int len_stride, len;
  float* out;               // (B, KV, G, N)
  int B, KV, G, Dp, page, nb, N;
  int mode;                 // Factors
  const float* qs;          // kGiven: (B, KV, G, Dp)
  const float* qz;          // kGiven: (B, KV, G)
  const void* q;            // fused: (B, H, Dp) rows at q_sb, q_sh elements
  long q_sb, q_sh;
  float q_mul;              // fused: q is multiplied by this and rounded first
  int has_mul;
  const float* scale;       // fused: (B, KV, Dp)
  const float* zero;        // fused: (B, KV, Dp)
};

// shared memory: qs [G][Dp], the four-term sums of qz [G][Dp / 4], qz [G]
inline size_t smem_bytes(int G, int Dp) {
  return sizeof(float) * (size_t)G * (Dp + Dp / 4 + 1);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The inputs of a thread's (at most kQuads) element quads (g, d .. d + 3)
// of the kv head's factors, from quad i0 + u * kThreads + threadIdx.x: q
// (or given qs), scale and zero.
struct FactorIn {
  float q[kQuads][4];
  float4 sc[kQuads], ze[kQuads];
};

__device__ __forceinline__ void fetch_factors(const Params& p, int b, int kv, int i0,
                                              FactorIn& f) {
  const int nq = p.Dp / 4;
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int i = i0 + u * kThreads + threadIdx.x;
    if (i >= p.G * nq) continue;
    const int h = kv * p.G + i / nq, d = (i % nq) * 4;
    if (p.mode == kGiven) {
      const float4 x = __ldg(
          reinterpret_cast<const float4*>(p.qs + ((long)b * p.KV * p.G + h) * p.Dp + d));
      f.q[u][0] = x.x, f.q[u][1] = x.y, f.q[u][2] = x.z, f.q[u][3] = x.w;
      continue;
    }
    const long at = (long)b * p.q_sb + (long)h * p.q_sh + d;
    if (p.mode == kFusedBF16) {
      const uint2 raw =
          __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p.q) + at));
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int k = 0; k < 4; ++k) f.q[u][k] = __bfloat162float(e[k]);
    } else {
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p.q) + at));
      f.q[u][0] = x.x, f.q[u][1] = x.y, f.q[u][2] = x.z, f.q[u][3] = x.w;
    }
    const long t = ((long)b * p.KV + kv) * p.Dp + d;
    f.sc[u] = __ldg(reinterpret_cast<const float4*>(p.scale + t));
    f.ze[u] = __ldg(reinterpret_cast<const float4*>(p.zero + t));
  }
}

// qs of the thread's quads, and their four-term sums of qz (fused) or qz
// itself (given), into shared memory
__device__ __forceinline__ void store_factors(const Params& p, int b, int kv, int i0,
                                              const FactorIn& f, float* qs_s, float* part_s,
                                              float* qz_s) {
  const int nq = p.Dp / 4;
#pragma unroll
  for (int u = 0; u < kQuads; ++u) {
    const int i = i0 + u * kThreads + threadIdx.x;
    if (i >= p.G * nq) continue;
    const int g = i / nq, d = (i % nq) * 4;
    float x[4] = {f.q[u][0], f.q[u][1], f.q[u][2], f.q[u][3]};
    if (p.mode == kGiven) {
      *reinterpret_cast<float4*>(qs_s + g * p.Dp + d) = make_float4(x[0], x[1], x[2], x[3]);
      continue;
    }
    if (p.has_mul) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = p.mode == kFusedBF16 ? bf16_round(x[k] * p.q_mul) : x[k] * p.q_mul;
    }
    const float4 sc = f.sc[u], ze = f.ze[u];
    *reinterpret_cast<float4*>(qs_s + g * p.Dp + d) =
        make_float4(x[0] * sc.x, x[1] * sc.y, x[2] * sc.z, x[3] * sc.w);
    part_s[g * nq + d / 4] = fmaf(x[3], ze.w, fmaf(x[2], ze.z, fmaf(x[1], ze.y, x[0] * ze.x)));
  }
  if (p.mode == kGiven && i0 == 0 && (int)threadIdx.x < p.G)
    qz_s[threadIdx.x] = __ldg(p.qz + ((long)b * p.KV + kv) * p.G + threadIdx.x);
}

// NC 16-byte chunks of codes a key (Dp = 16 NC), GMAX query heads a pass.
template <int NC, int GMAX>
__global__ void __launch_bounds__(kThreads) scores_kernel(Params p) {
  extern __shared__ __align__(16) float t3_smem[];
  float* qs_s = t3_smem;                   // [G][Dp]
  float* part_s = qs_s + p.G * p.Dp;       // [G][Dp / 4]
  float* qz_s = part_s + p.G * (p.Dp / 4);  // [G]
  const int kv = blockIdx.y, b = blockIdx.z;
  const int n0 = blockIdx.x * kThreads, n = n0 + threadIdx.x;
  const int nq = p.Dp / 4;
  float* o = p.out + ((long)b * p.KV + kv) * p.G * (long)p.N + n;

  // round trip 1: the length, this key's page and the factors' inputs
  const int len = min(p.lengths ? __ldg(p.lengths + (long)b * p.len_stride) : p.len, p.N);
  int pg = b;
  if (p.block_table && n < p.N) pg = __ldg(p.block_table + (long)b * p.nb + n / p.page);
  FactorIn f;
  fetch_factors(p, b, kv, 0, f);
  if (n0 >= len) {  // the whole run is past the row's length
    if (n < p.N)
      for (int g = 0; g < p.G; ++g) o[(long)g * p.N] = kNegInf;
    return;
  }

  // round trip 2: the key's codes, then the factors while they arrive
  const bool live = n < len;
  uint4 raw[NC];
  const uint4* src = reinterpret_cast<const uint4*>(
      p.codes + (((long)pg * p.page + n % p.page) * p.KV + kv) * (long)p.Dp);
#pragma unroll
  for (int c = 0; c < NC; ++c) raw[c] = live ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
  store_factors(p, b, kv, 0, f, qs_s, part_s, qz_s);
  for (int i0 = kQuads * kThreads; i0 < p.G * nq; i0 += kQuads * kThreads) {
    fetch_factors(p, b, kv, i0, f);
    store_factors(p, b, kv, i0, f, qs_s, part_s, qz_s);
  }
  __syncthreads();  // qs and the four-term sums
  if (p.mode != kGiven) {  // qz of each head: a warp a head, in a fixed order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int g = warp; g < p.G; g += kThreads / 32) {
      float s = 0.f;
      for (int j = lane; j < nq; j += 32) s += part_s[g * nq + j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) qz_s[g] = s;
    }
  }
  __syncthreads();  // qz
  if (n >= p.N) return;
  if (!live) {
    for (int g = 0; g < p.G; ++g) o[(long)g * p.N] = kNegInf;
    return;
  }

  // c8 + 128 of each code as a float: the unsigned byte c8 ^ 0x80 set into
  // the mantissa of 2^23, less 2^23 (exact; a byte permute and an add,
  // where a conversion instruction runs at a quarter of the rate)
  for (int gp = 0; gp < p.G; gp += GMAX) {  // one pass for G up to GMAX
    float acc[GMAX][2];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t w[4] = {raw[c].x ^ 0x80808080u, raw[c].y ^ 0x80808080u,
                             raw[c].z ^ 0x80808080u, raw[c].w ^ 0x80808080u};
      float cv[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        cv[e] = __uint_as_float(__byte_perm(w[e / 4], 0x4B000000u, 0x7440u + (e % 4))) -
                8388608.f;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (gp + g < p.G) {
          const float4* q4 = reinterpret_cast<const float4*>(qs_s + (gp + g) * p.Dp + c * 16);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const float4 w4 = q4[e4];
            float& a = acc[g][e4 & 1];
            a = fmaf(w4.x, cv[4 * e4], a);
            a = fmaf(w4.y, cv[4 * e4 + 1], a);
            a = fmaf(w4.z, cv[4 * e4 + 2], a);
            a = fmaf(w4.w, cv[4 * e4 + 3], a);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
      if (gp + g < p.G) o[(long)(gp + g) * p.N] = acc[g][0] + acc[g][1] + qz_s[gp + g];
  }
}

template <int NC>
int launch_nc(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + kThreads - 1) / kThreads, p.KV, p.B);
  void (*kernel)(Params) = p.G == 1   ? &scores_kernel<NC, 1>
                          : p.G <= 4 ? &scores_kernel<NC, 4>
                                     : &scores_kernel<NC, 8>;
  const size_t bytes = smem_bytes(p.G, p.Dp);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Dp 16, 32, 64, 128 or 256; the codes 16-byte aligned.
int launch(Params p, cudaStream_t stream) {
  const int nc = p.Dp / 16;
  if (p.B < 0 || p.KV < 1 || p.G < 1 || p.page < 1 || p.nb < 1 || p.N < 0 || p.Dp < 16 ||
      p.Dp > kMaxDp || p.Dp % 16 || (nc & (nc - 1)) ||
      (p.block_table && (long)p.N > (long)p.nb * p.page) ||
      (!p.block_table && p.page != p.N) || reinterpret_cast<uintptr_t>(p.codes) % 16 ||
      smem_bytes(p.G, p.Dp) > 227 * 1024)
    return cudaErrorInvalidValue;
  if (p.B == 0 || p.N == 0) return cudaSuccess;
  switch (nc) {
    case 1: return launch_nc<1>(p, stream);
    case 2: return launch_nc<2>(p, stream);
    case 4: return launch_nc<4>(p, stream);
    case 8: return launch_nc<8>(p, stream);
    default: return launch_nc<16>(p, stream);
  }
}

Params base(const void* codes, const void* block_table, const void* lengths, int len_stride,
            int len, void* out, int B, int KV, int G, int Dp, int page, int nb, int N) {
  Params p{};
  p.codes = static_cast<const int8_t*>(codes);
  p.block_table = static_cast<const int*>(block_table);
  p.lengths = static_cast<const int*>(lengths);
  p.len_stride = len_stride;
  p.len = len;
  p.out = static_cast<float*>(out);
  p.B = B;
  p.KV = KV;
  p.G = G;
  p.Dp = Dp;
  p.page = page;
  p.nb = nb;
  p.N = N;
  return p;
}

}  // namespace topk_retrieval

// B7's contract, the factors given. block_table null: contiguous codes
// (B, N, KV, Dp), page = N, nb = 1. lengths null: every row's length is
// len; else row b's is lengths[b * len_stride]. Returns the CUDA error of
// the launch (cudaErrorInvalidValue for a shape it does not take).
extern "C" int proxy_scores_launch(const void* qs, const void* qz, const void* codes,
                                   const void* block_table, const void* lengths,
                                   int len_stride, int len, void* out, int B, int KV, int G,
                                   int Dp, int page, int nb, int N, void* stream) {
  using namespace topk_retrieval;
  Params p = base(codes, block_table, lengths, len_stride, len, out, B, KV, G, Dp, page, nb,
                  N);
  p.mode = kGiven;
  p.qs = static_cast<const float*>(qs);
  p.qz = static_cast<const float*>(qz);
  if (reinterpret_cast<uintptr_t>(qs) % 16) return cudaErrorInvalidValue;
  return launch(p, static_cast<cudaStream_t>(stream));
}

// The served call: the factors formed from q (bf16 when q_bf16, else
// float32; element (b, h, d) at b * q_sb + h * q_sh + d, rows 8-byte (bf16)
// or 16-byte aligned) and the tables scale, zero (B, KV, Dp) float32, q
// first multiplied by q_mul and rounded to its type when has_mul.
extern "C" int proxy_scores_fused_launch(int q_bf16, const void* q, long q_sb, long q_sh,
                                         int has_mul, float q_mul, const void* scale,
                                         const void* zero, const void* codes,
                                         const void* block_table, const void* lengths,
                                         int len_stride, int len, void* out, int B, int KV,
                                         int G, int Dp, int page, int nb, int N, void* stream) {
  using namespace topk_retrieval;
  Params p = base(codes, block_table, lengths, len_stride, len, out, B, KV, G, Dp, page, nb,
                  N);
  p.mode = q_bf16 ? kFusedBF16 : kFusedF32;
  p.q = q;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.has_mul = has_mul;
  p.q_mul = q_mul;
  p.scale = static_cast<const float*>(scale);
  p.zero = static_cast<const float*>(zero);
  const int qa = q_bf16 ? 8 : 16, elt = q_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(q) % qa || (q_sb * elt) % qa || (q_sh * elt) % qa ||
      reinterpret_cast<uintptr_t>(scale) % 16 || reinterpret_cast<uintptr_t>(zero) % 16)
    return cudaErrorInvalidValue;
  return launch(p, static_cast<cudaStream_t>(stream));
}

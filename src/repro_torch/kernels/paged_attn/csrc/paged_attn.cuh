// Paged attention over a block-paged K/V arena, for Hopper (sm_90a).
//
// Shared device code of the two paged-attention kernels of the port:
// paged_decode.cu (one query token per request row) and paged_prefill.cu
// (one prompt chunk of one request slot, with a per-row causal mask). Both
// read K/V pages straight from the (P, page, KV, D) arena through the block
// table: no logical view of the cache is ever materialized.
//
// What bounds it: device-memory traffic. Every live K/V byte is read once
// and used for a handful of flops (decode: 2 flops per byte in bf16), far
// below the H100's ~295 flops/byte balance point, so the design aims at
// keeping many independent loads in flight rather than at the tensor cores:
//
//   * split over the key range: pass 1 runs one block per (key split of
//     `pages_per_split` pages, kv head, row block) — thousands of blocks for
//     a decode batch instead of one per (row, kv head) — and writes each
//     split's online-softmax partials (running max m, sum l, unnormalized
//     acc, all float32) to a scratch buffer; pass 2 merges the splits of
//     each query row. Splits wholly past a row's length exit at once.
//   * each block stages a tile of K and V tokens in shared memory: every
//     thread issues its coalesced 16-byte loads into registers before it
//     stores any of them (one round trip per tile instead of one per
//     element), then the block computes scores, the softmax update and P.V
//     out of shared memory.
//
// The same kernels serve contiguous arenas (the flash kernel B8,
// ../../flash_attn/csrc/flash_attention.cu): with no block table, the arena
// is (B, nb, KV, D) with page == 1, and token t of row b is arena row
// b * nb + t, so a row's keys are any prefix of a longer arena. A causal
// block stops at the last key its last query row may see: key tiles, and
// whole splits, that every row of the block masks are never loaded.
//
// Masking follows the JAX package's convention (null page 0 holds garbage,
// every position >= the row's length contributes nothing, a row of length 0
// returns zeros). Keys past the length are never loaded, so page 0 is never
// read for a well-formed block table. Unlike the reference's finite -1e30
// mask, a query row that has no live key in a tile keeps m = -inf and gets
// weight exactly 0 there: a split can be fully masked for a causal row,
// which the reference's sequential sweep never meets.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged_attn {

constexpr int kThreads = 128;
constexpr size_t kSmemBudget = 48 * 1024;  // static limit, no opt-in needed

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Unpack one load unit (a 16-byte vector or a single element) into floats.
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = f[e];
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) out[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void unpack(const float& x, float* out, float) { out[0] = x; }
__device__ __forceinline__ void unpack(const __nv_bfloat16& x, float* out, __nv_bfloat16) {
  out[0] = __bfloat162float(x);
}

// Stage n tokens x D elements of kv head `kv` from the arena into shared
// memory as float rows of stride `stride`. Each thread first issues up to
// kBatch loads into registers and only then stores them, so a tile costs
// one round trip to device memory rather than one per element. U is the
// load unit: a 16-byte vector (rows and base 16-byte aligned) or one T.
constexpr int kBatch = 8;
template <typename T, typename U>
__device__ __forceinline__ void stage_tile(float* dst, int stride, const T* src,
                                           const int* pg, int t0, int n, int D,
                                           int page, int KV, int kv) {
  constexpr int per = sizeof(U) / sizeof(T);  // elements per load unit
  const int units_per_row = D / per;
  const int total = n * units_per_row;
  for (int c0 = 0; c0 < total; c0 += kBatch * kThreads) {
    U buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads + threadIdx.x;
      if (c < total) {
        const int j = c / units_per_row, tok = t0 + j;
        const T* row = src + (((long)pg[j] * page + tok % page) * KV + kv) * D;
        buf[u] = reinterpret_cast<const U*>(row)[c % units_per_row];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads + threadIdx.x;
      if (c < total) {
        const int j = c / units_per_row;
        unpack(buf[u], dst + j * stride + (c % units_per_row) * per, T());
      }
    }
  }
}

struct Params {
  const void* q;          // query rows, addressed through the strides below
  const void* k;          // (P, page, KV, Dh) arena
  const void* v;          // (P, page, KV, Dv) arena
  void* out;              // output rows, addressed like q with Dv
  const int* block_table; // (B, nb) physical page of each logical block, or
                          // nullptr: contiguous (B, nb, KV, D) arenas, page 1
  const int* lengths;     // (B,) live tokens per row, or nullptr: len_host
  float* part;            // scratch: m (B,KV,R,S), l (B,KV,R,S), acc (B,KV,R,S,Dv)
  int len_host;
  int causal_offset;      // >= 0: query row r attends pos <= causal_offset + r / G
  int B, KV, G, R;        // R query rows per (row b, kv head)
  int Dh, Dv, page, nb;
  int pages_per_split, S;
  int rows_per_block, tile;
  int vec16;              // rows and arena bases allow 16-byte loads
  long q_sb, q_stok;      // element strides of q: per row b, per chunk token
  long o_sb, o_stok;      // same for out
  float scale;
};

// query row r of (b, kv) is token r / G, head kv * G + r % G
__device__ __forceinline__ long row_offset(long sb, long stok, int D, int b, int kv,
                                           int r, int G) {
  return b * sb + (r / G) * stok + (long)(kv * G + r % G) * D;
}

// Online-softmax update of one block's query rows with one staged tile of
// n key/value tokens (kt: [n][Dh + 1], vt: [n][Dv + 1] in shared memory),
// key positions t0 .. t0 + n - 1. With causal_offset >= 0, query row r of
// the block (absolute row r0 + r) sees position pos iff
// pos <= causal_offset + (r0 + r) / G. Shared state: sc [rows_per_block]
// [tile] scratch, acc [nr][Dv], m/l/corr [nr]. Entered with the staged
// tile visible to the block; the caller synchronizes before it restages.
__device__ __forceinline__ void attend_tile(const Params& p, const float* qs,
                                            const float* kt, const float* vt,
                                            float* sc, float* acc, float* m,
                                            float* l, float* corr, int nr, int n,
                                            int t0, int r0, int causal_offset) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dh = p.Dh, Dv = p.Dv, tile = p.tile;
  const int ks = Dh + 1, vs = Dv + 1;
  for (int i = tid; i < nr * n; i += kThreads) {
    const int r = i / n, j = i % n;
    float s = -INFINITY;
    if (causal_offset < 0 || t0 + j <= causal_offset + (r0 + r) / p.G) {
      const float* qr = qs + r * Dh;
      const float* kr = kt + j * ks;
      float a = 0.f;
      for (int d = 0; d < Dh; ++d) a = fmaf(qr[d], kr[d], a);
      s = a * p.scale;
    }
    sc[r * tile + j] = s;
  }
  __syncthreads();

  // online softmax update, one warp per query row
  for (int r = warp; r < nr; r += kThreads / 32) {
    float mt = -INFINITY;
    for (int j = lane; j < n; j += 32) mt = fmaxf(mt, sc[r * tile + j]);
    for (int o = 16; o; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_old = m[r];
    const float m_new = fmaxf(m_old, mt);
    const bool none = (m_new == -INFINITY);  // no live key for this row yet
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = none ? 0.f : expf(sc[r * tile + j] - m_new);
      sc[r * tile + j] = e;
      sum += e;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float c = none ? 1.f : expf(m_old - m_new);
      corr[r] = c;
      m[r] = m_new;
      l[r] = l[r] * c + sum;
    }
  }
  __syncthreads();

  for (int i = tid; i < nr * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    const float* w = sc + r * tile;
    float a = acc[i] * corr[r];
    for (int j = 0; j < n; ++j) a = fmaf(w[j], vt[j * vs + d], a);
    acc[i] = a;
  }
}

// Split-partial bookkeeping in p.part: m (B,KV,R,S), l (B,KV,R,S), acc
// (B,KV,R,S,Dv). Row r0 + i of (b, kv) and split `split` sits at
// base + i * S.
__device__ __forceinline__ long part_base(const Params& p, int b, int kv, int r0,
                                          int split) {
  return ((long)(b * p.KV + kv) * p.R + r0) * p.S + split;
}

// A split that sees no live key: l = 0, so the merge skips it.
__device__ __forceinline__ void empty_split(const Params& p, long base, int nr) {
  const long n_rows = (long)p.B * p.KV * p.R * p.S;
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    p.part[base + (long)i * p.S] = -INFINITY;
    p.part[n_rows + base + (long)i * p.S] = 0.f;
  }
}

__device__ __forceinline__ void write_partials(const Params& p, long base, int nr,
                                               const float* m, const float* l,
                                               const float* acc) {
  const long n_rows = (long)p.B * p.KV * p.R * p.S;
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    p.part[base + (long)i * p.S] = m[i];
    p.part[n_rows + base + (long)i * p.S] = l[i];
  }
  for (int i = threadIdx.x; i < nr * p.Dv; i += kThreads) {
    const int r = i / p.Dv, d = i % p.Dv;
    p.part[2 * n_rows + (base + (long)r * p.S) * p.Dv + d] = acc[i];
  }
}

// Load nr query rows of (b, kv) into qs and reset the softmax state.
template <typename T>
__device__ __forceinline__ void init_rows(const Params& p, float* qs, float* acc,
                                          float* m, float* l, int b, int kv,
                                          int r0, int nr) {
  const T* qp = static_cast<const T*>(p.q);
  for (int i = threadIdx.x; i < nr * p.Dh; i += kThreads) {
    const int r = i / p.Dh, d = i % p.Dh;
    qs[i] = to_f(qp[row_offset(p.q_sb, p.q_stok, p.Dh, b, kv, r0 + r, p.G) + d]);
  }
  for (int i = threadIdx.x; i < nr; i += kThreads) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nr * p.Dv; i += kThreads) acc[i] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) split_kernel(Params p) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, kv = blockIdx.y;
  const int nrb = (p.R + p.rows_per_block - 1) / p.rows_per_block;
  const int b = blockIdx.z / nrb;
  const int r0 = (blockIdx.z % nrb) * p.rows_per_block;
  const int nr = min(p.rows_per_block, p.R - r0);
  const int tid = threadIdx.x;
  const int Dh = p.Dh, Dv = p.Dv, tile = p.tile, rb = p.rows_per_block;
  const int ks = Dh + 1, vs = Dv + 1;  // padded rows: no bank conflicts across tokens

  float* qs = smem;                 // [rb][Dh]
  float* kt = qs + rb * Dh;         // [tile][Dh + 1]
  float* vt = kt + tile * ks;       // [tile][Dv + 1]
  float* sc = vt + tile * vs;       // [rb][tile] scores, then weights
  float* acc = sc + rb * tile;      // [rb][Dv]
  float* m = acc + rb * Dv;         // [rb]
  float* l = m + rb;                // [rb]
  float* corr = l + rb;             // [rb]
  int* pg = reinterpret_cast<int*>(corr + rb);  // [tile] page of each tile token

  const long base = part_base(p, b, kv, r0, split);
  int len = p.lengths ? p.lengths[b] : p.len_host;
  len = min(len, p.nb * p.page);
  const int tok0 = split * p.pages_per_split * p.page;
  int tok1 = min(len, tok0 + p.pages_per_split * p.page);
  if (p.causal_offset >= 0)  // nothing past what the block's last row may see
    tok1 = min(tok1, p.causal_offset + (r0 + nr - 1) / p.G + 1);
  if (tok0 >= tok1) {  // the whole split lies past the row's length or causal limit
    empty_split(p, base, nr);
    return;
  }
  init_rows<T>(p, qs, acc, m, l, b, kv, r0, nr);

  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  const int* bt = p.block_table ? p.block_table + (long)b * p.nb : nullptr;

  for (int t0 = tok0; t0 < tok1; t0 += tile) {
    const int n = min(tile, tok1 - t0);
    __syncthreads();  // the previous tile is consumed; initial state is visible
    for (int j = tid; j < n; j += kThreads)
      pg[j] = bt ? bt[(t0 + j) / p.page] : b * p.nb + t0 + j;
    __syncthreads();
    if (p.vec16) {
      stage_tile<T, uint4>(kt, ks, kp, pg, t0, n, Dh, p.page, p.KV, kv);
      stage_tile<T, uint4>(vt, vs, vp, pg, t0, n, Dv, p.page, p.KV, kv);
    } else {
      stage_tile<T, T>(kt, ks, kp, pg, t0, n, Dh, p.page, p.KV, kv);
      stage_tile<T, T>(vt, vs, vp, pg, t0, n, Dv, p.page, p.KV, kv);
    }
    __syncthreads();
    attend_tile(p, qs, kt, vt, sc, acc, m, l, corr, nr, n, t0, r0, p.causal_offset);
  }
  __syncthreads();
  write_partials(p, base, nr, m, l, acc);
}

// pass 2: merge the S split partials of each query row; splits with l == 0
// saw no live key and are skipped (their acc was never written)
template <typename T>
__global__ void reduce_kernel(Params p) {
  const int r = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const long n_rows = (long)p.B * p.KV * p.R * p.S;
  const float* part_m = p.part;
  const float* part_l = p.part + n_rows;
  const float* part_acc = p.part + 2 * n_rows;
  const long base = ((long)(b * p.KV + kv) * p.R + r) * p.S;
  float M = -INFINITY;
  for (int s = 0; s < p.S; ++s)
    if (part_l[base + s] > 0.f) M = fmaxf(M, part_m[base + s]);
  T* op = static_cast<T*>(p.out) + row_offset(p.o_sb, p.o_stok, p.Dv, b, kv, r, p.G);
  for (int d = threadIdx.x; d < p.Dv; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < p.S; ++s) {
      const float ls = part_l[base + s];
      if (ls > 0.f) {
        const float w = expf(part_m[base + s] - M);
        num = fmaf(w, part_acc[(base + s) * p.Dv + d], num);
        den = fmaf(w, ls, den);
      }
    }
    op[d] = from_f<T>(den > 0.f ? num / den : 0.f);  // length 0 -> zeros
  }
}

inline size_t smem_bytes(int rb, int tile, int Dh, int Dv) {
  return sizeof(float) * ((size_t)rb * Dh + (size_t)tile * (Dh + 1) +
                          (size_t)tile * (Dv + 1) + (size_t)rb * tile +
                          (size_t)rb * Dv + 3 * (size_t)rb) +
         sizeof(int) * tile;
}

// Fit the row block and the token tile into the shared-memory budget.
inline bool plan(Params& p) {
  int rb = p.R < 16 ? p.R : 16;
  int tile = p.pages_per_split * p.page < 64 ? p.pages_per_split * p.page : 64;
  while (smem_bytes(rb, tile, p.Dh, p.Dv) > kSmemBudget && tile > 8) tile /= 2;
  while (smem_bytes(rb, tile, p.Dh, p.Dv) > kSmemBudget && rb > 1) rb = (rb + 1) / 2;
  while (smem_bytes(rb, tile, p.Dh, p.Dv) > kSmemBudget && tile > 1) tile /= 2;
  p.rows_per_block = rb;
  p.tile = tile;
  return smem_bytes(rb, tile, p.Dh, p.Dv) <= kSmemBudget;
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  if (p.B < 1 || p.KV < 1 || p.R < 1 || p.pages_per_split < 1 || p.nb < 1 ||
      p.page < 1 || p.Dh < 1 || p.Dv < 1)
    return cudaErrorInvalidValue;
  p.S = (p.nb + p.pages_per_split - 1) / p.pages_per_split;
  if (!plan(p)) return cudaErrorInvalidValue;
  p.vec16 = (p.Dh * sizeof(T)) % 16 == 0 && (p.Dv * sizeof(T)) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  const int nrb = (p.R + p.rows_per_block - 1) / p.rows_per_block;
  const size_t bytes = smem_bytes(p.rows_per_block, p.tile, p.Dh, p.Dv);
  split_kernel<T><<<dim3(p.S, p.KV, p.B * nrb), kThreads, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = p.Dv >= 128 ? 128 : ((p.Dv + 31) / 32) * 32;
  reduce_kernel<T><<<dim3(p.R, p.KV, p.B), threads, 0, stream>>>(p);
  return cudaGetLastError();
}

inline int dispatch(int is_bf16, const Params& p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // namespace paged_attn

// T1 decomposed attention straight over a block-paged X arena, for Hopper
// (sm_90a).
//
// Shared device code of the port's three T1 kernels: paged_decomposed_decode.cu
// (one query token per request row), paged_decomposed_prefill.cu (one
// prompt chunk of one slot, causal per row) and decomposed_decode.cu (one
// query token per row over contiguous (B, N, ...) arenas with one length;
// the compile-time switch kContig: no block table, page 1, token t of row b
// at arena row b * N + t, the length in `valid`; the paged kernels' code and
// Params are untouched by it, and so is their register allocation).
// The arena caches the block
// input X (P, page, Dm) and a roped key slice (P, page, kv_r, Rr) instead of
// K and V. Each query row brings R = q_nope W_K^T (Dm values, computed
// outside) and its roped slice q_rope (Rr values); per live key position n
//
//   s[n] = (R . X[n] + q_rope . k_rope[n, kv_r group of the head]) * scale
//   P    = softmax(s) X                       (the caller applies W_V)
//
// so both cascaded products of the decomposition consume each X row on one
// read, and neither the scores nor P's partial sums go back to device
// memory except as the split partials below.
//
// What bounds it: the X and roped-key bytes of the live pages (3072 bytes
// per token at qwen1.5-0.5b's widths in bf16) against about 4 * H * Dm
// flops per token per row, ~22 flops per byte: below the bf16 tensor-core
// ridge, near the ridge of float32 CUDA-core math. This sweep runs on CUDA
// cores in float32. It serves float32 calls (TF32 would miss the float32
// gate) and the widths the tensor-core routes refuse: bf16 decodes of B3
// and B9 of other widths (their tensor-core kernel is t1_token.cuh) and
// bf16 chunks of B4 of other widths (paged_decomposed_chunk.cuh), d_model
// past 1024 among them.
//
// The design, against what the TPU kernel leaves to VMEM:
//
//   * One block serves kRows query rows (decode: 16 heads of one request
//     row; prefill: 16 consecutive head-major rows h * C + i of the chunk)
//     over one split of the key range, so each X page is read once for all
//     the rows a block holds, not once per kv head.
//   * Each thread owns DPT consecutive elements of the Dm axis for all
//     kRows rows: its slices of R and of the float32 accumulator P live in
//     registers (2 * kRows * DPT floats; the TPU kernel's (H, Dm) VMEM
//     accumulator is spread over the block's registers). A tile of kTile
//     keys is loaded with every thread reading only its own slice of each X
//     row, so X goes from device memory to registers once and serves both
//     the score and the value stage.
//   * Past Dm 2048 that no longer fits: a block holds (2 * rows + tile) *
//     Dm floats in registers, 64K at Dm 2048 with 16 rows and 8 keys, which
//     is all an SM has. Wider models (qwen3-4b 2560, phi4-mini 3072,
//     opt-6.7b 4096, jamba 8192) run the same sweep with fewer rows and keys
//     per block, both template parameters of the body: 4 rows and 4 keys at
//     DPT 8 (Dm up to 4096), 2 rows and 2 keys at DPT 16 (up to 8192), 96
//     floats of state a thread either way. Each block still reads its X
//     rows once for both products; one request row's heads now take H /
//     rows blocks, which read the same X (the later ones from L2). The
//     Dm <= 2048 kernels are the same body at 16 rows and 8 keys, under
//     their old names and with their old code.
//   * Scores: each thread forms kRows partial dot products per key, each
//     warp reduce-scatters them (15 exchanges and one sum per key for 16
//     rows), and the warps' sums meet in shared memory, where one warp per
//     (row, key) adds them to the roped term (keys staged per tile) and
//     applies the scale.
//   * The key range is cut into splits of `pages_per_split` pages, one block
//     each; every split writes float32 partials (m, l and P's acc, Dm per
//     row) and a second pass merges them, as the dense kernels do
//     (../../paged_attn/csrc/paged_attn.cuh). Splits wholly past a row's
//     length write an empty partial and exit; pages at or past the length,
//     and so the null page, are never read.
//
// Numerics follow the TPU kernel (src/repro/kernels/decomposed_attn/
// kernel.py:73-126): R, q_rope, X and the roped keys are taken to float32,
// scores and weights stay float32 into the value stage, and the output is
// acc / l cast to the arena dtype; a row of length 0 returns zeros. Where
// the TPU kernel masks with a finite -1e30, a key a row may not see gets
// weight exactly 0 here, and a split in which a causal row sees no key keeps
// m = -inf and is skipped by the merge.
#pragma once

#include <limits.h>

#include "../../paged_attn/csrc/paged_attn.cuh"

namespace decomposed_attn {

using paged_attn::from_f;
using paged_attn::to_f;

constexpr int kRows = 16;          // query rows per block
constexpr int kTile = 8;           // key tokens per tile
constexpr int kMaxThreads = 512;   // Dm / DPT threads, rounded up to a warp
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSpan = 1024;     // key tokens per split
constexpr size_t kSmemOptIn = 227 * 1024;

struct Params {
  const void* r;          // (rows, Dm) R = q_nope W_K^T in the arena dtype
  const void* qr;         // (rows, Rr) roped query slice, or unused (Rr == 0)
  const void* x;          // (P, page, Dm) X arena
  const void* kr;         // (P, page, kv_r, Rr) roped key arena
  void* out;              // (rows, Dm) P in the arena dtype
  const int* block_table; // decode (B, nb); prefill (nb,) the slot's row
  const int* lengths;     // decode (B,); prefill unused
  float* part;            // m (G, S, kRows), l (G, S, kRows), acc (G, S, kRows, Dm)
  int prefill;            // 0: rows b * H + h; 1: chunk rows i * H + h
  int B, C, H, kv_r, Rr, Dm, page, nb;
  int offset, valid;      // prefill: the chunk sits at positions offset + i;
                          // contiguous decode: valid is every row's length
  int pages_per_split, S;
  int groups, head_groups;  // G blocks of kRows rows; decode: groups per row b
  float scale;
};

struct Row {
  bool alive;   // a real query row (blocks pad the last group to kRows)
  int qrow;     // index into r / qr / out
  int limit;    // the row sees positions <= limit (prefill causal mask)
  int kvr;      // its roped-key group
};

// Row r of block group g (KR rows to a group). Decode: group g holds heads
// of request row g / head_groups. Prefill: the chunk's rows in head-major
// order h * C + i, as the TPU kernel lays them out, stored at i * H + h in r
// and out.
template <int KR = kRows>
__device__ __forceinline__ Row row_of(const Params& p, int g, int r) {
  Row w;
  int h;
  if (p.prefill) {
    const int gr = g * KR + r;
    w.alive = gr < p.H * p.C;
    h = gr / p.C;
    const int i = gr % p.C;
    w.qrow = i * p.H + h;
    w.limit = p.offset + i;
  } else {
    const int b = g / p.head_groups;
    h = (g % p.head_groups) * KR + r;
    w.alive = h < p.H;
    w.qrow = b * p.H + h;
    w.limit = INT_MAX;
  }
  w.kvr = p.Rr > 0 ? h / (p.H / p.kv_r) : 0;
  return w;
}

template <typename T, int DPT>
struct alignas(sizeof(T) * DPT) Slice {
  T v[DPT];
};

// DPT consecutive elements at src (aligned to their size) as floats.
template <typename T, int DPT>
__device__ __forceinline__ void load_slice(const T* src, float (&out)[DPT]) {
  const Slice<T, DPT> s = *reinterpret_cast<const Slice<T, DPT>*>(src);
#pragma unroll
  for (int e = 0; e < DPT; ++e) out[e] = to_f(s.v[e]);
}

// One halving exchange of a warp reduce-scatter: lanes with bit MASK set
// keep the upper K of their 2K values, the others the lower K, each adding
// its partner's copy of the half it keeps.
template <int K, int MASK, int N>
__device__ __forceinline__ void scatter_level(float (&v)[N], int lane, int& row) {
  const bool upper = lane & MASK;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float send = upper ? v[i] : v[i + K];
    const float keep = upper ? v[i + K] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
  if (upper) row += K;
}

// Reduce-scatter of KR values across a warp: after log2(KR) halving
// exchanges and a full sum over the remaining lane bits, lane l holds the
// warp's sum for row `row` (lanes 0 .. KR-1 hold every row once).
template <int KR>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[KR], int lane, int& row) {
  static_assert(KR == 16 || KR == 4 || KR == 2, "the exchanges are written for these");
  row = 0;
  if constexpr (KR == 16) {
    scatter_level<8, 1>(v, lane, row);
    scatter_level<4, 2>(v, lane, row);
    scatter_level<2, 4>(v, lane, row);
    scatter_level<1, 8>(v, lane, row);
    return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 16);
  } else {
    if constexpr (KR == 4) scatter_level<2, 1>(v, lane, row);
    scatter_level<1, KR / 2>(v, lane, row);
    float s = v[0];
#pragma unroll
    for (int o = KR; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  }
}

// Pass 1: one block per (key split, group of KR query rows), tiles of
// TILE keys; split_kernel (KR = kRows, TILE = kTile) and wide_split_kernel
// are this body.
template <typename T, int DPT, bool kContig, int KR, int TILE>
__device__ __forceinline__ void split_body(const Params& p) {
  constexpr int kRedStride = TILE * KR + 1;  // padded: the warps' sums of one
                                             // (key, row) sit in distinct banks
  extern __shared__ float dyn[];                 // qr_s [KR][Rr], kr_s [TILE][kv_r * Rr]
  __shared__ float red[kMaxWarps * kRedStride];  // per-warp score sums [warp][key][row]
  __shared__ __align__(16) float sc[KR][TILE];   // scores, then weights
  __shared__ float m_s[KR], l_s[KR], corr_s[KR];
  __shared__ int limit_s[KR], kvr_s[KR];
  __shared__ int row_s[kMaxSpan];  // arena row (page * page_size + slot) of each key

  const int split = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int b = p.prefill ? 0 : g / p.head_groups;
  int len = kContig ? p.valid : p.prefill ? p.offset + p.valid : p.lengths[b];
  len = min(len, p.nb * p.page);
  const int span = p.pages_per_split * p.page;
  const int tok0 = split * span, tok1 = min(len, tok0 + span);
  const long n_part = (long)p.groups * p.S * KR;
  const long base = ((long)g * p.S + split) * KR;
  if (tok0 >= tok1) {  // the whole split lies past the length: an empty partial
    for (int r = tid; r < KR; r += nthreads) {
      p.part[base + r] = -INFINITY;
      p.part[n_part + base + r] = 0.f;
    }
    return;
  }

  const T* rp = static_cast<const T*>(p.r);
  const T* qrp = static_cast<const T*>(p.qr);
  const T* xp = static_cast<const T*>(p.x);
  const T* krp = static_cast<const T*>(p.kr);
  const int RR = p.kv_r * p.Rr;  // roped-key elements per token
  float* qr_s = dyn;
  float* kr_s = dyn + KR * p.Rr;
  const int d0 = tid * DPT;
  const bool owns = d0 < p.Dm;

  for (int r = tid; r < KR; r += nthreads) {
    const Row w = row_of<KR>(p, g, r);
    limit_s[r] = w.alive ? w.limit : -1;  // a padding row sees no key
    kvr_s[r] = w.alive ? w.kvr : 0;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  for (int i = tid; i < KR * p.Rr; i += nthreads) {
    const Row w = row_of<KR>(p, g, i / p.Rr);
    qr_s[i] = w.alive ? to_f(qrp[(long)w.qrow * p.Rr + i % p.Rr]) : 0.f;
  }
  if constexpr (kContig) {
    for (int i = tid; i < tok1 - tok0; i += nthreads) row_s[i] = b * p.nb + tok0 + i;
  } else {
    const int* bt = p.block_table + (long)b * p.nb;
    for (int i = tid; i < tok1 - tok0; i += nthreads) {
      const int t = tok0 + i;
      row_s[i] = bt[t / p.page] * p.page + t % p.page;
    }
  }

  float rq[KR][DPT], acc[KR][DPT];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const Row w = row_of<KR>(p, g, r);
    if (owns && w.alive) {
      load_slice<T, DPT>(rp + (long)w.qrow * p.Dm + d0, rq[r]);
    } else {
#pragma unroll
      for (int e = 0; e < DPT; ++e) rq[r][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();

  for (int t0 = tok0; t0 < tok1; t0 += TILE) {
    const int n = min(TILE, tok1 - t0);
    // this thread's slice of the tile's X rows, all loads issued at once
    const int* rows = row_s + (t0 - tok0);
    float xt[TILE][DPT];
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      if (j < n && owns) {
        load_slice<T, DPT>(xp + (long)rows[j] * p.Dm + d0, xt[j]);
      } else {
#pragma unroll
        for (int e = 0; e < DPT; ++e) xt[j][e] = 0.f;
      }
    }
    for (int e = tid; e < RR; e += nthreads) {  // the tile's roped keys
      float kv[TILE];
#pragma unroll
      for (int j = 0; j < TILE; ++j) kv[j] = j < n ? to_f(krp[(long)rows[j] * RR + e]) : 0.f;
#pragma unroll
      for (int j = 0; j < TILE; ++j) kr_s[j * RR + e] = kv[j];
    }
    // score stage, first product: R . X per key, summed over the block
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      if (j < n) {  // n is the same for the whole block
        float v[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < DPT; ++e) a = fmaf(rq[r][e], xt[j][e], a);
          v[r] = a;
        }
        int row;
        const float s = warp_reduce_scatter(v, lane, row);
        if (lane < KR) red[warp * kRedStride + j * KR + row] = s;
      }
    }
    __syncthreads();
    // scores: the warps' sums and the roped term, one warp per (row, key)
    for (int i = warp; i < KR * n; i += nwarps) {
      const int r = i / n, j = i % n;
      float s = lane < nwarps ? red[lane * kRedStride + j * KR + r] : 0.f;
      const float* q = qr_s + r * p.Rr;
      const float* k = kr_s + j * RR + kvr_s[r] * p.Rr;
      for (int e = lane; e < p.Rr; e += 32) s = fmaf(q[e], k[e], s);
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc[r][j] = (t0 + j <= limit_s[r]) ? s * p.scale : -INFINITY;
    }
    __syncthreads();
    // online softmax update, one warp per row; weights past n are 0
    for (int r = warp; r < KR; r += nwarps) {
      const float s = lane < n ? sc[r][lane] : -INFINITY;
      float mt = s;
      for (int o = 16; o; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      const bool none = (m_new == -INFINITY);  // no visible key for this row yet
      const float e = (none || lane >= n) ? 0.f : expf(s - m_new);
      float sum = e;
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < TILE) sc[r][lane] = e;
      if (lane == 0) {
        const float c = none ? 1.f : expf(m_old - m_new);
        corr_s[r] = c;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * c + sum;
      }
    }
    __syncthreads();
    // value stage, second product: acc += p X on the same X slice
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      float wj[TILE];
      if constexpr (TILE == 8) {
        const float4 w0 = *reinterpret_cast<const float4*>(&sc[r][0]);
        const float4 w1 = *reinterpret_cast<const float4*>(&sc[r][4]);
        wj[0] = w0.x, wj[1] = w0.y, wj[2] = w0.z, wj[3] = w0.w;
        wj[4] = w1.x, wj[5] = w1.y, wj[6] = w1.z, wj[7] = w1.w;
      } else {
#pragma unroll
        for (int j = 0; j < TILE; ++j) wj[j] = sc[r][j];
      }
      const float c = corr_s[r];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        float a = acc[r][e] * c;
#pragma unroll
        for (int j = 0; j < TILE; ++j) a = fmaf(wj[j], xt[j][e], a);
        acc[r][e] = a;
      }
    }
  }

  if (owns) {
#pragma unroll
    for (int r = 0; r < KR; ++r) {
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        p.part[2 * n_part + (base + r) * p.Dm + d0 + e] = acc[r][e];
    }
  }
  for (int r = tid; r < KR; r += nthreads) {  // m_s / l_s are final since the last sync
    p.part[base + r] = m_s[r];
    p.part[n_part + base + r] = l_s[r];
  }
}

template <typename T, int DPT, bool kContig>
__global__ void __launch_bounds__(kMaxThreads) split_kernel(Params p) {
  split_body<T, DPT, kContig, kRows, kTile>(p);
}

template <typename T, int DPT, bool kContig, int KR, int TILE>
__global__ void __launch_bounds__(kMaxThreads) wide_split_kernel(Params p) {
  split_body<T, DPT, kContig, KR, TILE>(p);
}

// Pass 2: merge the S split partials of each query row; a split with l == 0
// saw no visible key and is skipped (a row of length 0 returns zeros). The
// first warp weighs the splits and lists the live ones; then every thread
// sums its Dm elements over that list. merge_kernel (KR = kRows) and
// wide_merge_kernel are this body.
template <typename T, int KR>
__device__ __forceinline__ void merge_body(const Params& p) {
  extern __shared__ float merge_s[];  // weight [S], then live split index [S]
  __shared__ float den_s;
  __shared__ int n_live;
  const int r = blockIdx.x, g = blockIdx.y;
  const Row w = row_of<KR>(p, g, r);
  if (!w.alive) return;
  const long n_part = (long)p.groups * p.S * KR;
  const long base = (long)g * p.S * KR + r;  // split s at base + s * KR
  float* wts = merge_s;
  int* live = reinterpret_cast<int*>(merge_s + p.S);
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = -INFINITY;
    for (int s = lane; s < p.S; s += 32)
      if (p.part[n_part + base + (long)s * KR] > 0.f)
        M = fmaxf(M, p.part[base + (long)s * KR]);
    for (int o = 16; o; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float den = 0.f;
    int count = 0;
    for (int s0 = 0; s0 < p.S; s0 += 32) {
      const int s = s0 + lane;
      const float l = s < p.S ? p.part[n_part + base + (long)s * KR] : 0.f;
      const bool on = l > 0.f;
      const float wt = on ? expf(p.part[base + (long)s * KR] - M) : 0.f;
      den = fmaf(wt, l, den);
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on) {
        const int k = count + __popc(mask & ((1u << lane) - 1u));
        live[k] = s;
        wts[k] = wt;
      }
      count += __popc(mask);
    }
    for (int o = 16; o; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) {
      den_s = den;
      n_live = count;
    }
  }
  __syncthreads();
  const float den = den_s;
  const int nl = n_live;
  T* op = static_cast<T*>(p.out) + (long)w.qrow * p.Dm;
  const float* acc = p.part + 2 * n_part + base * p.Dm;
  for (int d = threadIdx.x; d < p.Dm; d += blockDim.x) {
    float num = 0.f;
#pragma unroll 4
    for (int k = 0; k < nl; ++k) num = fmaf(wts[k], acc[(long)live[k] * KR * p.Dm + d], num);
    op[d] = from_f<T>(den > 0.f ? num / den : 0.f);
  }
}

template <typename T>
__global__ void merge_kernel(Params p) {
  merge_body<T, kRows>(p);
}

template <typename T, int KR>
__global__ void wide_merge_kernel(Params p) {
  merge_body<T, KR>(p);
}

// KR rows and TILE keys per block: kRows and kTile up to Dm 2048 (the
// kernels' old names), fewer beyond (see the note at the top).
template <typename T, int DPT, bool kContig, int KR, int TILE>
int launch(Params p, int threads, cudaStream_t stream) {
  void (*split)(Params);
  void (*merge)(Params);
  if constexpr (KR == kRows && TILE == kTile) {
    split = split_kernel<T, DPT, kContig>;
    merge = merge_kernel<T>;
  } else {
    split = wide_split_kernel<T, DPT, kContig, KR, TILE>;
    merge = wide_merge_kernel<T, KR>;
  }
  const size_t dyn = sizeof(float) * ((size_t)KR * p.Rr + (size_t)TILE * p.kv_r * p.Rr);
  if (dyn > kSmemOptIn) return cudaErrorInvalidValue;
  if (dyn > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dyn);
    if (err != cudaSuccess) return err;
  }
  split<<<dim3(p.S, p.groups), threads, dyn, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge<<<dim3(KR, p.groups), 256, (sizeof(float) + sizeof(int)) * p.S, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kMaxDm = 8192;

// Elements of Dm per thread: the block has Dm / DPT threads (at most 512).
inline int dpt_of(int Dm) {
  return Dm <= 512 ? 1 : Dm <= 1024 ? 2 : Dm <= 2048 ? 4 : Dm <= 4096 ? 8 : 16;
}

// Query rows per block: kRows up to DPT 4, then 4 (DPT 8) and 2 (DPT 16).
inline int rows_of(int dpt) { return dpt <= 4 ? kRows : dpt == 8 ? 4 : 2; }

template <typename T, bool kContig>
int launch_dpt(int dpt, Params p, int threads, cudaStream_t s) {
  switch (dpt) {
    case 1: return launch<T, 1, kContig, kRows, kTile>(p, threads, s);
    case 2: return launch<T, 2, kContig, kRows, kTile>(p, threads, s);
    case 4: return launch<T, 4, kContig, kRows, kTile>(p, threads, s);
    case 8: return launch<T, 8, kContig, 4, 4>(p, threads, s);
    default: return launch<T, 16, kContig, 2, 2>(p, threads, s);
  }
}

// kContig: contiguous arenas (decomposed_decode.cu); the paged kernels
// instantiate the default.
template <bool kContig = false>
int dispatch(int is_bf16, Params p, void* stream) {
  if (p.H < 1 || p.Dm < 1 || p.Rr < 0 || p.page < 1 || p.nb < 1 ||
      p.pages_per_split < 1 || p.pages_per_split * p.page > kMaxSpan || p.Dm > kMaxDm)
    return cudaErrorInvalidValue;
  if (p.Rr > 0 && (p.kv_r < 1 || p.H % p.kv_r != 0)) return cudaErrorInvalidValue;
  if (p.Rr == 0) p.kv_r = 1;
  const int dpt = dpt_of(p.Dm);
  if (p.Dm % dpt != 0) return cudaErrorInvalidValue;
  const size_t elt = is_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(p.x) % (dpt * elt) != 0 ||
      reinterpret_cast<uintptr_t>(p.r) % (dpt * elt) != 0)
    return cudaErrorInvalidValue;
  const int threads = ((p.Dm / dpt + 31) / 32) * 32;
  const int rows = rows_of(dpt);
  p.S = (p.nb + p.pages_per_split - 1) / p.pages_per_split;
  p.head_groups = (p.H + rows - 1) / rows;
  p.groups = p.prefill ? (p.H * p.C + rows - 1) / rows : p.B * p.head_groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_dpt<__nv_bfloat16, kContig>(dpt, p, threads, s)
                 : launch_dpt<float, kContig>(dpt, p, threads, s);
}

}  // namespace decomposed_attn

// T2 attention straight over int8 CPQ code pages, for Hopper (sm_90a).
//
// The CUDA-core sweep of the port's paged CPQ kernels: the sweep route of
// B6 (paged_cpq_prefill.cu: one prompt chunk of one slot, the slot's
// earlier code pages, then the chunk's own raw K/V under a causal mask;
// float32 chunks and widths its tensor-core route does not take) and of B5
// (paged_cpq_decode.cu: one query token per request row; only at widths
// that are not multiples of 16). bf16 chunks of B6 run
// ../../paged_attn/csrc/paged_chunk.cuh; B5 at multiples of 16, and B10
// (cpq_decode.cu), run ../../flash_attn/csrc/single_query.cuh. The arena
// holds int8 codes `c8 = code - 128` (P, page, KV, D), one int32 HQE level
// per (token, kv head) (P, page, KV) and, per request slot, a float32 scale
// and zero table (L, KV, D) for K and for V. A code dequantizes to exactly
// 0 when code == 0 and to
// (code - 1) * scale[level][d] + zero[level][d] otherwise.
//
// What bounds it: device-memory traffic, now of one byte per K/V element
// plus a level word per token instead of two bytes per element. The kernels
// keep the split-and-merge design of the dense paged kernels
// (../../paged_attn/csrc/paged_attn.cuh, whose online-softmax tile update,
// partial bookkeeping and merge pass they reuse): pass 1 runs one block per
// (key split, kv head, row block); each block copies its slot's scale and
// zero tables into shared memory once, then stages every tile by loading 16
// codes per 16-byte load into registers before dequantizing any of them
// into the float tile in shared memory. Nothing dequantized ever goes back
// to device memory.
//
// Numerics follow the TPU kernels (src/repro/kernels/cpq_dequant_attn/
// kernel.py): the paged kernels round the dequantized K and V tiles to bf16
// and back to float (:112-117, :184-187), and the chunk's raw K/V tail is
// not rounded (:200-201). (kRound off, float32 tiles, was the function of
// B10's first version; the port instantiates these kernels with it on.)
// The dequantization (code - 1) * scale + zero is one fused multiply-add,
// rounded once, as XLA compiles it for the reference and as the plain
// version computes it, so no value lands on the other side of a bf16
// rounding boundary than in the plain version. The TPU kernel looks the
// level up as a one-hot product, so a level outside [0, L) gives scale =
// zero = 0; here the tables are indexed directly and such a level reads 0
// without touching memory out of bounds. That matters in the tiered engine,
// whose CPQ arm sweeps the null page 0 for the rows of the dense tier.
#pragma once

#include "../../paged_attn/csrc/paged_attn.cuh"

namespace cpq_attn {

using paged_attn::kBatch;
using paged_attn::kThreads;

struct Params {
  paged_attn::Params p;   // query/output rows, block table, lengths, partials
  const int8_t* ck;       // (P, page, KV, Dh) K codes
  const int8_t* cv;       // (P, page, KV, Dv) V codes
  const int* lk;          // (P, page, KV) K levels
  const int* lv;          // (P, page, KV) V levels
  const float* sk;        // (B or 1, L, KV, Dh) K scale of each row's slot
  const float* zk;        // (B or 1, L, KV, Dh) K zero
  const float* sv;        // (B or 1, L, KV, Dv) V scale
  const float* zv;        // (B or 1, L, KV, Dv) V zero
  int tables_per_row;     // 1: row b reads table b (decode); 0: one slot (prefill)
  int L;
  int page_splits;        // splits 0 .. page_splits-1 sweep code pages
  const void* k_raw;      // (C, KV, Dh) the chunk's raw K in q's dtype, or null
  const void* v_raw;      // (C, KV, Dv)
  int C, valid;           // chunk width; the raw tail serves cols < valid
  int vec16_codes, vec16_raw;
};

template <bool kRound>
__device__ __forceinline__ float dequant(int code8, int l, int L, const float* s_tab,
                                         const float* z_tab, int D, int d) {
  const int c = code8 + 128;
  if (c == 0 || l < 0 || l >= L) return 0.f;
  const float v = fmaf((float)(c - 1), s_tab[l * D + d], z_tab[l * D + d]);
  return kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Stage n tokens x D codes of kv head `kv` as dequantized float rows of
// stride `stride`. lvl[j] is token j's level, s_tab/z_tab the slot's
// [L][D] tables in shared memory. U is the load unit: 16 codes (rows and
// base 16-byte aligned) or one. Loads are all issued before any is used.
template <typename U, bool kRound>
__device__ __forceinline__ void stage_codes(float* dst, int stride, const int8_t* src,
                                            const int* pg, const int* lvl,
                                            const float* s_tab, const float* z_tab,
                                            int L, int t0, int n, int D, int page,
                                            int KV, int kv) {
  constexpr int per = sizeof(U);  // codes per load unit
  const int units_per_row = D / per;
  const int total = n * units_per_row;
  for (int c0 = 0; c0 < total; c0 += kBatch * kThreads) {
    U buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads + threadIdx.x;
      if (c < total) {
        const int j = c / units_per_row, tok = t0 + j;
        const int8_t* row = src + (((long)pg[j] * page + tok % page) * KV + kv) * D;
        buf[u] = reinterpret_cast<const U*>(row)[c % units_per_row];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads + threadIdx.x;
      if (c < total) {
        const int j = c / units_per_row, d0 = (c % units_per_row) * per;
        const int8_t* codes = reinterpret_cast<const int8_t*>(&buf[u]);
        float* out = dst + j * stride + d0;
#pragma unroll
        for (int e = 0; e < per; ++e)
          out[e] = dequant<kRound>(codes[e], lvl[j], L, s_tab, z_tab, D, d0 + e);
      }
    }
  }
}

template <typename T, bool kRound>
__global__ void __launch_bounds__(kThreads) split_kernel(Params c) {
  const paged_attn::Params& p = c.p;
  extern __shared__ float smem[];
  const int split = blockIdx.x, kv = blockIdx.y;
  const int nrb = (p.R + p.rows_per_block - 1) / p.rows_per_block;
  const int b = blockIdx.z / nrb;
  const int r0 = (blockIdx.z % nrb) * p.rows_per_block;
  const int nr = min(p.rows_per_block, p.R - r0);
  const int tid = threadIdx.x;
  const int Dh = p.Dh, Dv = p.Dv, tile = p.tile, rb = p.rows_per_block, L = c.L;
  const int ks = Dh + 1, vs = Dv + 1;

  float* qs = smem;                 // [rb][Dh]
  float* kt = qs + rb * Dh;         // [tile][Dh + 1]
  float* vt = kt + tile * ks;       // [tile][Dv + 1]
  float* sc = vt + tile * vs;       // [rb][tile]
  float* acc = sc + rb * tile;      // [rb][Dv]
  float* m = acc + rb * Dv;         // [rb]
  float* l = m + rb;                // [rb]
  float* corr = l + rb;             // [rb]
  int* pg = reinterpret_cast<int*>(corr + rb);  // [tile] page of each tile token
  int* lvk = pg + tile;                         // [tile] K level of each token
  int* lvv = lvk + tile;                        // [tile] V level
  float* tsk = reinterpret_cast<float*>(lvv + tile);  // [L][Dh]
  float* tzk = tsk + L * Dh;                          // [L][Dh]
  float* tsv = tzk + L * Dh;                          // [L][Dv]
  float* tzv = tsv + L * Dv;                          // [L][Dv]

  const long base = paged_attn::part_base(p, b, kv, r0, split);
  const bool raw = split >= c.page_splits;  // the prefill's raw chunk tail
  int tok0, tok1;
  if (raw) {
    tok0 = 0;
    tok1 = c.valid;
  } else {
    int len = p.lengths ? p.lengths[b] : p.len_host;
    len = min(len, p.nb * p.page);
    tok0 = split * p.pages_per_split * p.page;
    tok1 = min(len, tok0 + p.pages_per_split * p.page);
  }
  if (tok0 >= tok1) {  // nothing live in this split
    paged_attn::empty_split(p, base, nr);
    return;
  }
  paged_attn::init_rows<T>(p, qs, acc, m, l, b, kv, r0, nr);
  if (!raw) {  // the slot's tables, once per block
    const long row = c.tables_per_row ? (long)b * L : 0;
    for (int i = tid; i < L * Dh; i += kThreads) {
      const long at = ((row + i / Dh) * p.KV + kv) * Dh + i % Dh;
      tsk[i] = c.sk[at];
      tzk[i] = c.zk[at];
    }
    for (int i = tid; i < L * Dv; i += kThreads) {
      const long at = ((row + i / Dv) * p.KV + kv) * Dv + i % Dv;
      tsv[i] = c.sv[at];
      tzv[i] = c.zv[at];
    }
  }
  const int* bt = p.block_table ? p.block_table + (long)b * p.nb : nullptr;

  for (int t0 = tok0; t0 < tok1; t0 += tile) {
    const int n = min(tile, tok1 - t0);
    __syncthreads();  // the previous tile is consumed; tables and rows are visible
    if (raw) {
      // the chunk's (C, KV, D) K/V is one page of C tokens at index 0
      for (int j = tid; j < n; j += kThreads) pg[j] = 0;
      __syncthreads();
      const T* kr = static_cast<const T*>(c.k_raw);
      const T* vr = static_cast<const T*>(c.v_raw);
      if (c.vec16_raw) {
        paged_attn::stage_tile<T, uint4>(kt, ks, kr, pg, t0, n, Dh, c.C, p.KV, kv);
        paged_attn::stage_tile<T, uint4>(vt, vs, vr, pg, t0, n, Dv, c.C, p.KV, kv);
      } else {
        paged_attn::stage_tile<T, T>(kt, ks, kr, pg, t0, n, Dh, c.C, p.KV, kv);
        paged_attn::stage_tile<T, T>(vt, vs, vr, pg, t0, n, Dv, c.C, p.KV, kv);
      }
    } else {
      for (int j = tid; j < n; j += kThreads) {
        const int tok = t0 + j, page_id = bt ? bt[tok / p.page] : b * p.nb + tok;
        const long at = ((long)page_id * p.page + tok % p.page) * p.KV + kv;
        pg[j] = page_id;
        lvk[j] = c.lk[at];
        lvv[j] = c.lv[at];
      }
      __syncthreads();
      if (c.vec16_codes) {
        stage_codes<uint4, kRound>(kt, ks, c.ck, pg, lvk, tsk, tzk, L, t0, n, Dh, p.page,
                                   p.KV, kv);
        stage_codes<uint4, kRound>(vt, vs, c.cv, pg, lvv, tsv, tzv, L, t0, n, Dv, p.page,
                                   p.KV, kv);
      } else {
        stage_codes<int8_t, kRound>(kt, ks, c.ck, pg, lvk, tsk, tzk, L, t0, n, Dh, p.page,
                                    p.KV, kv);
        stage_codes<int8_t, kRound>(vt, vs, c.cv, pg, lvv, tsv, tzv, L, t0, n, Dv, p.page,
                                    p.KV, kv);
      }
    }
    __syncthreads();
    // code pages hold positions before the queries: no causal mask there;
    // the raw tail's col j is visible to chunk token (r0 + r) / G >= j
    paged_attn::attend_tile(p, qs, kt, vt, sc, acc, m, l, corr, nr, n, t0, r0,
                            raw ? 0 : -1);
  }
  __syncthreads();
  paged_attn::write_partials(p, base, nr, m, l, acc);
}

inline size_t smem_bytes(int rb, int tile, int Dh, int Dv, int L) {
  return paged_attn::smem_bytes(rb, tile, Dh, Dv) + sizeof(int) * 2 * (size_t)tile +
         sizeof(float) * 2 * (size_t)L * (Dh + Dv);
}

// Fit the row block and the token tile into the shared-memory budget.
inline bool plan(Params& c) {
  paged_attn::Params& p = c.p;
  const int Dh = p.Dh, Dv = p.Dv, L = c.L;
  const size_t budget = paged_attn::kSmemBudget;
  int rb = p.R < 16 ? p.R : 16;
  int tile = p.pages_per_split * p.page < 64 ? p.pages_per_split * p.page : 64;
  while (smem_bytes(rb, tile, Dh, Dv, L) > budget && tile > 8) tile /= 2;
  while (smem_bytes(rb, tile, Dh, Dv, L) > budget && rb > 1) rb = (rb + 1) / 2;
  while (smem_bytes(rb, tile, Dh, Dv, L) > budget && tile > 1) tile /= 2;
  p.rows_per_block = rb;
  p.tile = tile;
  return smem_bytes(rb, tile, Dh, Dv, L) <= budget;
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T, bool kRound>
int launch(Params c, cudaStream_t stream) {
  paged_attn::Params& p = c.p;
  if (p.B < 1 || p.KV < 1 || p.R < 1 || p.pages_per_split < 1 || p.nb < 1 ||
      p.page < 1 || p.Dh < 1 || p.Dv < 1 || c.L < 1 || c.page_splits < 0)
    return cudaErrorInvalidValue;
  p.S = c.page_splits + (c.k_raw ? 1 : 0);
  if (p.S < 1 || !plan(c)) return cudaErrorInvalidValue;
  c.vec16_codes = p.Dh % 16 == 0 && p.Dv % 16 == 0 && aligned16(c.ck) && aligned16(c.cv);
  c.vec16_raw = c.k_raw != nullptr && (p.Dh * sizeof(T)) % 16 == 0 &&
                (p.Dv * sizeof(T)) % 16 == 0 && aligned16(c.k_raw) && aligned16(c.v_raw);
  const int nrb = (p.R + p.rows_per_block - 1) / p.rows_per_block;
  const size_t bytes = smem_bytes(p.rows_per_block, p.tile, p.Dh, p.Dv, c.L);
  split_kernel<T, kRound><<<dim3(p.S, p.KV, p.B * nrb), kThreads, bytes, stream>>>(c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = p.Dv >= 128 ? 128 : ((p.Dv + 31) / 32) * 32;
  paged_attn::reduce_kernel<T><<<dim3(p.R, p.KV, p.B), threads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The paged kernels: tiles rounded to bf16, q and out in either type.
inline int dispatch(int is_bf16, const Params& c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, true>(c, s) : launch<float, true>(c, s);
}

}  // namespace cpq_attn

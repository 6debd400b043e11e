// Single-query decode attention, for Hopper (sm_90a).
//
// Shared device code of the port's three single-query decodes: the decode
// route of B8 (flash_decode.cu: one query token per row over the written
// prefix of a dense K/V arena, bf16 or float32), B10 (../../cpq_attn/csrc/
// cpq_decode.cu: the same over int8 CPQ codes) and B5 (../../cpq_attn/csrc/
// paged_cpq_decode.cu: one token per request row over that row's CPQ code
// pages). The element loader is a template parameter: DenseKV reads K/V
// rows, CodeKV reads code rows and their HQE levels and dequantizes in
// registers against the row's scale and zero tables, which it keeps in
// shared memory. So is the addressing of key rows: ContigRows (B8, B10:
// decode_kernel) or PagedRows (B5: paged_decode_kernel, the same body).
//
// Per (row b, kv head) the G query heads of the kv head share every key:
// query row (b, kv, g) at b * q_sb + (kv * G + g) * Dh; out (B, KV * G, Dv)
// in q's type. ContigRows: key j of row b at arena row (b * s_stride + j) *
// KV + kv, the first `len` keys of every row live. PagedRows: key j of row
// b at arena row (block_table[b, j / page] * page + j % page) * KV + kv,
// the first lengths[b] keys live (read on the device).
//
// What bounds it: the bytes of the live keys and values, read once (a few
// operations per byte). A decode of 8 rows over 575 keys moves 10-19 MB,
// 3-6 us at 3.35 TB/s, so the kernel is a latency problem: many independent
// 16-byte loads in flight, no staging copy, no second kernel. The design:
//
//   * One warp owns a run of keys of one (row, kv head). A key row is read
//     by LPR lanes, 16 bytes each (8 lanes for a 64-wide bf16 row, 4 for its
//     codes), so a warp reads 32 / LPR rows at once, and it has U such
//     batches of K and of V in flight (4; 2 where many heads fill the
//     registers) before it uses any. Dot products are summed by shuffles
//     inside each group of LPR lanes.
//   * The online softmax state (m, l) and the P.V accumulator of every query
//     head stay in registers: each lane owns the Dv slice it loaded, for the
//     keys its lane group read. The groups, then the warps (through shared
//     memory), merge once at the end.
//   * The key range is cut into splits that the wrapper sizes so the grid
//     covers the 132 SMs a few times over. Each block writes its partial; the
//     last block of a (row, kv head) to finish, counted on an atomic counter,
//     merges them and writes the output: no merge kernel. It leaves the
//     counter at zero for the next launch (launches that share a counter
//     buffer must not overlap). PagedRows plans the splits on the host from
//     the arena's capacity, nb * page, since the lengths live on the card:
//     the blocks whose split lies wholly past their row's length exit at
//     once without arriving, the row's live splits (at least one) count
//     and merge, and they arrive after one acquire-release atomic behind a
//     block barrier (paged_chunk.cuh's, whose lesson was that a
//     sequentially consistent fence in every thread costs more than a small
//     attention); each block reads its split's block-table entries once,
//     into shared memory.
//   * A block serves GMAX query heads of its kv head (more heads take more
//     blocks). Scores are exp2 of dot products with the query pre-scaled by
//     scale * log2(e).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../paged_attn/csrc/paged_chunk.cuh"

namespace single_query {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Params {
  const void* q;    // query rows in QT
  void* out;        // output rows in QT
  float* part;      // split partials: m, l (rows, splits), acc (rows, splits, Dv)
  int* counters;    // one per (b, kv, head group); zero between launches
  int B, KV, G, Dh, Dv;
  int len;          // live keys of every row
  int s_stride;     // arena rows per batch row
  int splits, split_keys;
  int head_groups;  // blocks per kv head: G / GMAX rounded up
  long q_sb;
  float scale_log2; // scale * log2(e)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dense K/V rows of element type T.
template <typename T>
struct DenseKV {
  static constexpr int kEPL = 16 / sizeof(T);  // elements per 16-byte chunk
  struct Raw {
    uint4 u;
  };
  const T* k;
  const T* v;

  __host__ __device__ size_t table_bytes(const Params&) const { return 0; }
  __device__ void setup(const Params&, int, int, float*) {}
  // chunk c of arena row `row` (zeros past the row's width or when !ok)
  __device__ Raw load(bool is_v, long row, int c, int D, bool ok) const {
    Raw r;
    r.u = make_uint4(0u, 0u, 0u, 0u);
    if (ok && c * kEPL < D)
      r.u = __ldg(reinterpret_cast<const uint4*>((is_v ? v : k) + row * D + c * kEPL));
    return r;
  }
  __device__ void to_float(bool, const Raw& r, int, int, float (&x)[kEPL]) const {
    const T* e = reinterpret_cast<const T*>(&r.u);
#pragma unroll
    for (int i = 0; i < kEPL; ++i) x[i] = to_f(e[i]);
  }
};

// int8 CPQ code rows (stored c8 = code - 128) with one int32 HQE level per
// (token, kv head) and per-row float32 scale/zero tables (B, L, KV, D): a
// code of 0 is exactly 0, any other (code - 1) * scale + zero of its level
// (one fused multiply-add, as XLA compiles the reference), a level outside
// [0, L) reads 0; with kRound the value is rounded to bf16 and back.
//
// The block's tables sit in shared memory, K scale, K zero, V scale, V zero,
// each (L, D + 16) floats. A lane dequantizes its 16 codes against 16
// scales and 16 zeros of one level, read as four float4 each. Laid out
// plainly, the four lanes of a key row would read chunks 64 bytes apart
// (two of them on the same banks) and every level row would start on the
// same bank, so a quarter-warp's reads would serialize several times over;
// instead the float4s of chunk c are stored in the order j ^ (c & 3), which
// puts a row's four lanes on four distinct bank groups, and the 16 floats
// of padding shift successive levels by half a bank cycle.
template <bool kRound>
struct CodeKV {
  static constexpr int kEPL = 16;
  static constexpr int kPad = 16;  // floats after each level row
  struct Raw {
    uint4 u;
    int lvl;  // -1: nothing loaded (reads 0)
  };
  const int8_t* ck;
  const int8_t* cv;
  const int* lk;
  const int* lv;
  const float* sk;
  const float* zk;
  const float* sv;
  const float* zv;
  int L;
  const float* tab;  // set by setup
  int dh;

  __host__ __device__ size_t table_bytes(const Params& p) const {
    return sizeof(float) * 2 * (size_t)L * (p.Dh + p.Dv + 2 * kPad);
  }
  // element d of a level row, at its swizzled place
  __device__ static int slot(int d) {
    const int c = d >> 4, j = (d >> 2) & 3;
    return c * 16 + ((j ^ (c & 3)) << 2) + (d & 3);
  }
  // the four tables of (row b, kv head), each thread's loads issued together
  __device__ void setup(const Params& p, int b, int kv, float* smem) {
    constexpr int kBatch = 8;
    tab = smem;
    dh = p.Dh;
    const int nk = 2 * L * p.Dh, n = nk + 2 * L * p.Dv;
    for (int i0 = 0; i0 < n; i0 += kBatch * kThreads) {
      float v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads + threadIdx.x;
        dst[u] = -1;
        if (i < n) {
          const bool is_v = i >= nk;
          const int D = is_v ? p.Dv : p.Dh, r = is_v ? i - nk : i;
          const int t = r / (L * D), l = (r / D) % L, d = r % D;  // table, level, channel
          const float* src = is_v ? (t ? zv : sv) : (t ? zk : sk);
          v[u] = __ldg(src + (((long)b * L + l) * p.KV + kv) * D + d);
          dst[u] = (is_v ? 2 * L * (p.Dh + kPad) : 0) + (t * L + l) * (D + kPad) + slot(d);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (dst[u] >= 0) smem[dst[u]] = v[u];
    }
  }
  __device__ Raw load(bool is_v, long row, int c, int D, bool ok) const {
    Raw r;
    r.u = make_uint4(0u, 0u, 0u, 0u);
    r.lvl = -1;
    if (ok && c * kEPL < D) {
      r.u = __ldg(reinterpret_cast<const uint4*>((is_v ? cv : ck) + row * D + c * kEPL));
      r.lvl = __ldg((is_v ? lv : lk) + row);
    }
    return r;
  }
  __device__ void to_float(bool is_v, const Raw& r, int c, int D, float (&x)[kEPL]) const {
    const bool in = r.lvl >= 0 && r.lvl < L;
    const float* side = is_v ? tab + 2 * L * (dh + kPad) : tab;
    const int at = (in ? r.lvl : 0) * (D + kPad) + c * 16;
    const float4* s4 = reinterpret_cast<const float4*>(side + at);
    const float4* z4 = reinterpret_cast<const float4*>(side + L * (D + kPad) + at);
    const int8_t* code = reinterpret_cast<const int8_t*>(&r.u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 sc = s4[j ^ (c & 3)], zr = z4[j ^ (c & 3)];
      const float sj[4] = {sc.x, sc.y, sc.z, sc.w}, zj[4] = {zr.x, zr.y, zr.z, zr.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cc = code[4 * j + k] + 128;
        const float y = (in && cc != 0) ? fmaf((float)(cc - 1), sj[k], zj[k]) : 0.f;
        x[4 * j + k] = kRound ? __bfloat162float(__float2bfloat16_rn(y)) : y;
      }
    }
  }
};

// Key rows of contiguous arenas (B8's decode route, B10).
struct ContigRows {
  static constexpr bool kPaged = false;
};

// Key rows of a block-paged arena (B5); the null page is 0.
struct PagedRows {
  static constexpr bool kPaged = true;
  const int* block_table;  // (B, nb)
  const int* lengths;      // (B,)
  int page, nb;
};

// One block per (split, kv head x head group, row b). QT: q and out; DP:
// Dh and Dv padded to a power of two; GMAX query heads per block.
template <class Rows, class KVL, typename QT, int DP, int GMAX>
__device__ __forceinline__ void decode_body(const Params& p, KVL& kvl, const Rows& rows) {
  constexpr int EPL = KVL::kEPL;
  constexpr int NCH = DP / EPL;                      // 16-byte chunks per padded row
  constexpr int LPR = NCH < 32 ? NCH : 32;           // lanes per key row
  constexpr int CPL = NCH / LPR;                     // chunks per lane
  constexpr int RPW = 32 / LPR;                      // key rows per warp batch
  constexpr int U = GMAX * CPL * EPL > 32 ? 2 : 4;   // batches in flight
  constexpr int KPI = RPW * U;                       // keys per warp iteration
  using Raw = typename KVL::Raw;
  extern __shared__ __align__(16) float smem[];      // loader tables, then warp partials
  __shared__ int last_s;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kv = blockIdx.y / p.head_groups;
  const int g0 = (blockIdx.y % p.head_groups) * GMAX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPR, c0 = lane % LPR;
  int len = p.len, nsplit = p.splits;  // the row's live keys and splits
  if constexpr (Rows::kPaged) {
    len = min(__ldg(rows.lengths + b), rows.nb * rows.page);
    nsplit = max(1, (len + p.split_keys - 1) / p.split_keys);
    if (split >= nsplit) return;  // the split lies wholly past the row's length
  }
  const int k0 = split * p.split_keys, k1 = min(len, k0 + p.split_keys);

  // this lane's slices of the query rows, pre-scaled (loaded while the
  // loader's tables come in)
  const QT* qp = static_cast<const QT*>(p.q) + b * p.q_sb + (long)kv * p.G * p.Dh;
  float q[GMAX][CPL][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = (c0 + cc * LPR) * EPL + e;
        q[g][cc][e] = (g0 + g < p.G && d < p.Dh)
                          ? to_f(qp[(long)(g0 + g) * p.Dh + d]) * p.scale_log2 : 0.f;
      }
  kvl.setup(p, b, kv, smem);
  float* wpart = smem + kvl.table_bytes(p) / sizeof(float);  // [kWarps][GMAX][DP + 2]
  // PagedRows: the physical pages of the split's keys, from page pg0 on
  int* pages_s = reinterpret_cast<int*>(wpart + kWarps * GMAX * (DP + 2));
  int pg0 = 0;
  if constexpr (Rows::kPaged) {
    pg0 = k0 / rows.page;
    const int npg = k1 > k0 ? (k1 - 1) / rows.page - pg0 + 1 : 0;
    const int* bt = rows.block_table + (long)b * rows.nb + pg0;
    for (int i = tid; i < npg; i += kThreads) pages_s[i] = __ldg(bt + i);
  }
  __syncthreads();
  float m[GMAX], l[GMAX], acc[GMAX][CPL][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][cc][e] = 0.f;
  }

  for (int base = k0 + warp * KPI; base < k1; base += kWarps * KPI) {
    Raw kr[U][CPL], vr[U][CPL];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every load of the iteration first
      const int j = base + u * RPW + grp;
      live[u] = j < k1;
      long row;
      if constexpr (Rows::kPaged) {
        row = 0;  // past the split: no page looked up, nothing loaded
        if (live[u])
          row = ((long)pages_s[j / rows.page - pg0] * rows.page + j % rows.page) * p.KV + kv;
      } else {
        row = ((long)b * p.s_stride + j) * p.KV + kv;
      }
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        kr[u][cc] = kvl.load(false, row, c0 + cc * LPR, p.Dh, live[u]);
        vr[u][cc] = kvl.load(true, row, c0 + cc * LPR, p.Dv, live[u]);
      }
    }
    float s[U][GMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[CPL][EPL];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) kvl.to_float(false, kr[u][cc], c0 + cc * LPR, p.Dh, kf[cc]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot = fmaf(q[g][cc][e], kf[cc][e], dot);
#pragma unroll
        for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][g] = live[u] ? dot : -INFINITY;
      }
    }
    // online softmax over the U keys of this lane group, then P.V
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float ms = mx == -INFINITY ? 0.f : mx;  // no live key yet: all weights 0
      const float corr = exp2f(m[g] - ms);
      m[g] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = exp2f(s[u][g] - ms);
        sum += s[u][g];
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][cc][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[CPL][EPL];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) kvl.to_float(true, vr[u][cc], c0 + cc * LPR, p.Dv, vf[cc]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][cc][e] = fmaf(s[u][g], vf[cc][e], acc[g][cc][e]);
    }
  }

  // merge the lane groups of the warp (lanes with the same chunks)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float ws = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mx);
      const float wo = mo == -INFINITY ? 0.f : exp2f(mo - mx);
      m[g] = mx;
      l[g] = l[g] * ws + lo * wo;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][cc][e], o);
          acc[g][cc][e] = acc[g][cc][e] * ws + ao * wo;
        }
    }
  }
  // then the warps, through shared memory: [warp][g] = (m, l, acc[DP])
  constexpr int W = DP + 2;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float* w = wpart + (warp * GMAX + g) * W;
      if (c0 == 0) {
        w[0] = m[g];
        w[1] = l[g];
      }
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = (c0 + cc * LPR) * EPL + e;
          if (d < DP) w[2 + d] = acc[g][cc][e];
        }
    }
  }
  __syncthreads();

  const int nrow = min(GMAX, p.G - g0);
  const long row0 = ((long)b * p.KV + kv) * p.G + g0;  // first output row of the block
  QT* op = static_cast<QT*>(p.out);
  const long n_rows = (long)p.B * p.KV * p.G * p.splits;
  for (int i = tid; i < nrow * p.Dv; i += kThreads) {
    const int g = i / p.Dv, d = i % p.Dv;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wpart[(w * GMAX + g) * W]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* x = wpart + (w * GMAX + g) * W;
      if (x[1] > 0.f) {
        const float wt = exp2f(x[0] - M);
        num = fmaf(wt, x[2 + d], num);
        den = fmaf(wt, x[1], den);
      }
    }
    if (nsplit == 1) {
      op[(row0 + g) * p.Dv + d] = from_f<QT>(den > 0.f ? num / den : 0.f);
    } else {
      const long at = (row0 + g) * p.splits + split;
      if (d == 0) {
        p.part[at] = M;
        p.part[n_rows + at] = den;
      }
      p.part[2 * n_rows + at * p.Dv + d] = num;
    }
  }
  if (nsplit == 1) return;

  // the last block of this (row, kv head, head group) merges the splits
  int* counter = p.counters + (long)b * gridDim.y + blockIdx.y;
  if constexpr (Rows::kPaged) {
    __syncthreads();  // the block's partial stores precede thread 0's release
    if (tid == 0) last_s = paged_chunk::atomic_add_acq_rel(counter, 1) == nsplit - 1;
    __syncthreads();
    if (!last_s) return;
  } else {
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(counter, 1) == nsplit - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
  }
  for (int i = tid; i < nrow * p.Dv; i += kThreads) {
    const int g = i / p.Dv, d = i % p.Dv;
    const long at = (row0 + g) * p.splits;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      if (__ldcg(p.part + n_rows + at + s) > 0.f) M = fmaxf(M, __ldcg(p.part + at + s));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ls = __ldcg(p.part + n_rows + at + s);
      if (ls > 0.f) {
        const float wt = exp2f(__ldcg(p.part + at + s) - M);
        num = fmaf(wt, __ldcg(p.part + 2 * n_rows + (at + s) * p.Dv + d), num);
        den = fmaf(wt, ls, den);
      }
    }
    op[(row0 + g) * p.Dv + d] = from_f<QT>(den > 0.f ? num / den : 0.f);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <class KVL, typename QT, int DP, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_kernel(Params p, KVL kvl) {
  decode_body<ContigRows, KVL, QT, DP, GMAX>(p, kvl, ContigRows{});
}

template <class KVL, typename QT, int DP, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p, KVL kvl,
                                                                PagedRows rows) {
  decode_body<PagedRows, KVL, QT, DP, GMAX>(p, kvl, rows);
}

// Launch with GMAX heads per block (G up to GMAX in one block, more in
// head groups) and Dh, Dv padded to DP.
template <class Rows, class KVL, typename QT, int DP, int GMAX>
int launch_g(Params p, const KVL& kvl, const Rows& rows, cudaStream_t stream) {
  p.head_groups = (p.G + GMAX - 1) / GMAX;
  size_t bytes = kvl.table_bytes(p) + sizeof(float) * kWarps * GMAX * (DP + 2);
  if constexpr (Rows::kPaged) bytes += sizeof(int) * (p.split_keys / rows.page + 2);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(p.splits, p.KV * p.head_groups, p.B);
  if constexpr (Rows::kPaged) {
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<KVL, QT, DP, GMAX>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
      if (err != cudaSuccess) return err;
    }
    paged_decode_kernel<KVL, QT, DP, GMAX><<<grid, kThreads, bytes, stream>>>(p, kvl, rows);
  } else {
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(decode_kernel<KVL, QT, DP, GMAX>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
      if (err != cudaSuccess) return err;
    }
    decode_kernel<KVL, QT, DP, GMAX><<<grid, kThreads, bytes, stream>>>(p, kvl);
  }
  return cudaGetLastError();
}

// One head a block (MHA), or 4, or kMaxG, the most heads a block takes
// (the int8 loader's registers allow 4, the dense loader's 8).
template <class Rows, class KVL, typename QT, int DP, int kMaxG>
int launch_dp(const Params& p, const KVL& kvl, const Rows& rows, cudaStream_t stream) {
  if (p.G == 1) return launch_g<Rows, KVL, QT, DP, 1>(p, kvl, rows, stream);
  if (p.G <= 4 || kMaxG == 4) return launch_g<Rows, KVL, QT, DP, 4>(p, kvl, rows, stream);
  return launch_g<Rows, KVL, QT, DP, kMaxG>(p, kvl, rows, stream);
}

// Dh and Dv multiples of the loader's chunk up to 256, padded to a power of
// two from 32; the counters hold B * KV * ceil(G / kMaxG) zeros or more.
// PagedRows: p.len and p.s_stride are the capacity nb * page, which the
// splits cover.
template <class KVL, typename QT, int kMaxG, class Rows = ContigRows>
int launch(Params p, const KVL& kvl, void* stream, const Rows& rows = Rows{}) {
  constexpr int EPL = KVL::kEPL;
  if (p.B < 1 || p.KV < 1 || p.G < 1 || p.len < 0 || p.s_stride < p.len ||
      p.splits < 1 || p.split_keys < 1 || (long)p.splits * p.split_keys < p.len ||
      p.Dh < 1 || p.Dv < 1 || p.Dh % EPL || p.Dv % EPL || p.Dh > 256 || p.Dv > 256)
    return cudaErrorInvalidValue;
  if constexpr (Rows::kPaged) {
    if (rows.page < 1 || rows.nb < 1 || p.len != rows.nb * rows.page) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = p.Dh > p.Dv ? p.Dh : p.Dv;
  if (D <= 32) return launch_dp<Rows, KVL, QT, 32, kMaxG>(p, kvl, rows, s);
  if (D <= 64) return launch_dp<Rows, KVL, QT, 64, kMaxG>(p, kvl, rows, s);
  if (D <= 128) return launch_dp<Rows, KVL, QT, 128, kMaxG>(p, kvl, rows, s);
  return launch_dp<Rows, KVL, QT, 256, kMaxG>(p, kvl, rows, s);
}

}  // namespace single_query

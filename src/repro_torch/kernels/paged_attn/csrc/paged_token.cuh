// Paged single-token decode on a ring of asynchronous copies, bf16 or
// float32: the "ring" route of B1 (paged_decode.cu) in the port's kernel
// table. Head widths that are not multiples of 16 (or past 256) stay on the
// CUDA-core sweep of paged_attn.cuh, which this header leaves untouched (B2's
// and B8's float32 routes share it).
//
// Replaces the JAX package's Pallas TPU kernel `paged_flash_decode_fwd`
// (src/repro/kernels/flash_attn/kernel.py:223, body `_paged_decode_kernel`).
// One query token per request row b attends the row's live keys through its
// block table: q (B, 1, H, Dh), arenas (P, page, KV, Dh|Dv), block_table
// (B, nb) int32, lengths (B,) int32 -> out (B, 1, H, Dv) in q's type. The G
// = H / KV query heads of a kv head share every key it loads.
//
// What bounds it: latency. At the served shape (qwen1.5-0.5b: 8 rows of
// 64-576 keys over 64 pages of 16, KV = H = 16, Dh = Dv = 64, bf16) a call
// moves at most ~9.6 MB (2.9 us at 3.35 TB/s) and does 2 operations a byte:
// tensor cores buy nothing at G = 1. The sweep it replaces spent 15 us in a
// chain of dependent round trips (the length, then the block table, then
// one 64-key tile at a time behind block barriers, then float32 partials in
// device memory and a second kernel to merge them). This design keeps one
// launch, no partials in device memory and two round trips before the
// first score:
//
//   * one block per unit of work, a (row b, kv head) with up to GMAX of its
//     query heads (more heads take more blocks). At the served shape that
//     is 8 x 16 = 128 blocks for the card's 132 SMs, each of which holds
//     its whole row in flight: a unit's keys are cut across blocks only
//     where the units are too few to fill the card (../ops.py decode_plan,
//     from B * KV and the capacity nb * page, since the lengths live on the
//     card). Such blocks are the ranks of one thread-block cluster (at most
//     8), which take the unit's 16-key tiles in turn and merge through
//     distributed shared memory: no second launch, no atomic counter.
//     (Measured on an H100, PERF.md section 6: two ranks a unit at the
//     served shape, 256 blocks of 8 warps two an SM, were slower than one
//     block of 16 warps a unit);
//   * round trip 1: the row's length, its block-table row (staged in
//     shared memory; entries past the length are never used) and each
//     lane's query slices, all issued together. Round trip 2: every warp
//     issues 16-byte cp.async copies of its first kStages tiles of K and V
//     (kKeys keys each: 192 KB in flight a block at Dh 64 in bf16) straight
//     into its own ring of shared memory, then consumes a tile while the
//     next ones arrive and refills the stage it freed. A warp waits only on
//     its own copies (cp.async.wait_group, then __syncwarp): no block
//     barrier in the key loop. (Measured on an H100, PERF.md section 6: bulk
//     copies by the Tensor Memory Accelerator, one a key row or two a tile
//     through tensor maps of the arenas, were no faster: an SM's share of
//     the bytes, not the copy instruction, sets the time);
//   * compute in registers out of shared memory: a key row is read by LPR
//     lanes, 16 bytes each (8 lanes at Dh 64 in bf16), so a warp scores
//     32 / LPR keys at once, summing each dot product by shuffles in its
//     lane group; the query is pre-scaled by scale * log2(e), so the
//     float32 online softmax uses exp2; m, l and the P.V accumulator of
//     every head stay in registers, each lane owning the Dv slice it reads.
//     The lane groups merge by shuffles, the warps once through shared
//     memory, the ranks of a cluster once through distributed shared
//     memory.
//
// Masking follows the JAX package's convention: keys at or past a row's
// length (clamped to nb * page) are never copied (their rows of a partial
// tile are zero-filled and their scores masked), so the null page 0 is
// never read; a row of length 0 returns zeros. The columns past Dh and Dv
// (at widths below the padded one) are zero-filled too. The kernel keeps no
// state between launches.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_chunk.cuh"

namespace paged_token {

namespace cg = cooperative_groups;
using paged_chunk::cp_async16;
using paged_chunk::cp_commit;
using paged_chunk::cp_wait;

constexpr int kKeys = 16;                // keys per tile: a warp's unit of copy and compute
constexpr int kStages = 3;               // tiles of a warp in flight
constexpr int kRingBytes = 192 * 1024;   // a block's ring: W warps x kStages tiles
constexpr int kMaxWarps = 16;
constexpr int kMaxCluster = 8;           // ranks of a unit (portable cluster size)
constexpr int kMaxPages = 4096;          // block-table entries a block stages
constexpr int kMaxHeadDim = 256;

struct Params {
  const void* q;            // (B, 1, H, Dh)
  const void* k;            // (P, page, KV, Dh)
  const void* v;            // (P, page, KV, Dv)
  void* out;                // (B, 1, H, Dv)
  const int* block_table;   // (B, nb); 0 = the null page
  const int* lengths;       // (B,)
  int B, KV, G, Dh, Dv, page, nb;
  int cs;                   // ranks (blocks) per unit: the cluster size
  int head_groups;          // blocks per kv head along y: ceil(G / GMAX)
  float scale_log2;         // scale * log2(e)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 8 (bf16) or 4 (float32) elements of one 16-byte chunk, as floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) x[i] = to_f(e[i]);
}

// The compile-time layout of element type T at padded head width DP.
template <typename T, int DP>
struct Shape {
  static constexpr int EPL = 16 / sizeof(T);         // elements per 16-byte chunk
  static constexpr int NCH = DP / EPL;               // chunks per key row
  static constexpr int LPR = NCH < 32 ? NCH : 32;    // lanes per key row
  static constexpr int CPL = NCH / LPR;              // chunks per lane
  static constexpr int RPW = 32 / LPR;               // key rows a warp reads at once
  static constexpr int U = 16 / RPW < 4 ? 16 / RPW : 4;  // keys per lane group a step
  static constexpr int STEPS = kKeys / (RPW * U);    // steps per tile
  static constexpr int TILE = 2 * kKeys * DP * (int)sizeof(T);  // K then V, bytes
  static constexpr int FIT = kRingBytes / (kStages * TILE);
  static constexpr int W = FIT > kMaxWarps ? kMaxWarps : FIT < 2 ? 2 : FIT;  // warps
  static_assert(NCH >= 2 && STEPS * RPW * U == kKeys && (kKeys * NCH) % 32 == 0,
                "whole tiles of whole chunks");
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // acquire
}

// shared memory: the ring [W][kStages][K, V][kKeys][DP] T (each warp's
// stages, which at the end hold the warp's partial), the staged block-table
// row [nb] int, then the block's partial [GMAX][DP + 2] float (m, l, acc)
// that the ranks of a cluster read
template <typename T, int DP, int GMAX>
inline size_t smem_bytes(int nb) {
  using S = Shape<T, DP>;
  return (size_t)S::W * kStages * S::TILE + sizeof(int) * (size_t)((nb + 3) / 4 * 4) +
         sizeof(float) * GMAX * (DP + 2);
}

template <typename T, int DP, int GMAX>
__global__ void __launch_bounds__(32 * Shape<T, DP>::W, 1) ring_kernel(Params p) {
  using S = Shape<T, DP>;
  constexpr int W = S::W, NT = 32 * W, EPL = S::EPL, NCH = S::NCH, LPR = S::LPR;
  constexpr int CPL = S::CPL, RPW = S::RPW, U = S::U, WP = DP + 2;
  extern __shared__ __align__(16) unsigned char tok_smem[];
  int* table = reinterpret_cast<int*>(tok_smem + (size_t)W * kStages * S::TILE);
  float* bpart = reinterpret_cast<float*>(table + (p.nb + 3) / 4 * 4);

  const int rank = blockIdx.x;  // the cluster's rank: grid.x is the cluster size
  const int kv = blockIdx.y / p.head_groups, g0 = (blockIdx.y % p.head_groups) * GMAX;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPR, c0 = lane % LPR;
  const int H = p.KV * p.G;

  // round trip 1: the length, the block-table row (4 loads a thread in
  // flight before any is stored) and this lane's query slices
  const int len = max(0, min(__ldg(p.lengths + b), p.nb * p.page));
  const int* bt = p.block_table + (long)b * p.nb;
  for (int i0 = 0; i0 < p.nb; i0 += 4 * NT) {
    int e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * NT + tid;
      e[u] = i < p.nb ? __ldg(bt + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * NT + tid < p.nb) table[i0 + u * NT + tid] = e[u];
  }
  const T* qp = static_cast<const T*>(p.q) + ((long)b * H + (long)kv * p.G + g0) * p.Dh;
  uint4 qraw[GMAX][CPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int d0 = (c0 + cc * LPR) * EPL;
      qraw[g][cc] = make_uint4(0u, 0u, 0u, 0u);
      if (g0 + g < p.G && d0 < p.Dh)
        qraw[g][cc] = __ldg(reinterpret_cast<const uint4*>(qp + (long)g * p.Dh + d0));
    }
  float q[GMAX][CPL][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      unpack<T>(qraw[g][cc], q[g][cc]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[g][cc][e] *= p.scale_log2;
    }
  __syncthreads();  // the block-table row

  // this warp's tiles: tile t = rank + cs * (warp + W * i), i = 0, 1, ...
  const int ntiles = (len + kKeys - 1) / kKeys;
  const int t0 = rank + p.cs * warp, tstep = p.cs * W;
  const int nmine = t0 < ntiles ? (ntiles - t0 + tstep - 1) / tstep : 0;
  unsigned char* mine = tok_smem + (size_t)warp * kStages * S::TILE;
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);

  // round trip 2 (and every refill): tile i of this warp into stage i %
  // kStages, keys past the length and columns past Dh, Dv zero-filled; one
  // commit group per tile, empty past the warp's last tile
  auto issue = [&](int i) {
    if (i < nmine) {
      const int j0 = (t0 + i * tstep) * kKeys;
      T* sK = reinterpret_cast<T*>(mine + (i % kStages) * S::TILE);
      T* sV = sK + kKeys * DP;
#pragma unroll
      for (int u = 0; u < kKeys * NCH / 32; ++u) {
        const int idx = lane + 32 * u, r = idx / NCH, c = idx % NCH, j = j0 + r;
        const bool live = j < len;
        long row = 0;
        if (live) row = ((long)table[j / p.page] * p.page + j % p.page) * p.KV + kv;
        const bool okk = live && c * EPL < p.Dh, okv = live && c * EPL < p.Dv;
        cp_async16(sK + r * DP + c * EPL, okk ? kg + row * p.Dh + c * EPL : kg, okk);
        cp_async16(sV + r * DP + c * EPL, okv ? vg + row * p.Dv + c * EPL : vg, okv);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(s);

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

  for (int i = 0; i < nmine; ++i) {
    cp_wait<kStages - 1>();  // this lane's copies of tile i have landed
    __syncwarp();            // ... and every lane's
    const T* sK = reinterpret_cast<const T*>(mine + (i % kStages) * S::TILE);
    const T* sV = sK + kKeys * DP;
    const int j0 = (t0 + i * tstep) * kKeys;
#pragma unroll
    for (int st = 0; st < S::STEPS; ++st) {
      float s[U][GMAX];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = (st * U + u) * RPW + grp;
        float kf[CPL][EPL];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
          unpack<T>(*reinterpret_cast<const uint4*>(sK + r * DP + (c0 + cc * LPR) * EPL),
                    kf[cc]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot = fmaf(q[g][cc][e], kf[cc][e], dot);
#pragma unroll
          for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[u][g] = j0 + r < len ? dot : -INFINITY;
        }
      }
      // online softmax over this step's U keys of the lane group, then P.V
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
        const int r = (st * U + u) * RPW + grp;
        float vf[CPL][EPL];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
          unpack<T>(*reinterpret_cast<const uint4*>(sV + r * DP + (c0 + cc * LPR) * EPL),
                    vf[cc]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][cc][e] = fmaf(s[u][g], vf[cc][e], acc[g][cc][e]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
    issue(i + kStages);
  }
  cp_wait<0>();

  // merge the lane groups of the warp (lanes that own the same chunks)
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
  // then the warps, through shared memory: warp w's (m, l, acc[DP]) of each
  // head in its own (drained) ring stages
  float* wpart = reinterpret_cast<float*>(mine);
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float* w = wpart + g * WP;
      if (c0 == 0) {
        w[0] = m[g];
        w[1] = l[g];
      }
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < EPL; ++e) w[2 + (c0 + cc * LPR) * EPL + e] = acc[g][cc][e];
    }
  }
  __syncthreads();

  const int nrow = min(GMAX, p.G - g0);
  const long orow = (long)b * H + (long)kv * p.G + g0;  // the block's first output row
  T* op = static_cast<T*>(p.out);
  constexpr int WSTRIDE = kStages * S::TILE / (int)sizeof(float);  // floats between warps
  const float* w0 = reinterpret_cast<const float*>(tok_smem);
  for (int i = tid; i < nrow * p.Dv; i += NT) {
    const int g = i / p.Dv, d = i % p.Dv;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, w0[w * WSTRIDE + g * WP]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* x = w0 + w * WSTRIDE + g * WP;
      if (x[1] > 0.f) {  // a warp with no live key adds nothing
        const float wt = exp2f(x[0] - M);
        num = fmaf(wt, x[2 + d], num);
        den = fmaf(wt, x[1], den);
      }
    }
    if (p.cs == 1) {
      op[(orow + g) * p.Dv + d] = from_f<T>(den > 0.f ? num / den : 0.f);
    } else {
      bpart[g * WP + 2 + d] = num;
      if (d == 0) {
        bpart[g * WP] = M;
        bpart[g * WP + 1] = den;
      }
    }
  }
  if (p.cs == 1) return;

  // the ranks of the cluster: rank r writes the outputs e = r, r + cs, ...,
  // each from every rank's partial, read in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();  // this rank's partial is out
  cluster_wait();    // every rank's is in
  for (int e = rank + p.cs * tid; e < nrow * p.Dv; e += p.cs * NT) {
    const int g = e / p.Dv, d = e % p.Dv;
    float mc[kMaxCluster], lc[kMaxCluster], ac[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < p.cs) {
        const float* x = cluster.map_shared_rank(bpart + g * WP, c);
        mc[c] = x[0];
        lc[c] = x[1];
        ac[c] = x[2 + d];
      }
    }
    float M = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < p.cs && lc[c] > 0.f) M = fmaxf(M, mc[c]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < p.cs && lc[c] > 0.f) {
        const float wt = exp2f(mc[c] - M);
        num = fmaf(wt, ac[c], num);
        den = fmaf(wt, lc[c], den);
      }
    }
    op[(orow + g) * p.Dv + d] = from_f<T>(den > 0.f ? num / den : 0.f);
  }
  cluster_arrive();  // this rank reads no other rank's memory any more
  cluster_wait();    // no rank's memory is read any more: all may exit
}

// Launch one instantiation: grid cs x (KV * head_groups) x B, clusters of cs
// along x when cs > 1; the dynamic shared memory opted into once per
// device.
template <typename T, int DP, int GMAX>
int launch_g(Params p, cudaStream_t stream) {
  p.head_groups = (p.G + GMAX - 1) / GMAX;
  const size_t bytes = smem_bytes<T, DP, GMAX>(p.nb);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err ? err : cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(ring_kernel<T, DP, GMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, p.KV * p.head_groups, p.B);
  cfg.blockDim = dim3(32 * Shape<T, DP>::W);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, ring_kernel<T, DP, GMAX>, p);
}

// One head a block (MHA) or up to 4 (GQA; more in head groups).
template <typename T, int DP>
int launch_dp(const Params& p, cudaStream_t stream) {
  return p.G == 1 ? launch_g<T, DP, 1>(p, stream) : launch_g<T, DP, 4>(p, stream);
}

// Dh and Dv multiples of 16 up to 256, run at the next power of two from
// 16; nb at most kMaxPages; cs 1, 2, 4 or 8; q, k, v 16-byte aligned.
template <typename T>
int launch(Params p, float scale, cudaStream_t stream) {
  if (p.B < 1 || p.KV < 1 || p.G < 1 || p.page < 1 || p.nb < 1 || p.nb > kMaxPages ||
      p.Dh < 16 || p.Dv < 16 || p.Dh % 16 || p.Dv % 16 || p.Dh > kMaxHeadDim ||
      p.Dv > kMaxHeadDim || (p.cs != 1 && p.cs != 2 && p.cs != 4 && p.cs != 8) ||
      reinterpret_cast<uintptr_t>(p.q) % 16 || reinterpret_cast<uintptr_t>(p.k) % 16 ||
      reinterpret_cast<uintptr_t>(p.v) % 16)
    return cudaErrorInvalidValue;
  p.scale_log2 = scale * 1.4426950408889634f;
  const int D = p.Dh > p.Dv ? p.Dh : p.Dv;
  if (D <= 16) return launch_dp<T, 16>(p, stream);
  if (D <= 32) return launch_dp<T, 32>(p, stream);
  if (D <= 64) return launch_dp<T, 64>(p, stream);
  if (D <= 128) return launch_dp<T, 128>(p, stream);
  return launch_dp<T, 256>(p, stream);
}

}  // namespace paged_token

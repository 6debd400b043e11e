// Chunked paged T1 prefill on the tensor cores, bf16: the tensor-core route
// of B4 (paged_decomposed_prefill.cu) in the port's kernel table. Float32
// chunks (TF32 would miss the float32 gate), and the widths this route does
// not take (d_model not a multiple of 8 or past 1024, a roped slice not a
// multiple of 8 or past 64), stay on the CUDA-core sweep of
// paged_decomposed.cuh, which this header leaves untouched (B3 and B9 share
// it).
//
// Replaces, for bf16, the JAX package's Pallas TPU kernel
// `paged_decomposed_prefill_fwd` (src/repro/kernels/decomposed_attn/
// kernel.py:187, body `_paged_prefill_kernel` :129). The C queries of one
// admission chunk of one slot attend the slot's X pages [0, end), end =
// offset + valid: r (C, H, Dm) = q_nope W_K^T, q_rope (C, H, Rr), x_pages
// (P, page, Dm), kr_pages (P, page, kv_r, Rr), block_row (nb,) -> P
// (C, H, Dm), row (h, i) stored at i * H + h. Row (h, i) sees position pos
// iff pos < end and pos <= offset + i, with the score
//
//   s = (R . X[pos] + q_rope . k_rope[pos, roped group of h]) * scale
//
// and P = softmax(s) X; the caller applies W_V.
//
// What bounds it: at the served shape (qwen1.5-0.5b: C = 16, H = 16, Dm =
// 1024, kv_r = 16, Rr = 32, up to 512 live keys) a call moves at most 1.1 MB
// (0.3 us at 3.35 TB/s) and does up to 1.1 GFLOP (1.1 us at the bf16
// tensor-core peak); the float32 sweep of paged_decomposed.cuh needs 4 us
// for those flops alone and took 52 us. The two products are flash
// attention with a head width of Dm over keys = values = X, which mma.sync
// computes here:
//
//   * one block per (key split, tile of 16 query rows). A tile's rows share
//     one roped-key group: a group's rows are taken head-major, as the TPU
//     kernel orders them, and its last tile is padded (at C = 16 a tile is
//     one head's chunk; at C = 8 half of it is padding);
//   * the block's 16 warps split Dm: warp w owns columns [w DPW, (w+1) DPW)
//     (DPW = 16, 32 or 64 by width) of R, held in registers as mma A
//     fragments, and of the float32 accumulator O; the roped term is one
//     more k16 step per 16 roped columns, on the first warps;
//   * tiles of 32 keys of X (and of the group's roped keys) come through
//     the slot's block row by 16-byte cp.async, double-buffered, rows padded
//     by 16 bytes so ldmatrix is free of bank conflicts. One tile in shared
//     memory feeds both products (S = R X^T by ldmatrix, O += P X by
//     ldmatrix.trans), so X crosses from L2 once per block for both;
//   * the warps' partial scores (16 rows x 32 keys each) meet in shared
//     memory, where warp r takes row r and lane k key k: the sum, the scale,
//     the causal mask and the float32 online softmax. P enters the value
//     product as two bf16 terms, hi + lo: rounded to one bf16 it would move
//     outputs near 4 by a bf16 step of theirs, past the 2e-2 gate. The row
//     sums stay float32;
//   * the wrapper sizes the splits (kernels/decomposed_attn/ops.py), at
//     most kMaxSplits. A row tile's splits are one thread-block cluster:
//     each block stages its partial (m, l and the unnormalized O of its 16
//     rows) in its own shared memory, and after a cluster barrier every
//     block merges a slice of the columns, reading the others' partials
//     through distributed shared memory. No partial goes to device memory,
//     and no block waits for a last one to merge alone (a merge through
//     global memory, behind an atomic counter, cost this kernel more than
//     its keys: PERF.md, section 6). One launch per call;
//   * keys at or past the tile's last visible key are never loaded (so the
//     null page is never read); a split wholly past them loads no key and
//     only joins its cluster's merge.
#pragma once

#include <cooperative_groups.h>

#include "../../paged_attn/csrc/paged_chunk.cuh"

namespace decomposed_chunk {

namespace cg = cooperative_groups;
using paged_chunk::aligned16;
using paged_chunk::bf16;
using paged_chunk::cp_async16;
using paged_chunk::cp_commit;
using paged_chunk::cp_wait;
using paged_chunk::ldsm_x4;
using paged_chunk::ldsm_x4_trans;
using paged_chunk::mma_bf16;
using paged_chunk::pack_bf16;
using paged_chunk::smem_u32;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;          // query rows per block: one m16 tile, a softmax warp each
constexpr int kKeys = 32;          // keys per tile: a lane each in the softmax
constexpr int kLD = kKeys + 8;     // row stride of the partial scores (floats) and of P (bf16)
constexpr int kMaxDm = 1024;
constexpr int kMaxRr = 64;
constexpr int kMaxSplits = 8;      // a row tile's splits: a cluster of portable size
constexpr size_t kMaxSmem = 227 * 1024;
static_assert(kRows == kWarps && kKeys == 32 && kThreads == kKeys * 16,
              "warp r takes row r in the softmax; a tile's keys take 16 threads each");

struct Params {
  const bf16* r;         // (C, H, Dm)
  const bf16* qr;        // (C, H, Rr)
  const bf16* x;         // (P, page, Dm)
  const bf16* kr;        // (P, page, kv_r, Rr)
  const int* block_row;  // (nb,)
  bf16* out;             // (C, H, Dm)
  int C, H, kv_r, Rr, Dm, page;
  int offset, end;       // chunk token i is position offset + i; keys [0, end) are live
  int hpg, group_tiles;  // heads per roped group; row tiles per group
  int splits, split_keys;
  float scale_log2;      // scale * log2(e)
};

// Row u of roped group g (head g * hpg + u / C, chunk token u % C): its row
// in r, q_rope and out, and the last position it sees (-1: a padding row).
struct Row {
  int qrow, limit;
};
__device__ __forceinline__ Row row_of(const Params& p, int g, int u) {
  if (u >= p.hpg * p.C) return {0, -1};
  const int i = u % p.C;
  return {i * p.H + g * p.hpg + u / p.C, p.offset + i};
}

// The split's keys j0 .. j0 + 31 (zeros from s1 on, which is never read):
// 16 threads a key, each copying 16-byte chunks of its X row and, for the
// first RP / 8 of them, of the group's roped slice. chx, chr: chunks of a
// padded X row (zeros past Dm) and roped row (zeros past Rr).
__device__ __forceinline__ void load_tile(const Params& p, int g, int j0, int s1, bf16* sx,
                                          bf16* skr, int chx, int chr) {
  const int k = threadIdx.x >> 4, c0 = threadIdx.x & 15, j = j0 + k;
  const bool live = j < s1;
  const long at = live ? (long)__ldg(p.block_row + j / p.page) * p.page + j % p.page : 0;
  const int ldx = chx * 8 + 8, ldr = chr * 8 + 8;
  for (int c = c0; c < chx; c += 16) {
    const bool ok = live && c * 8 < p.Dm;
    cp_async16(sx + k * ldx + c * 8, ok ? p.x + at * p.Dm + c * 8 : p.x, ok);
  }
  if (c0 < chr) {
    const bool ok = live && c0 * 8 < p.Rr;
    cp_async16(skr + k * ldr + c0 * 8, ok ? p.kr + (at * p.kv_r + g) * p.Rr + c0 * 8 : p.kr,
               ok);
  }
}

// floats of the region that holds the warps' partial scores in the key loop
// and, before it, the tile's R and q_rope rows
__host__ __device__ inline int red_floats(int ldx, int ldr) {
  const int scores = kWarps * kRows * kLD, staged = kRows * (ldx + ldr) / 2;
  return scores > staged ? scores : staged;
}

// shared memory: X [2][kKeys][ldx] and roped keys [2][kKeys][ldr] bf16; the
// partial scores (R and q_rope before the loop); P hi and lo [kRows][kLD] bf16
inline size_t smem_bytes(int dpw, int Dm, int Rr) {
  const int ldx = (Dm + dpw - 1) / dpw * dpw + 8, ldr = (Rr + 15) / 16 * 16 + 8;
  return sizeof(bf16) * 2 * kKeys * (ldx + ldr) + sizeof(float) * red_floats(ldx, ldr) +
         sizeof(bf16) * 2 * kRows * kLD;
}

template <int DPW>
__global__ void __launch_bounds__(kThreads) chunk_kernel(Params p) {
  constexpr int KS = DPW / 16;  // k16 steps of a warp's Dm slice
  extern __shared__ __align__(16) unsigned char smem_raw[];  // 16: no more for the sweep
                                                            // kernels of this source
  __shared__ float corr_s[kRows], m_s[kRows], l_s[kRows], inv_s[kRows];
  __shared__ float wsplit[kRows][kMaxSplits];
  __shared__ int qrow_s[kRows];

  const int split = blockIdx.x, tile = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tile / p.group_tiles, u0 = (tile % p.group_tiles) * kRows;
  // the tile's rows u0 .. u0 + n - 1 are chunk tokens u % C: the last
  // position one of them sees is offset + the largest such token
  const int n = min(kRows, p.hpg * p.C - u0), i0 = u0 % p.C;
  const int imax = (n >= p.C || i0 + n > p.C) ? p.C - 1 : i0 + n - 1;
  const int kend = min(p.end, p.offset + imax + 1);
  // a split wholly past the tile's keys has none, but stays for the cluster's merge
  const int s0 = split * p.split_keys, s1 = min(kend, s0 + p.split_keys);
  const int ntiles = s1 > s0 ? (s1 - s0 + kKeys - 1) / kKeys : 0;

  const int nwa = (p.Dm + DPW - 1) / DPW;        // warps with a Dm slice
  const int chx = nwa * DPW / 8, ldx = chx * 8 + 8;
  const int rp = (p.Rr + 15) / 16 * 16, chr = rp / 8, ldr = rp + 8;
  const int rk = rp / 16;                        // warps with a roped k16 step
  const int nws = max(nwa, rk);                  // warps with partial scores
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);
  bf16* sKR = sX + 2 * kKeys * ldx;
  float* red = reinterpret_cast<float*>(sKR + 2 * kKeys * ldr);
  bf16* sR = reinterpret_cast<bf16*>(red);
  bf16* sQR = sR + kRows * ldx;
  bf16* sP = reinterpret_cast<bf16*>(red + red_floats(ldx, ldr));

  // the tile's R and q_rope rows (zeros for padding rows): a warp a row
  // (kRows == kWarps), and the first tile
  const Row me = row_of(p, g, u0 + warp);  // also the softmax row of this warp
  if (lane == 0) qrow_s[warp] = me.limit >= 0 ? me.qrow : -1;
  for (int c = lane; c < chx + chr; c += 32) {
    const bool rope = c >= chx;
    const int cc = rope ? c - chx : c, D = rope ? p.Rr : p.Dm;
    const bool ok = me.limit >= 0 && cc * 8 < D;
    const bf16* src = rope ? p.qr : p.r;
    cp_async16((rope ? sQR + warp * ldr : sR + warp * ldx) + cc * 8,
               ok ? src + (long)me.qrow * D + cc * 8 : src, ok);
  }
  load_tile(p, g, s0, s1, sX, sKR, chx, chr);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  uint32_t a[KS][4], qa[4];
  if (warp < nwa) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldsm_x4(a[kk], smem_u32(sR + (lane & 15) * ldx + warp * DPW + kk * 16 + (lane >> 4) * 8));
  }
  if (warp < rk) ldsm_x4(qa, smem_u32(sQR + (lane & 15) * ldr + warp * 16 + (lane >> 4) * 8));
  const int lim = me.limit;

  float o[DPW / 8][4];
#pragma unroll
  for (int d = 0; d < DPW / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;  // row `warp`'s running max (log2 units) and sum

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = s0 + it * kKeys, buf = it & 1;
    const bf16* tx = sX + buf * kKeys * ldx;
    const bf16* tr = sKR + buf * kKeys * ldr;
    cp_wait<0>();
    __syncthreads();  // this tile is in; every warp is past the last tile (and R's staging)
    if (it + 1 < ntiles) {
      load_tile(p, g, j0 + kKeys, s1, sX + (buf ^ 1) * kKeys * ldx,
                sKR + (buf ^ 1) * kKeys * ldr, chx, chr);
      cp_commit();
    }

    // partial scores of this warp's Dm slice (and roped step): 16 rows x 32 keys
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const int brow = (lane & 7) + (lane >> 4) * 8, bcol = ((lane >> 3) & 1) * 8;
    if (warp < nwa) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, smem_u32(tx + (np * 16 + brow) * ldx + warp * DPW + kk * 16 + bcol));
          mma_bf16(s[2 * np], a[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a[kk], bk[2], bk[3]);
        }
    }
    if (warp < rk) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(tr + (np * 16 + brow) * ldr + warp * 16 + bcol));
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }
    if (warp < nws) {
      float* w = red + warp * kRows * kLD + (lane >> 2) * kLD + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        *reinterpret_cast<float2*>(w + n * 8) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(w + 8 * kLD + n * 8) = make_float2(s[n][2], s[n][3]);
      }
    }
    __syncthreads();

    // row `warp`, key `lane`: the score, the mask, the online softmax
    {
      const float* w = red + warp * kLD + lane;
      float sv = 0.f;
      for (int ww = 0; ww < nws; ++ww) sv += w[ww * kRows * kLD];
      const int key = j0 + lane;
      sv = (key < s1 && key <= lim) ? sv * p.scale_log2 : -INFINITY;
      float mt = sv;
#pragma unroll
      for (int off = 16; off; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run, mt);
      const bool none = m_new == -INFINITY;  // no visible key for this row yet
      const float e = none ? 0.f : exp2f(sv - m_new);
      float sum = e;
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = none ? 1.f : exp2f(m_run - m_new);
      m_run = m_new;
      l_run = l_run * corr + sum;
      const bf16 eh = __float2bfloat16(e);
      sP[warp * kLD + lane] = eh;
      sP[(kRows + warp) * kLD + lane] = __float2bfloat16(e - __bfloat162float(eh));
      if (lane == 0) corr_s[warp] = corr;
    }
    __syncthreads();

    // O += P X on this warp's Dm slice, P as hi + lo
    if (warp < nwa) {
      const float ca = corr_s[lane >> 2], cb = corr_s[(lane >> 2) + 8];
#pragma unroll
      for (int d = 0; d < DPW / 8; ++d) {
        o[d][0] *= ca;
        o[d][1] *= ca;
        o[d][2] *= cb;
        o[d][3] *= cb;
      }
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t ph[4], pl[4];
        ldsm_x4(ph, smem_u32(sP + (lane & 15) * kLD + ks * 16 + (lane >> 4) * 8));
        ldsm_x4(pl, smem_u32(sP + (kRows + (lane & 15)) * kLD + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int dn = 0; dn < DPW / 16; ++dn) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, smem_u32(tx + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldx +
                                     warp * DPW + dn * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * dn], ph, bv[0], bv[1]);
          mma_bf16(o[2 * dn], pl, bv[0], bv[1]);
          mma_bf16(o[2 * dn + 1], ph, bv[2], bv[3]);
          mma_bf16(o[2 * dn + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }

  if (lane == 0) {
    m_s[warp] = m_run;
    l_s[warp] = l_run;
  }
  __syncthreads();  // every warp is past its last tile: the X buffers are free
  // the block's 16 rows go out through shared memory: P (O / l, bf16) when
  // the launch has one split, else the split's unnormalized O (float32)
  const bool whole = p.splits == 1;
  const int ra = lane >> 2, rb = ra + 8, cw = warp * DPW + (lane & 3) * 2;
  const int lds = p.Dm + 8;  // row stride of the staged rows: conflict-free fragment stores
  float* so = reinterpret_cast<float*>(sX);
  bf16* sb = sX;
  if (warp < nwa) {
    const float ia = whole && l_s[ra] > 0.f ? 1.f / l_s[ra] : 1.f;
    const float ib = whole && l_s[rb] > 0.f ? 1.f / l_s[rb] : 1.f;
#pragma unroll
    for (int d = 0; d < DPW / 8; ++d) {
      const int col = cw + d * 8;
      if (col >= p.Dm) continue;
      if (whole) {
        *reinterpret_cast<uint32_t*>(sb + ra * lds + col) = pack_bf16(o[d][0] * ia, o[d][1] * ia);
        *reinterpret_cast<uint32_t*>(sb + rb * lds + col) = pack_bf16(o[d][2] * ib, o[d][3] * ib);
      } else {
        *reinterpret_cast<float2*>(so + ra * lds + col) = make_float2(o[d][0], o[d][1]);
        *reinterpret_cast<float2*>(so + rb * lds + col) = make_float2(o[d][2], o[d][3]);
      }
    }
  }
  if (whole) {  // whole rows, 8 bf16 a thread per 16-byte store
    __syncthreads();
    const int n8 = p.Dm / 8;
    for (int i = tid; i < kRows * n8; i += kThreads) {
      const int r = i / n8, c = i % n8, qrow = qrow_s[r];
      if (qrow >= 0)
        *reinterpret_cast<uint4*>(p.out + (long)qrow * p.Dm + c * 8) =
            *reinterpret_cast<const uint4*>(sb + r * lds + c * 8);
    }
    return;
  }

  // the cluster (this row tile's splits, cluster rank = split) merges: every
  // block's rows, m and l are in its shared memory after the barrier
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {  // row `warp`'s weight of split `lane`, and 1 / the weighted sum
    float ms = -INFINITY, ls = 0.f;
    if (lane < p.splits) {
      ms = cluster.map_shared_rank(m_s, lane)[warp];
      ls = cluster.map_shared_rank(l_s, lane)[warp];
    }
    float M = ls > 0.f ? ms : -INFINITY;
#pragma unroll
    for (int off = 16; off; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float wt = ls > 0.f ? exp2f(ms - M) : 0.f;
    float den = wt * ls;
#pragma unroll
    for (int off = 16; off; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane < kMaxSplits) wsplit[warp][lane] = wt;
    if (lane == 0) inv_s[warp] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  // this block's slice of the columns, 4 at a time, every split's loads together
  const int n4 = p.Dm / 4, per = (n4 + p.splits - 1) / p.splits;
  const int q0 = split * per, nq = max(0, min(n4, q0 + per) - q0);
  for (int i = tid; i < kRows * nq; i += kThreads) {
    const int r = i / nq, q = q0 + i % nq, at = r * lds + q * 4;
    float4 x[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      x[sp] = sp < p.splits ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(so, sp) + at)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      const float w = wsplit[r][sp];
      num.x = fmaf(w, x[sp].x, num.x);
      num.y = fmaf(w, x[sp].y, num.y);
      num.z = fmaf(w, x[sp].z, num.z);
      num.w = fmaf(w, x[sp].w, num.w);
    }
    const int qrow = qrow_s[r];
    const float inv = inv_s[r];
    if (qrow >= 0)
      *reinterpret_cast<uint2*>(p.out + (long)qrow * p.Dm + q * 4) =
          make_uint2(pack_bf16(num.x * inv, num.y * inv), pack_bf16(num.z * inv, num.w * inv));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int DPW>
int launch_dpw(const Params& p, int tiles, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DPW, p.Dm, p.Rr);
  // with the kernel's static shared memory (under 1 KB) a block opts in past
  // 48 KB; the opt-in is kept per device, made once
  if (bytes > kMaxSmem - 4 * 1024) return cudaErrorInvalidValue;
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err ? err : cudaErrorInvalidDevice;
  if (bytes > 44 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(chunk_kernel<DPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  if (p.splits == 1) {
    chunk_kernel<DPW><<<dim3(1, tiles), kThreads, bytes, stream>>>(p);
    return cudaGetLastError();
  }
  // a row tile's splits form one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chunk_kernel<DPW>, p);
}

// Fill the derived fields of p and launch: Dm a multiple of 8 up to kMaxDm,
// Rr 0 or a multiple of 8 up to kMaxRr; r, q_rope, x and the roped keys
// 16-byte aligned; at most kMaxSplits splits of split_keys keys cover
// [0, end). The grid: splits x tiles blocks, tiles = kv_r * ceil(H / kv_r *
// C / 16) (kv_r = 1 without a roped term).
inline int launch(Params p, int nb, float scale, void* stream) {
  if (p.Rr == 0) p.kv_r = 1;
  if (p.C < 1 || p.H < 1 || p.kv_r < 1 || p.H % p.kv_r != 0 || p.page < 1 || nb < 1 ||
      p.Dm < 8 || p.Dm % 8 || p.Dm > kMaxDm || p.Rr < 0 || p.Rr % 8 || p.Rr > kMaxRr ||
      p.offset < 0 || p.end <= p.offset || p.end > p.offset + p.C || p.end > nb * p.page ||
      p.splits < 1 || p.splits > kMaxSplits || p.split_keys < 1 ||
      (long)p.splits * p.split_keys < p.end || !aligned16(p.r) || !aligned16(p.x) ||
      !aligned16(p.out) || (p.Rr > 0 && (!aligned16(p.qr) || !aligned16(p.kr))))
    return cudaErrorInvalidValue;
  p.hpg = p.H / p.kv_r;
  p.group_tiles = (p.hpg * p.C + kRows - 1) / kRows;
  p.scale_log2 = scale * 1.4426950408889634f;
  const int tiles = p.kv_r * p.group_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.Dm <= 256) return launch_dpw<16>(p, tiles, s);
  if (p.Dm <= 512) return launch_dpw<32>(p, tiles, s);
  return launch_dpw<64>(p, tiles, s);
}

}  // namespace decomposed_chunk

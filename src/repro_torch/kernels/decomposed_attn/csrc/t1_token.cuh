// T1 single-token decode on the tensor cores, bf16: the tensor-core route of
// B3 (paged_decomposed_decode.cu) and B9 (decomposed_decode.cu) in the
// port's kernel table. Float32 calls (TF32 would miss the float32 gate) and
// the widths this route does not take (d_model not a multiple of 8 or past
// 1024, a roped slice not a multiple of 8, more roped columns than a
// cluster's rope steps hold) stay on the CUDA-core sweep of
// paged_decomposed.cuh, which this header leaves untouched.
//
// Replaces, for bf16, the JAX package's Pallas TPU kernels
// `paged_decomposed_decode_fwd` (src/repro/kernels/decomposed_attn/
// kernel.py:244, body `_paged_kernel` :73) and `decomposed_decode_fwd`
// (:298, body `_kernel` :32). One query token per request row b attends
// the row's live keys: r (B, H, Dm) = q_nope W_K^T, q_rope (B, H, Rr), key
// j's X row (Dm) and roped row (kv_r groups of Rr) -> P (B, H, Dm), with
//
//   s = (R . X[j] + q_rope . k_rope[j, roped group of h]) * scale
//
// and P = softmax(s) X; the caller applies W_V. Where key j lies is the
// addressing policy's business, a template parameter: PagedRows (B3:
// through the row's block table, lengths on the card) or ContigRows (B9:
// row b's arena rows b * N + j, one host length).
//
// What bounds it: bytes. At the served shape (qwen1.5-0.5b: H = 16, Dm =
// 1024, kv_r = 16, Rr = 32) a key is 3072 bytes of X and roped key, read
// for 16 heads: ~21 flops a byte, far below the tensor cores' ridge. A
// static decode of 8 rows over 575 keys moves 14 MB (4.1 us at 3.35 TB/s);
// its 290 MFLOP take 4.3 us on the float32 CUDA cores, 0.3 us on the bf16
// tensor cores. The TPU kernel keeps its (H, Dm) accumulator in VMEM for
// the whole sweep; the CUDA-core sweep it replaces spread that over blocks
// of 16 keys, each writing a 16 x Dm float32 partial (more bytes than its
// keys) for a second kernel to merge. Eight rows fill few SMs if a block
// reads whole keys, and every step a block takes in turn costs latency, so:
//
//   * a row's 16 heads are one m16 mma.sync tile (H < 16 pads it, H > 16
//     takes ceil(H / 16) tiles, which read the same keys again from L2);
//   * d_model is cut over a thread-block cluster of cs = ceil(Dm / 128)
//     blocks, rank c owning X columns [128 c, 128 c + 128) and a share of
//     the roped columns (whole k16 steps), so every byte of a key is read
//     by one block of the cluster, and the keys are cut into splits of at
//     most kKeys (the wrapper plans them to fill the card: ../ops.py
//     t1_decode_plan). A block copies its slices of all its split's keys
//     at once (16-byte cp.async, as many bytes in flight as the split has)
//     and forms its partial scores S_c = R_c X_c^T + Q_c K_c^T on the
//     tensor cores. The roped term is a product with a block-diagonal A
//     operand: head h's q_rope at the columns of its roped group, zeros
//     elsewhere, so a row's heads may span kv_r groups (qwen: one each);
//   * the partial scores (16 x keys floats) are the only thing that crosses
//     blocks, once per split, as a reduce-scatter through distributed
//     shared memory: after a cluster barrier rank c sums its 1/cs of the
//     keys over all cs partials in rank order, scales and masks them, and
//     writes those scores into every rank; after a second barrier each
//     rank runs the float32 softmax over the split's keys on the same
//     scores, so every rank holds bit-identical m, l and P. Its slice of
//     O = P X (X from the slices it already holds, by ldmatrix.trans)
//     stays in registers. P enters the value product as two bf16 terms,
//     hi + lo (rounded to one bf16 it would move outputs near 4 by a bf16
//     step, past the 2e-2 gate). (Measured on an H100, PERF.md section 6:
//     a first version that swept 64-key tiles with a barrier and exchange
//     per tile spent ~6.6 us a tile in those latencies, and every rank
//     reading all cs partials took ~13-21 us for the exchange alone.)
//   * a split's cluster writes its 16 x 128 float32 slices of O with m and
//     l, and for each rank the last split to arrive, counted on one
//     acquire-release atomic of kernels/single_query.counters, merges that
//     rank's slices and leaves the counter at 0: one launch per call;
//   * PagedRows plans the splits from the capacity nb * page on the host,
//     as B5 does, since the lengths live on the card: a cluster whose
//     split lies wholly past its row's length exits at once, every block
//     of it alike (it joins no barrier and arrives on no counter). Keys at
//     or past the length are never loaded (so the null page is never
//     read): their copies zero-fill and their scores are masked. A row of
//     length 0 has one split with no key and writes zeros.
#pragma once

#include <cooperative_groups.h>

#include "../../paged_attn/csrc/paged_chunk.cuh"

namespace t1_token {

namespace cg = cooperative_groups;
using paged_chunk::aligned16;
using paged_chunk::atomic_add_acq_rel;
using paged_chunk::bf16;
using paged_chunk::cp_async16;
using paged_chunk::cp_commit;
using paged_chunk::cp_wait;
using paged_chunk::ldsm_x4;
using paged_chunk::ldsm_x4_trans;
using paged_chunk::mma_bf16;
using paged_chunk::pack_bf16;
using paged_chunk::smem_u32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;           // heads per block: one m16 tile
constexpr int kKeys = 192;          // most keys per split: 24 a warp in the score product
constexpr int kSlice = 128;         // d_model columns per block: 16 a warp in the value product
constexpr int kMaxCluster = 8;      // blocks per cluster (portable): d_model up to 1024
constexpr int kRopeSteps = 4;       // most roped k16 steps a block takes
constexpr int kMaxSplits = 1024;   // rows of up to 196608 keys
constexpr int kLDX = kSlice + 8;    // bf16 row stride of the X slices (conflict-free ldmatrix)
constexpr int kLDS = kKeys + 4;     // float row stride of the partial scores
constexpr int kLDP = kKeys + 8;     // bf16 row stride of P
constexpr int kKPT = kKeys / 16;    // softmax keys per thread (16 threads a row)
static_assert(sizeof(float) * kLDS <= sizeof(bf16) * 2 * kLDP, "the scores fit under P");
static_assert(kKeys == 24 * kWarps && kSlice == 16 * kWarps && kThreads == 16 * kRows &&
                  kKPT % 4 == 0,
              "a warp's 24 keys and 16 columns; 16 softmax threads a row, 12 keys each");

struct Params {
  const bf16* r;     // (B, H, Dm)
  const bf16* qr;    // (B, H, Rr)
  const bf16* x;     // X rows of Dm
  const bf16* kr;    // roped rows of rw = kv_r * Rr
  bf16* out;         // (B, H, Dm)
  float* part;       // m, l (units, splits, 16) each, then O (units, splits, 16, kSlice)
  int* counters;     // one per unit (row, head tile, rank); zero between launches
  int B, H, kv_r, Rr, Dm;
  int hpg, rw;       // heads per roped group; roped columns of a key
  int rc_off, rw_all;  // a model shard's first roped column in the whole call's
                       // and the whole call's roped columns (0: this call's)
  int cs, rsteps;    // cluster size; roped k16 steps per rank (of the whole call's)
  int ksl;           // keys per rank in the scores' reduce-scatter (a multiple of 4)
  int row_tiles;     // ceil(H / 16)
  int splits, split_keys;
  float scale_log2;  // scale * log2(e)
};

// Key rows of a block-paged arena (B3); the null page is 0.
struct PagedRows {
  const int* block_table;  // (B, nb)
  const int* lengths;      // (B,)
  int page, nb;
  __device__ int length(int b) const { return min(__ldg(lengths + b), nb * page); }
  __device__ long at(int b, int j) const {
    return (long)__ldg(block_table + (long)b * nb + j / page) * page + j % page;
  }
};

// Key rows of contiguous (B, N, ...) arenas with one length (B9).
struct ContigRows {
  int n, len;
  __device__ int length(int) const { return len; }
  __device__ long at(int b, int j) const { return (long)b * n + j; }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // acquire
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// bf16 row stride of the roped slices
__host__ __device__ inline int ldr_of(int rsteps) { return rsteps * 16 + 8; }

// shared memory: the split's X slices [kKeys][kLDX] and roped slices
// [kKeys][ldr] bf16, the partial scores [kRows][kLDS] float (the staged R
// slice [kRows][kLDX] and block-diagonal q_rope [kRows][ldr] bf16 before
// them), P hi and lo [2][kRows][kLDP] bf16 (the scores [kRows][kLDS] float
// before them)
inline size_t smem_bytes(int rsteps) {
  return sizeof(bf16) * kKeys * (kLDX + ldr_of(rsteps)) + sizeof(float) * kRows * kLDS +
         sizeof(bf16) * 2 * kRows * kLDP;
}

template <class Rows>
__global__ void __launch_bounds__(kThreads, 2) token_kernel(Params p, Rows rows) {
  extern __shared__ __align__(16) unsigned char t1_smem[];  // 16: no more for the sweep
                                                           // kernels of the source
  __shared__ float m_s[kRows], l_s[kRows];
  __shared__ int last_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();  // the d_model slice
  const int split = blockIdx.y, unit_row = blockIdx.z;  // unit_row = b * row_tiles + tile
  const int b = unit_row / p.row_tiles, h0 = (unit_row % p.row_tiles) * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = rows.length(b);
  const int nsplit = max(1, (len + p.split_keys - 1) / p.split_keys);
  if (split >= nsplit) return;  // past the row's length: the whole cluster leaves
  const int k0 = split * p.split_keys, nk = max(0, min(len - k0, p.split_keys));
  const int nk16 = (nk + 15) / 16 * 16;  // keys loaded (zeros past nk)
  // this rank's roped columns, placed as in the whole call: a model shard's
  // head keeps its roped term in the rank that adds it unsharded, so the
  // ranks' partial scores sum alike (columns before the shard's are zeros)
  const int c0 = rank * kSlice, rc0 = rank * p.rsteps * 16 - p.rc_off;
  const int ldr = ldr_of(p.rsteps);

  bf16* sX = reinterpret_cast<bf16*>(t1_smem);
  bf16* sKR = sX + kKeys * kLDX;
  float* sS = reinterpret_cast<float*>(sKR + kKeys * ldr);
  bf16* sR = reinterpret_cast<bf16*>(sS);  // staged before the partial scores
  bf16* sQA = sR + kRows * kLDX;
  bf16* sP = reinterpret_cast<bf16*>(sS + kRows * kLDS);

  // the tile's R slice (zeros past H and Dm); q_rope block-diagonal: head
  // h0 + i's values at the columns of its roped group, 8 columns a copy
  for (int i = tid; i < kRows * (kSlice / 8); i += kThreads) {
    const int row = i / (kSlice / 8), c = i % (kSlice / 8), h = h0 + row, col = c0 + c * 8;
    const bool ok = h < p.H && col < p.Dm;
    cp_async16(sR + row * kLDX + c * 8, ok ? p.r + ((long)b * p.H + h) * p.Dm + col : p.r,
               ok);
  }
  for (int i = tid; i < kRows * p.rsteps * 2; i += kThreads) {
    const int row = i / (p.rsteps * 2), c = i % (p.rsteps * 2), h = h0 + row;
    const int col = rc0 + c * 8;
    const bool ok = h < p.H && col >= 0 && col < p.rw && col / p.Rr == h / p.hpg;
    cp_async16(sQA + row * ldr + c * 8,
               ok ? p.qr + ((long)b * p.H + h) * p.Rr + col % p.Rr : p.qr, ok);
  }
  // the split's keys: this rank's X columns (16 threads a key, 16 bytes
  // each) and roped columns (8 threads a key)
  for (int i = tid; i < nk16 * 16; i += kThreads) {
    const int k = i >> 4, c = i & 15, col = c0 + c * 8;
    const bool ok = k < nk && col < p.Dm;
    const long at = ok ? rows.at(b, k0 + k) : 0;
    cp_async16(sX + k * kLDX + c * 8, ok ? p.x + at * p.Dm + col : p.x, ok);
  }
  for (int i = tid; i < nk16 * 8; i += kThreads) {
    const int k = i >> 3, c = i & 7, col = rc0 + c * 8;
    if (c >= 2 * p.rsteps) continue;
    const bool ok = k < nk && col >= 0 && col < p.rw;
    const long at = ok ? rows.at(b, k0 + k) : 0;
    cp_async16(sKR + k * ldr + c * 8, ok ? p.kr + at * p.rw + col : p.kr, ok);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // this rank's partial scores: warp w's keys 24 w .. 24 w + 23 as three n8
  // tiles side by side (their mma chains overlap), 16 rows each. Keys past
  // the split's are masked below, whatever their rows of shared memory hold
  const int nks = min(kSlice, p.Dm - c0 + 15) / 16;  // k16 steps of this slice with columns
  {
    uint32_t a[kSlice / 16][4], qa[kRopeSteps][4];
#pragma unroll
    for (int kk = 0; kk < kSlice / 16; ++kk)
      if (kk < nks)
        ldsm_x4(a[kk], smem_u32(sR + (lane & 15) * kLDX + kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int rs = 0; rs < kRopeSteps; ++rs)
      if (rs < p.rsteps)
        ldsm_x4(qa[rs], smem_u32(sQA + (lane & 15) * ldr + rs * 16 + (lane >> 4) * 8));
    __syncthreads();  // every warp holds its A fragments: the staging becomes the scores
    float s[3][4];
#pragma unroll
    for (int n = 0; n < 3; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // B fragments: keys brow + 8 n, a k16 step's two 8-column halves
    const int brow = warp * 24 + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < kSlice / 16; ++kk) {
      if (kk < nks) {
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          uint32_t bk[2];
          ldsm_x2(bk, smem_u32(sX + (brow + 8 * n) * kLDX + kk * 16 + bcol));
          mma_bf16(s[n], a[kk], bk[0], bk[1]);
        }
      }
    }
#pragma unroll
    for (int rs = 0; rs < kRopeSteps; ++rs) {
      if (rs < p.rsteps) {
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          uint32_t bk[2];
          ldsm_x2(bk, smem_u32(sKR + (brow + 8 * n) * ldr + rs * 16 + bcol));
          mma_bf16(s[n], qa[rs], bk[0], bk[1]);
        }
      }
    }
    float* w = sS + (lane >> 2) * kLDS + warp * 24 + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      *reinterpret_cast<float2*>(w + 8 * n) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(w + 8 * kLDS + 8 * n) = make_float2(s[n][2], s[n][3]);
    }
  }
  cluster_arrive();  // this rank's partial scores are out
  cluster_wait();    // every rank's are in

  // reduce-scatter: this rank sums its ksl keys of every row over the ranks'
  // partials in rank order, scales and masks them, and writes each score
  // into every rank's score rows (sF, which P overwrites later): each score
  // is formed once, so every rank holds the same
  float* sF = reinterpret_cast<float*>(sP);
  for (int i = tid; i < kRows * (p.ksl / 4); i += kThreads) {
    const int r = i / (p.ksl / 4), j = rank * p.ksl + (i % (p.ksl / 4)) * 4;
    if (j >= kKeys) continue;
    float4 v = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    if (j < nk) {
      const float* src = sS + r * kLDS + j;
      float4 x[kMaxCluster];
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < p.cs) x[c] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, c));
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c)
        if (c < p.cs) t.x += x[c].x, t.y += x[c].y, t.z += x[c].z, t.w += x[c].w;
      v.x = t.x * p.scale_log2;
      v.y = j + 1 < nk ? t.y * p.scale_log2 : -INFINITY;
      v.z = j + 2 < nk ? t.z * p.scale_log2 : -INFINITY;
      v.w = j + 3 < nk ? t.w * p.scale_log2 : -INFINITY;
    }
    float* dst = sF + r * kLDS + j;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < p.cs) *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, c)) = v;
  }
  cluster_arrive();  // this rank's scores are written, and it reads no partial any more
  cluster_wait();    // every rank's are: no rank touches another's memory from here on

  // row sr, keys kq .. kq + kKPT - 1: the softmax over the split; P as bf16
  // hi + lo, over the scores
  const int sr = tid >> 4, sq = tid & 15, kq = sq * kKPT;
  {
    float sv[kKPT];
#pragma unroll
    for (int q = 0; q < kKPT / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(sF + sr * kLDS + kq + 4 * q);
      sv[4 * q] = v.x, sv[4 * q + 1] = v.y, sv[4 * q + 2] = v.z, sv[4 * q + 3] = v.w;
    }
    float mt = -INFINITY;
#pragma unroll
    for (int e = 0; e < kKPT; ++e) mt = fmaxf(mt, sv[e]);
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m = nk > 0 ? mt : 0.f;  // finite: the split holds a live key
    float sum = 0.f;
    uint32_t hi[kKPT / 2], lo[kKPT / 2];
#pragma unroll
    for (int e = 0; e < kKPT; e += 2) {
      const float e0 = exp2f(sv[e] - m), e1 = exp2f(sv[e + 1] - m);
      sum += e0 + e1;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(e0, e1);
      hi[e / 2] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[e / 2] = pack_bf16(e0 - __low2float(h2), e1 - __high2float(h2));
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    __syncthreads();  // every thread holds its scores: P goes over them
#pragma unroll
    for (int q = 0; q < kKPT / 4; ++q) {
      *reinterpret_cast<uint2*>(sP + sr * kLDP + kq + 4 * q) = make_uint2(hi[2 * q], hi[2 * q + 1]);
      *reinterpret_cast<uint2*>(sP + (kRows + sr) * kLDP + kq + 4 * q) =
          make_uint2(lo[2 * q], lo[2 * q + 1]);
    }
    if (sq == 0) {
      m_s[sr] = m;
      l_s[sr] = sum;
    }
  }
  __syncthreads();  // P, m and l

  // O = P X on this warp's 16 columns, P's hi and lo terms apart
  float oh[2][4], ol[2][4];
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oh[d][e] = ol[d][e] = 0.f;
  if (c0 + warp * 16 < p.Dm) {
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      if (ks * 16 < nk) {
        uint32_t ph[4], pl[4], bv[4];
        ldsm_x4(ph, smem_u32(sP + (lane & 15) * kLDP + ks * 16 + (lane >> 4) * 8));
        ldsm_x4(pl, smem_u32(sP + (kRows + (lane & 15)) * kLDP + ks * 16 + (lane >> 4) * 8));
        ldsm_x4_trans(bv, smem_u32(sX + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLDX +
                                   warp * 16 + (lane >> 4) * 8));
        mma_bf16(oh[0], ph, bv[0], bv[1]);
        mma_bf16(ol[0], pl, bv[0], bv[1]);
        mma_bf16(oh[1], ph, bv[2], bv[3]);
        mma_bf16(ol[1], pl, bv[2], bv[3]);
      }
    }
  }
  float o[2][4];
#pragma unroll
  for (int d = 0; d < 2; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = oh[d][e] + ol[d][e];

  const int ra = lane >> 2, rb = ra + 8, cw = warp * 16 + (lane & 3) * 2;
  const long unit = (long)unit_row * p.cs + rank;
  if (nsplit == 1) {  // the whole row: P = O / l
    const float ia = l_s[ra] > 0.f ? 1.f / l_s[ra] : 0.f;
    const float ib = l_s[rb] > 0.f ? 1.f / l_s[rb] : 0.f;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int col = c0 + cw + d * 8;
      if (col >= p.Dm) continue;
      if (h0 + ra < p.H)
        *reinterpret_cast<uint32_t*>(p.out + ((long)b * p.H + h0 + ra) * p.Dm + col) =
            pack_bf16(o[d][0] * ia, o[d][1] * ia);
      if (h0 + rb < p.H)
        *reinterpret_cast<uint32_t*>(p.out + ((long)b * p.H + h0 + rb) * p.Dm + col) =
            pack_bf16(o[d][2] * ib, o[d][3] * ib);
    }
    return;
  }

  // this split's partial of the rank's columns: m, l and the unnormalized O
  const long n_units = (long)gridDim.z * p.cs, n_ml = n_units * p.splits * kRows;
  const long base = (unit * p.splits + split) * kRows;
  if (tid < kRows) {
    p.part[base + tid] = m_s[tid];
    p.part[n_ml + base + tid] = l_s[tid];
  }
  float* po = p.part + 2 * n_ml + base * kSlice;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int col = cw + d * 8;
    *reinterpret_cast<float2*>(po + ra * kSlice + col) = make_float2(o[d][0], o[d][1]);
    *reinterpret_cast<float2*>(po + rb * kSlice + col) = make_float2(o[d][2], o[d][3]);
  }
  int* counter = p.counters + unit;
  __syncthreads();  // the block's partial stores precede thread 0's release
  if (tid == 0) last_s = atomic_add_acq_rel(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;

  // the last split of this rank merges: row sr, columns 8 sq .. 8 sq + 7,
  // one pass over the splits with a running max (their loads overlap)
  const long at0 = unit * p.splits * kRows + sr;  // split s at at0 + s * kRows
  float M = -INFINITY, num[8], den = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) num[e] = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsplit; ++s) {
    const float ls = __ldcg(p.part + n_ml + at0 + s * kRows);
    const float ms = __ldcg(p.part + at0 + s * kRows);
    const float4* src =
        reinterpret_cast<const float4*>(p.part + 2 * n_ml + (at0 + s * kRows) * kSlice + sq * 8);
    const float4 x0 = __ldcg(src), x1 = __ldcg(src + 1);
    if (ls > 0.f) {  // a split with no live key for the row adds nothing
      const float Mn = fmaxf(M, ms), co = exp2f(M - Mn), wt = exp2f(ms - Mn);
      M = Mn;
      den = fmaf(wt, ls, den * co);
      num[0] = fmaf(wt, x0.x, num[0] * co);
      num[1] = fmaf(wt, x0.y, num[1] * co);
      num[2] = fmaf(wt, x0.z, num[2] * co);
      num[3] = fmaf(wt, x0.w, num[3] * co);
      num[4] = fmaf(wt, x1.x, num[4] * co);
      num[5] = fmaf(wt, x1.y, num[5] * co);
      num[6] = fmaf(wt, x1.z, num[6] * co);
      num[7] = fmaf(wt, x1.w, num[7] * co);
    }
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  if (h0 + sr < p.H && c0 + sq * 8 < p.Dm)
    *reinterpret_cast<uint4*>(p.out + ((long)b * p.H + h0 + sr) * p.Dm + c0 + sq * 8) =
        make_uint4(pack_bf16(num[0] * inv, num[1] * inv), pack_bf16(num[2] * inv, num[3] * inv),
                   pack_bf16(num[4] * inv, num[5] * inv), pack_bf16(num[6] * inv, num[7] * inv));
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// Fill the derived fields of p and launch: Dm a multiple of 8 up to kSlice
// * kMaxCluster, Rr 0 or a multiple of 8 (kv_r groups of it per key, at most
// kRopeSteps k16 steps a rank), at most kMaxSplits splits of at most kKeys
// keys covering the longest row; r, x, out, q_rope and the roped keys
// 16-byte aligned; part (when splits > 1) and counters (one per unit) from
// the wrapper. The grid: cs x splits x (B * row_tiles) blocks, clusters of
// cs along x.
template <class Rows>
int launch(Params p, const Rows& rows, int capacity, float scale, cudaStream_t stream) {
  if (p.Rr == 0) p.kv_r = 1;
  if (p.B < 1 || p.H < 1 || p.kv_r < 1 || p.H % p.kv_r != 0 || p.Dm < 8 || p.Dm % 8 ||
      p.Dm > kSlice * kMaxCluster || p.Rr < 0 || p.Rr % 8 || p.splits < 1 ||
      p.splits > kMaxSplits || p.split_keys < 1 || p.split_keys > kKeys ||
      (long)p.splits * p.split_keys < capacity || !aligned16(p.r) || !aligned16(p.x) ||
      !aligned16(p.out) || (p.Rr > 0 && (!aligned16(p.qr) || !aligned16(p.kr))) ||
      p.counters == nullptr || (p.splits > 1 && p.part == nullptr))
    return cudaErrorInvalidValue;
  p.hpg = p.H / p.kv_r;
  p.rw = p.kv_r * p.Rr;
  if (p.rw_all == 0) p.rw_all = p.rw;
  if (p.rc_off < 0 || p.rc_off % 8 || p.rc_off + p.rw > p.rw_all) return cudaErrorInvalidValue;
  p.cs = (p.Dm + kSlice - 1) / kSlice;
  p.rsteps = ((p.rw_all + 15) / 16 + p.cs - 1) / p.cs;
  p.ksl = ((kKeys + p.cs - 1) / p.cs + 3) / 4 * 4;
  if (p.rsteps > kRopeSteps) return cudaErrorInvalidValue;
  p.row_tiles = (p.H + kRows - 1) / kRows;
  p.scale_log2 = scale * 1.4426950408889634f;
  const size_t bytes = smem_bytes(p.rsteps);
  // with the kernel's static shared memory (under 1 KB) a block opts in past
  // 48 KB; the opt-in is kept per device, made once
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err ? err : cudaErrorInvalidDevice;
  if (bytes > 44 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(token_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, p.splits, p.B * p.row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, token_kernel<Rows>, p, rows);
}

}  // namespace t1_token

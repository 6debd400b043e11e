// Chunked paged prefill on the tensor cores, bf16: the tensor-core route of
// B2 (paged_prefill.cu) and B6 (../../cpq_attn/csrc/paged_cpq_prefill.cu)
// in the port's kernel table. Float32 calls, and bf16 widths this route
// does not take, stay on the CUDA-core sweep of paged_attn.cuh and
// cpq_attn.cuh, which this header leaves untouched.
//
// Replaces, for bf16, the JAX package's Pallas TPU kernels
// `paged_flash_prefill_fwd` (src/repro/kernels/flash_attn/kernel.py:170)
// and `paged_cpq_prefill_fwd` (src/repro/kernels/cpq_dequant_attn/
// kernel.py:213). The C queries of one admission chunk of one slot, q
// (1, C, H, Dh), attend key positions [0, end), end = offset + valid, under
// the per-token causal mask; out (1, C, H, Dv). Per kv head the R = C * G
// query rows are token-major: row r is chunk token r / G, head kv * G +
// r % G, and it sees position pos iff pos < end and pos <= offset + r / G.
// Where a key comes from is the loader's business, a template parameter:
//
//   * PageKV (B2): bf16 K/V pages (P, page, KV, D) through the slot's block
//     row, by 16-byte cp.async copies, double-buffered;
//   * CodeKV (B6): positions < offset from the slot's int8 code pages,
//     dequantized in registers as (c - 1) * scale[level][d] + zero[level][d]
//     (one fmaf, rounded to bf16, as the TPU kernel and cpq_attn.cuh's
//     dequant<true> round the tile), a code of 0 (stored -128) and a level
//     outside [0, L) giving exactly 0 with no read out of bounds (the tiered
//     engine's null page); positions offset .. end - 1 from the chunk's raw
//     bf16 K/V (C, KV, D), unrounded. That is B6's mask as well: the raw
//     tail's col <= r / G and col < valid are pos <= offset + r / G and
//     pos < end at pos = offset + col.
//
// What bounds it: not bandwidth. At the served shape (qwen1.5-0.5b: C = 16,
// H = KV = 16, Dh = Dv = 64, up to 512 live keys) a call moves about 2 MB,
// 0.6 us at 3.35 TB/s, and does 17 MFLOP; the CUDA-core sweep took 23-29 us
// in two launches of serial float32 FMA chains. What is left is latency:
// the chain of dependent memory round trips of one call. The design keeps
// it short:
//
//   * one block per (key split, kv head, tile of 16 query rows): R = C * G
//     = 16 rows is one mma.sync.m16n8k16 row tile. Rows past R (C = 8,
//     G = 1) are zero-filled by the copy, masked and never stored;
//   * the block's warps (16 up to a padded width of 64, fewer past it, as
//     registers allow: the loader's `warps`) take the split's 16-key tiles
//     in turn: S = Q K^T and O += P V on mma.sync (bf16 in, float32
//     accumulate), Q, K by ldmatrix, V by ldmatrix.trans, the online
//     softmax in float32 on the accumulators in registers, P rounded to
//     bf16 in registers as the A operand (flash_prompt.cu's scheme). A
//     warp's tiles live in its own shared memory (rows padded by 16 bytes
//     for conflict-free ldmatrix), so the key loop needs no block-wide
//     barrier; the next tile is in flight while a warp computes (cp.async
//     double buffering for pages, registers for codes);
//   * the wrapper's splits hold at least 512 keys (single_query.plan with
//     its minimum and a cap of kMaxSplits), so every chunk of a served
//     prompt of up to 512 tokens is one split: the warps merge through
//     shared memory and the block writes the output. Past that the blocks
//     write (m, l, acc) partials, and the last block of a (kv head, row
//     tile) to arrive, counted on an acquire-release atomic of
//     kernels/single_query.counters, merges them and leaves the counter at
//     0: one launch per call, no merge kernel. (At this size a merge
//     across blocks, its round trips and fences, costs more than the keys.)
//   * masking: keys at or past the block's last row's limit are never
//     loaded (page 0 is never read), and only a tile that crosses the first
//     row's limit or the end is masked element by element; a split wholly
//     past the block's limit exits at once;
//   * widths: Dh and Dv multiples of 8 up to 256, run by the instantiation
//     for the next power of two (16 .. 256), the columns past them
//     zero-filled and never stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace paged_chunk {

typedef __nv_bfloat16 bf16;

constexpr int kMaxWarps = 16;            // warps per block: the loader's choice by width
constexpr int kRows = 16;                // query rows per block: one m16 tile
constexpr int kKeys = 16;                // keys per warp tile: one k16 step of P V
constexpr int kMaxSplits = 32;           // key splits a launch may have
constexpr size_t kMaxSmem = 227 * 1024;  // what a block may opt into on sm_90

struct Params {
  const bf16* q;     // (C, H, Dh)
  bf16* out;         // (C, H, Dv)
  float* part;       // split partials: m, l (KV, Rp, splits), acc (KV, Rp, splits, Dv)
  int* counters;     // one per (kv head, row tile); zero between launches
  int H, KV, G, R, Dh, Dv;
  int offset, end;   // chunk token i is position offset + i; keys [0, end) are live
  int splits, split_keys;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; an invalid one zero-fills (reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// *p += v at device scope with acquire-release order; returns the old value.
// After a block barrier, thread 0's release carries the whole block's
// earlier stores (the release is cumulative), and its acquire followed by a
// barrier orders the whole block's later loads: no sequentially consistent
// fence (__threadfence) per thread.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------ loaders
//
// A loader fills one warp tile: kKeys key rows of K and of V, positions
// j0 .. j0 + 15, as bf16 rows of DP + 8 elements in shared memory, with
// zeros past `kend` and past Dh / Dv. kStages: 2 for asynchronous copies
// (the next tile is in flight while this one is used), 1 for a loader that
// fills the tile before it returns. The block's first tile is staged so
// that its loads overlap the block's set-up: `setup_fetch` issues the
// loads of the loader's tables, `fetch_first` those of the first tile,
// `setup_store` puts the tables in shared memory, and after the block's
// barrier `finish_first` completes the first tile.

// B2: bf16 K/V pages (P, page, KV, Dh|Dv) through the slot's block row.
struct PageKV {
  static constexpr int kStages = 2;
  // warps per block at width DP (126 registers a thread at 64, 128 at 128)
  template <int DP>
  __host__ __device__ static constexpr int warps() { return DP <= 64 ? 16 : DP == 128 ? 8 : 4; }
  const bf16* k;
  const bf16* v;
  const int* block_row;
  int page;

  template <int DP>
  struct Staged {};
  template <int DP>
  size_t table_bytes() const { return 0; }
  template <int DP>
  __device__ void setup_fetch(const Params&, int, bool, Staged<DP>&) const {}
  template <int DP>
  __device__ void setup_store(const Params&, int, float*, bool, Staged<DP>&) {}
  template <int DP>
  __device__ void fetch_first(const Params& p, int kv, int j0, int kend, bf16* sK, bf16* sV,
                              Staged<DP>&, int lane) const {
    load<DP>(p, kv, j0, kend, sK, sV, lane);
  }
  template <int DP>
  __device__ void finish_first(const Params&, int, int, int, bf16*, bf16*, Staged<DP>&,
                               int) const {}
  template <int DP>
  __device__ void load(const Params& p, int kv, int j0, int kend, bf16* sK, bf16* sV,
                       int lane) const {
    constexpr int CH = DP / 8, LD = DP + 8;  // 16-byte chunks per row
    // lane k < 16 looks up key k's page; the copies take it by shuffle
    const int jk = j0 + (lane & 15);
    const int pg = jk < kend ? __ldg(block_row + jk / page) : 0;
#pragma unroll
    for (int u = 0; u < kKeys * CH / 32; ++u) {
      const int i = lane + 32 * u, r = i / CH, c = i % CH, j = j0 + r;
      const long row = ((long)__shfl_sync(0xffffffffu, pg, r) * page + j % page) * p.KV + kv;
      const bool okk = j < kend && c * 8 < p.Dh, okv = j < kend && c * 8 < p.Dv;
      cp_async16(sK + r * LD + c * 8, okk ? k + row * p.Dh + c * 8 : k, okk);
      cp_async16(sV + r * LD + c * 8, okv ? v + row * p.Dv + c * 8 : v, okv);
    }
  }
};

// B6: int8 code pages (P, page, KV, Dh|Dv) with one int32 level per (token,
// kv head), through the slot's block row, for positions < offset; the
// chunk's raw bf16 K/V (C, KV, Dh|Dv) for the positions after.
//
// The slot's four tables of the block's kv head (K scale, K zero, V scale,
// V zero) sit in shared memory, each [L][DP + 16] floats. A lane
// dequantizes 16 codes of one row against 16 scales and 16 zeros of its
// level, read as four float4 each; the float4s of 16-column chunk c are
// stored in the order j ^ (c & 3) and each level row is padded by 16
// floats, so the lanes of a quarter-warp (two key rows of four chunks at a
// width of 64) read distinct bank groups (single_query.cuh's CodeKV layout).
// A lane's 16-element items of a tile (K rows, then V rows) are loaded in
// batches, every load of a batch issued before any is used.
struct CodeKV {
  static constexpr int kStages = 1;
  // warps per block at width DP (the next tile's items wait in registers
  // while a warp computes: 128 registers a thread at 64, 207 at 128)
  template <int DP>
  __host__ __device__ static constexpr int warps() { return DP <= 64 ? 16 : 4; }
  static constexpr int kTabBatch = 8;  // table loads in flight per thread
  static constexpr int kZero = 0, kCode = 1, kRaw = 2;
  const int8_t* ck;
  const int8_t* cv;
  const int* lk;
  const int* lv;
  const float* sk;  // (L, KV, Dh) of the slot
  const float* zk;
  const float* sv;  // (L, KV, Dv)
  const float* zv;
  const bf16* k_raw;  // (C, KV, Dh)
  const bf16* v_raw;  // (C, KV, Dv)
  const int* block_row;
  int page, L;
  const float* tab;  // set by setup_store

  template <int DP>
  struct Staged {
    static constexpr int NCH = DP / 16;                   // 16-element items per row
    static constexpr int PER = 2 * kKeys * NCH / 32;      // items per lane, K then V
    static constexpr int BATCH = DP >= 256 ? 4 : PER;     // items in flight per lane
    uint4 a[BATCH], b[BATCH];
    int lvl[BATCH], kind[BATCH];
    int pg;                 // lane k < 16: the page of the tile's key k
    float tx[kTabBatch];    // the first batch of table loads, and where they go
    int tdst[kTabBatch];
  };

  template <int DP>
  size_t table_bytes() const { return sizeof(float) * 4 * (size_t)L * (DP + 16); }
  // element d of a level row, at its swizzled place
  __device__ static int slot(int d) {
    const int c = d >> 4, j = (d >> 2) & 3;
    return c * 16 + ((j ^ (c & 3)) << 2) + (d & 3);
  }
  // table entry i0 + u * blockDim.x + tid of kv head `kv`: its value and place
  template <int DP>
  __device__ void table_fetch(const Params& p, int kv, int i0, float (&x)[kTabBatch],
                              int (&dst)[kTabBatch]) const {
    constexpr int TW = DP + 16;
    const int nk = 2 * L * p.Dh, n = nk + 2 * L * p.Dv;
#pragma unroll
    for (int u = 0; u < kTabBatch; ++u) {
      const int i = i0 + u * blockDim.x + threadIdx.x;
      dst[u] = -1;
      if (i < n) {
        const bool is_v = i >= nk;
        const int D = is_v ? p.Dv : p.Dh, r = is_v ? i - nk : i;
        const int t = r / (L * D), l = (r / D) % L, d = r % D;  // table, level, column
        const float* src = is_v ? (t ? zv : sv) : (t ? zk : sk);
        x[u] = __ldg(src + ((long)l * p.KV + kv) * D + d);
        dst[u] = ((is_v ? 2 : 0) + t) * L * TW + l * TW + slot(d);
      }
    }
  }
  // the tables, when the block reads code pages at all: the first batch of
  // loads issued here, the rest in setup_store
  template <int DP>
  __device__ void setup_fetch(const Params& p, int kv, bool need, Staged<DP>& st) const {
    if (need) table_fetch<DP>(p, kv, 0, st.tx, st.tdst);
  }
  template <int DP>
  __device__ void setup_store(const Params& p, int kv, float* smem, bool need, Staged<DP>& st) {
    tab = smem;
    if (!need) return;
    const int n = 2 * L * (p.Dh + p.Dv);
    for (int i0 = 0; i0 < n; i0 += kTabBatch * blockDim.x) {
      if (i0 > 0) table_fetch<DP>(p, kv, i0, st.tx, st.tdst);
#pragma unroll
      for (int u = 0; u < kTabBatch; ++u)
        if (st.tdst[u] >= 0) smem[st.tdst[u]] = st.tx[u];
    }
  }
  // lane k < 16 looks up the page of key j0 + k (code rows only); items
  // take it by shuffle
  __device__ int page_of(const Params& p, int j0, int kend, int lane) const {
    const int jk = j0 + (lane & 15);
    return jk < kend && jk < p.offset ? __ldg(block_row + jk / page) : 0;
  }
  // issue the loads of the batch of items from u0
  template <int DP>
  __device__ void fetch(const Params& p, int kv, int j0, int kend, int u0, Staged<DP>& st,
                        int lane) const {
    using S = Staged<DP>;
#pragma unroll
    for (int u = 0; u < S::BATCH; ++u) {
      const int i = lane + 32 * (u0 + u);
      const bool is_v = i >= kKeys * S::NCH;
      const int ii = is_v ? i - kKeys * S::NCH : i, r = ii / S::NCH, c = ii % S::NCH;
      const int j = j0 + r, D = is_v ? p.Dv : p.Dh;
      const int pgr = __shfl_sync(0xffffffffu, st.pg, r);
      st.a[u] = st.b[u] = make_uint4(0u, 0u, 0u, 0u);
      st.lvl[u] = 0;
      st.kind[u] = kZero;
      if (j < kend && c * 16 < D) {
        if (j < p.offset) {
          const long row = ((long)pgr * page + j % page) * p.KV + kv;
          const int8_t* src = (is_v ? cv : ck) + row * D + c * 16;
          if (D % 16 == 0) {
            st.a[u] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {  // rows of 8-byte alignment: two halves, the second maybe past D
            const uint2 lo = __ldg(reinterpret_cast<const uint2*>(src));
            const uint2 hi = c * 16 + 8 < D ? __ldg(reinterpret_cast<const uint2*>(src + 8))
                                            : make_uint2(0u, 0u);
            st.a[u] = make_uint4(lo.x, lo.y, hi.x, hi.y);
          }
          st.lvl[u] = __ldg((is_v ? lv : lk) + row);
          st.kind[u] = kCode;
        } else {
          const bf16* src =
              (is_v ? v_raw : k_raw) + ((long)(j - p.offset) * p.KV + kv) * D + c * 16;
          st.a[u] = __ldg(reinterpret_cast<const uint4*>(src));
          if (c * 16 + 8 < D) st.b[u] = __ldg(reinterpret_cast<const uint4*>(src + 8));
          st.kind[u] = kRaw;
        }
      }
    }
  }
  // dequantize (codes) or copy (raw bf16, zeros) the batch from u0 into the tile
  template <int DP>
  __device__ void store(const Params& p, int u0, const Staged<DP>& st, bf16* sK, bf16* sV,
                        int lane) const {
    using S = Staged<DP>;
    constexpr int LD = DP + 8, TW = DP + 16;
#pragma unroll
    for (int u = 0; u < S::BATCH; ++u) {
      const int i = lane + 32 * (u0 + u);
      const bool is_v = i >= kKeys * S::NCH;
      const int ii = is_v ? i - kKeys * S::NCH : i, r = ii / S::NCH, c = ii % S::NCH;
      uint4* dst = reinterpret_cast<uint4*>((is_v ? sV : sK) + r * LD + c * 16);
      if (st.kind[u] != kCode) {
        dst[0] = st.a[u];
        dst[1] = st.b[u];
        continue;
      }
      const int D = is_v ? p.Dv : p.Dh;
      const bool in = st.lvl[u] >= 0 && st.lvl[u] < L;
      const float* side = tab + (is_v ? 2 * L * TW : 0);
      const int at = (in ? st.lvl[u] : 0) * TW + c * 16;
      const float4* s4 = reinterpret_cast<const float4*>(side + at);
      const float4* z4 = reinterpret_cast<const float4*>(side + L * TW + at);
      const int8_t* code = reinterpret_cast<const int8_t*>(&st.a[u]);
      uint32_t w[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 sc = s4[jj ^ (c & 3)], zr = z4[jj ^ (c & 3)];
        const float sj[4] = {sc.x, sc.y, sc.z, sc.w}, zj[4] = {zr.x, zr.y, zr.z, zr.w};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = code[4 * jj + e] + 128;
          y[e] = (in && cc != 0 && c * 16 + 4 * jj + e < D)
                     ? fmaf((float)(cc - 1), sj[e], zj[e]) : 0.f;
        }
        w[2 * jj] = pack_bf16(y[0], y[1]);
        w[2 * jj + 1] = pack_bf16(y[2], y[3]);
      }
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
  template <int DP>
  __device__ void fetch_first(const Params& p, int kv, int j0, int kend, bf16*, bf16*,
                              Staged<DP>& st, int lane) const {
    st.pg = page_of(p, j0, kend, lane);
    fetch<DP>(p, kv, j0, kend, 0, st, lane);
  }
  template <int DP>
  __device__ void finish_first(const Params& p, int kv, int j0, int kend, bf16* sK, bf16* sV,
                               Staged<DP>& st, int lane) const {
    using S = Staged<DP>;
    store<DP>(p, 0, st, sK, sV, lane);
#pragma unroll
    for (int u0 = S::BATCH; u0 < S::PER; u0 += S::BATCH) {
      fetch<DP>(p, kv, j0, kend, u0, st, lane);
      store<DP>(p, u0, st, sK, sV, lane);
    }
  }
  // a later tile: its loads issued before the warp computes the current
  // one (where the whole tile is one batch), its items stored after
  template <int DP>
  __device__ void fetch_next(const Params& p, int kv, int j0, int kend, Staged<DP>& st,
                             int lane) const {
    if constexpr (Staged<DP>::BATCH == Staged<DP>::PER) {
      st.pg = page_of(p, j0, kend, lane);
      fetch<DP>(p, kv, j0, kend, 0, st, lane);
    }
  }
  template <int DP>
  __device__ void store_next(const Params& p, int kv, int j0, int kend, bf16* sK, bf16* sV,
                             Staged<DP>& st, int lane) const {
    if constexpr (Staged<DP>::BATCH == Staged<DP>::PER)
      store<DP>(p, 0, st, sK, sV, lane);
    else
      load<DP>(p, kv, j0, kend, sK, sV, lane);
  }
  template <int DP>
  __device__ void load(const Params& p, int kv, int j0, int kend, bf16* sK, bf16* sV,
                       int lane) const {
    using S = Staged<DP>;
    S st;
    st.pg = page_of(p, j0, kend, lane);
#pragma unroll
    for (int u0 = 0; u0 < S::PER; u0 += S::BATCH) {
      fetch<DP>(p, kv, j0, kend, u0, st, lane);
      store<DP>(p, u0, st, sK, sV, lane);
    }
  }
};

// ------------------------------------------------------------------- kernel

// shared memory: Q [kRows][DP + 8] bf16; per warp kStages x (K, V)
// [kKeys][DP + 8] bf16, which at the end hold the warp's partial (acc
// [kRows][DP], m [kRows], l [kRows] floats); the loader's tables
template <class KVL, int DP>
size_t smem_bytes(const KVL& kvl) {
  constexpr int NW = KVL::template warps<DP>();
  return sizeof(bf16) * (size_t)(kRows + NW * KVL::kStages * 2 * kKeys) * (DP + 8) +
         kvl.template table_bytes<DP>();
}

template <class KVL, int DP>
__global__ void __launch_bounds__(32 * KVL::template warps<DP>())
    chunk_kernel(Params p, KVL kvl) {
  constexpr int NW = KVL::template warps<DP>(), NT = 32 * NW;
  constexpr int LD = DP + 8, CH = DP / 8, NS = KVL::kStages;
  constexpr int WSTRIDE = NS * 2 * kKeys * LD;  // a warp's region, bf16 elements
  static_assert(NW <= kMaxWarps && NT >= 8 * kRows, "warps per block");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sQ + kRows * LD;
  float* tab = reinterpret_cast<float*>(sW + NW * WSTRIDE);
  __shared__ int last_s;

  const int split = blockIdx.x, kv = blockIdx.y, rt = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = rt * kRows, rlast = min(p.R, r0 + kRows) - 1;
  // keys the block's last row sees, and keys every row of the block sees
  const int kend = min(p.end, p.offset + rlast / p.G + 1);
  const int kfull = min(p.end, p.offset + r0 / p.G + 1);
  const int nsplit = (kend + p.split_keys - 1) / p.split_keys;
  if (split >= nsplit) return;  // the split lies wholly past the block's limit
  const int s0 = split * p.split_keys, s1 = min(kend, s0 + p.split_keys);

  for (int i = tid; i < kRows * CH; i += NT) {
    const int r = i / CH, c = i % CH, rr = r0 + r;
    const bool ok = rr < p.R && c * 8 < p.Dh;
    const bf16* src = p.q + ((long)(rr / p.G) * p.H + kv * p.G + rr % p.G) * p.Dh + c * 8;
    cp_async16(sQ + r * LD + c * 8, ok ? src : p.q, ok);
  }
  cp_commit();

  bf16* mine = sW + warp * WSTRIDE;  // buffer b: K at b * 2 * kKeys * LD, V after it
  const int first = s0 + warp * kKeys, step = NW * kKeys;
  const int ntiles = first < s1 ? (s1 - first + step - 1) / step : 0;
  const bool codes = s0 < p.offset;  // the block reads code pages (B6's tables)
  typename KVL::template Staged<DP> st;
  kvl.template setup_fetch<DP>(p, kv, codes, st);
  if (ntiles > 0)
    kvl.template fetch_first<DP>(p, kv, first, kend, mine, mine + kKeys * LD, st, lane);
  cp_commit();
  kvl.template setup_store<DP>(p, kv, tab, codes, st);
  cp_wait<1>();  // Q has landed
  __syncthreads();  // Q and the tables are visible to every warp
  if (ntiles > 0)
    kvl.template finish_first<DP>(p, kv, first, kend, mine, mine + kKeys * LD, st, lane);

  float o[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows lane/4, lane/4 + 8
  const int rowA = r0 + (lane >> 2);
  const int lim[2] = {p.offset + rowA / p.G, p.offset + (rowA + 8) / p.G};

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = first + it * step;
    bf16* sK = mine;
    bf16* sV = mine + kKeys * LD;
    if constexpr (NS == 2) {
      const int buf = it & 1;
      sK = mine + buf * 2 * kKeys * LD;
      sV = sK + kKeys * LD;
      if (it + 1 < ntiles) {
        bf16* nK = mine + (buf ^ 1) * 2 * kKeys * LD;
        kvl.template load<DP>(p, kv, j0 + step, kend, nK, nK + kKeys * LD, lane);
      }
      cp_commit();
      cp_wait<1>();  // this tile has landed
    } else if (it + 1 < ntiles) {
      kvl.template fetch_next<DP>(p, kv, j0 + step, kend, st, lane);
    }
    __syncwarp();

    // S = Q K^T: 16 rows x 16 keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, smem_u32(sQ + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
      ldsm_x4(bk, smem_u32(sK + ((lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8));
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
    if (j0 + kKeys > kfull) {  // a tile that crosses a row's limit or the end
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + n * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= p.end || key > lim[e >> 1]) s[n][e] = -INFINITY;
        }
    }

    // online softmax on the accumulators, float32
    float mx[2], msc[2], corr[2], rs[2] = {0.f, 0.f};
    mx[0] = fmaxf(m_r[0], fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    mx[1] = fmaxf(m_r[1], fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      msc[i] = mx[i] == -INFINITY ? 0.f : mx[i] * p.scale_log2;  // no live key yet
      corr[i] = exp2f(m_r[i] * p.scale_log2 - msc[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] * p.scale_log2 - msc[e >> 1]);
      rs[0] += s[n][0] + s[n][1];
      rs[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // O += P V: P's accumulators are the A operand, V by ldmatrix.trans
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, smem_u32(sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + dn * 16 +
                                 (lane >> 4) * 8));
      mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
      mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();  // the tile is consumed before its buffer is refilled
    if constexpr (NS == 1) {
      if (it + 1 < ntiles)
        kvl.template store_next<DP>(p, kv, j0 + step, kend, sK, sV, st, lane);
    }
  }
  cp_wait<0>();

  // the warps' partials, through shared memory: acc [kRows][DP], m, l [kRows]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  __syncthreads();  // every warp is past its tiles
  float* wp = reinterpret_cast<float*>(mine);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (lane >> 2) + i * 8;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d)
      *reinterpret_cast<float2*>(wp + r * DP + d * 8 + (lane & 3) * 2) =
          make_float2(o[d][2 * i], o[d][2 * i + 1]);
    if ((lane & 3) == 0) {
      wp[kRows * DP + r] = m_r[i] == -INFINITY ? -INFINITY : m_r[i] * p.scale_log2;
      wp[kRows * DP + kRows + r] = l_r[i];
    }
  }
  __syncthreads();

  // each row's weight of each warp, once: the block's max M and sum l
  __shared__ float s_wt[kMaxWarps][kRows], s_m[kRows], s_l[kRows];
  if (tid < kRows) {
    float mw[NW], lw[NW], M = -INFINITY, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* x = reinterpret_cast<const float*>(sW + w * WSTRIDE) + kRows * DP;
      mw[w] = x[tid];
      lw[w] = x[kRows + tid];
      if (lw[w] > 0.f) M = fmaxf(M, mw[w]);
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s_wt[w][tid] = lw[w] > 0.f ? exp2f(mw[w] - M) : 0.f;
      den = fmaf(s_wt[w][tid], lw[w], den);
    }
    s_m[tid] = M;
    s_l[tid] = den;
  }
  __syncthreads();
  const int Rp = gridDim.z * kRows;
  const long n_rows = (long)p.KV * Rp * p.splits;
  for (int i = tid; i < kRows * p.Dv; i += NT) {
    const int r = i / p.Dv, d = i % p.Dv, rr = r0 + r;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      num = fmaf(s_wt[w][r], reinterpret_cast<const float*>(sW + w * WSTRIDE)[r * DP + d], num);
    if (nsplit == 1) {
      if (rr < p.R)
        p.out[((long)(rr / p.G) * p.H + kv * p.G + rr % p.G) * p.Dv + d] =
            __float2bfloat16(s_l[r] > 0.f ? num / s_l[r] : 0.f);
    } else {
      const long at = ((long)kv * Rp + rr) * p.splits + split;
      if (d == 0) {
        p.part[at] = s_m[r];
        p.part[n_rows + at] = s_l[r];
      }
      p.part[2 * n_rows + at * p.Dv + d] = num;
    }
  }
  if (nsplit == 1) return;

  // the last block of this (kv head, row tile) merges the splits
  __syncthreads();  // the block's partial stores precede thread 0's release
  int* counter = p.counters + kv * gridDim.z + rt;
  if (tid == 0) last_s = atomic_add_acq_rel(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  // each row's weight of each split, once: 8 threads a row, up to 4 splits
  // each, their loads issued together; the weights go to the warp regions,
  // which are free now (kRows * kMaxSplits floats), 1 / their sum to s_l
  static_assert(kMaxSplits == 32, "8 threads x 4 splits a row");
  float* wsplit = reinterpret_cast<float*>(sW);
  if (tid < 8 * kRows) {
    const int r = tid >> 3, j = tid & 7;
    const long at = ((long)kv * Rp + r0 + r) * p.splits;
    float ms[4], ls[4], M = -INFINITY, den = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int sp = j + 8 * k;
      ls[k] = sp < nsplit ? __ldcg(p.part + n_rows + at + sp) : 0.f;
      ms[k] = sp < nsplit ? __ldcg(p.part + at + sp) : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ls[k] > 0.f) M = fmaxf(M, ms[k]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float wt = ls[k] > 0.f ? exp2f(ms[k] - M) : 0.f;
      wsplit[r * kMaxSplits + j + 8 * k] = wt;
      den = fmaf(wt, ls[k], den);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (j == 0) s_l[r] = den > 0.f ? 1.f / den : 0.f;
  }
  __syncthreads();
  // out = sum over splits of weight x acc: kBatch elements a thread, the
  // loads of kSplitBatch splits for all of them issued together
  constexpr int kBatch = 8, kSplitBatch = 4;
  for (int i0 = 0; i0 < kRows * p.Dv; i0 += kBatch * NT) {
    float num[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) num[e] = 0.f;
    for (int s0 = 0; s0 < nsplit; s0 += kSplitBatch) {
      float x[kSplitBatch][kBatch];
#pragma unroll
      for (int sb = 0; sb < kSplitBatch; ++sb)
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int i = i0 + e * NT + tid, sp = s0 + sb;
          x[sb][e] = 0.f;
          if (i < kRows * p.Dv && sp < nsplit) {
            const long at = ((long)kv * Rp + r0 + i / p.Dv) * p.splits + sp;
            x[sb][e] = __ldcg(p.part + 2 * n_rows + at * p.Dv + i % p.Dv);
          }
        }
#pragma unroll
      for (int sb = 0; sb < kSplitBatch; ++sb)
#pragma unroll
        for (int e = 0; e < kBatch; ++e) {
          const int r = ((i0 + e * NT + tid) / p.Dv) & (kRows - 1);
          num[e] = fmaf(wsplit[r * kMaxSplits + ((s0 + sb) & (kMaxSplits - 1))], x[sb][e],
                        num[e]);
        }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + e * NT + tid, r = i / p.Dv, d = i % p.Dv, rr = r0 + r;
      if (i < kRows * p.Dv && rr < p.R)
        p.out[((long)(rr / p.G) * p.H + kv * p.G + rr % p.G) * p.Dv + d] =
            __float2bfloat16(num[e] * s_l[r]);
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <class KVL, int DP>
int launch_dp(const Params& p, const KVL& kvl, cudaStream_t stream) {
  const size_t bytes = smem_bytes<KVL, DP>(kvl);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  // past 48 KB with the kernel's static shared memory (1.3 KB) a block opts
  // in; the opt-in is kept per device, so it is made once, not per launch
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err ? err : cudaErrorInvalidDevice;
  if (bytes > 46 * 1024 && bytes > opted[dev]) {
    err = cudaFuncSetAttribute(chunk_kernel<KVL, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted[dev] = bytes;
  }
  const dim3 grid(p.splits, p.KV, (p.R + kRows - 1) / kRows);
  chunk_kernel<KVL, DP><<<grid, 32 * KVL::template warps<DP>(), bytes, stream>>>(p, kvl);
  return cudaGetLastError();
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// Fill the shared fields of p and launch with Dh, Dv padded to a power of
// two. Dh and Dv multiples of 8 from 8 to 256; q and out 16-byte aligned;
// at most kMaxSplits splits of split_keys keys (a multiple of kKeys) cover
// [0, end); the counters hold KV * ceil(R / 16) zeros or more.
template <class KVL>
int launch(Params p, const KVL& kvl, int C, float scale, void* stream) {
  if (p.KV < 1 || p.H % p.KV != 0 || C < 1 || p.offset < 0 || p.end <= p.offset ||
      p.end > p.offset + C || p.Dh < 8 || p.Dv < 8 || p.Dh % 8 || p.Dv % 8 ||
      p.Dh > 256 || p.Dv > 256 || p.splits < 1 || p.splits > kMaxSplits ||
      p.split_keys < kKeys ||
      p.split_keys % kKeys || (long)p.splits * p.split_keys < p.end || !aligned16(p.q) ||
      !aligned16(p.out) || p.part == nullptr || p.counters == nullptr)
    return cudaErrorInvalidValue;
  p.G = p.H / p.KV;
  p.R = C * p.G;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = p.Dh > p.Dv ? p.Dh : p.Dv;
  if (D <= 16) return launch_dp<KVL, 16>(p, kvl, s);
  if (D <= 32) return launch_dp<KVL, 32>(p, kvl, s);
  if (D <= 64) return launch_dp<KVL, 64>(p, kvl, s);
  if (D <= 128) return launch_dp<KVL, 128>(p, kvl, s);
  return launch_dp<KVL, 256>(p, kvl, s);
}

}  // namespace paged_chunk

// Contiguous flash attention forward on the tensor cores, bf16 (B8's prompt
// route in the port's kernel table).
//
// Replaces, for a prompt (T > 1) in bfloat16, the JAX package's Pallas TPU
// kernel `flash_attention_fwd` (src/repro/kernels/flash_attn/kernel.py:276,
// body `_kernel` :26): GQA attention of q (B, T, H, Dh) over k (B, S, KV,
// Dh) and v (B, S, KV, Dv), query head h reading kv head h / (H / KV),
// causal (query token i sees keys j <= i) or not, out (B, T, H, Dv) in
// bf16. k and v may be the written prefix of a longer arena: key j of row b
// is arena row b * s_stride + j. A float32 prompt stays on the CUDA-core
// sweep of flash_attention.cu, the only float32 route that meets the 5e-5
// gate (TF32 tensor cores would not).
//
// What bounds it: at the static prefill shape (8 rows of 512 tokens, 16
// heads of 64, causal) the bytes of q, k, v and out (33.5 MB, 10.0 us at
// 3.35 TB/s) against 4.3 GFLOP of causal pairs (4.4 us at the bf16 peak):
// both small, so the kernel must keep the tensor cores fed with no pass
// beyond the one over its inputs. The design (mma.sync, the FlashAttention-2
// shape):
//
//   * one block per (tile of 64 query rows, query head, row b), 4 warps of
//     16 rows each; no split of the key range and no merge pass: each block
//     owns whole output rows. The causal tiles with the most keys are
//     scheduled first. 64-row tiles, not 128: one-shot admission prefills
//     B = 1, and 16 heads x 8 tiles of a 512-token prompt is 128 blocks for
//     132 SMs already;
//   * K and V come in tiles of 64 keys (32 at a padded width of 256, where
//     shared memory would hold only one block otherwise) through 16-byte
//     cp.async copies, double-buffered, in rows padded by 16 bytes so that
//     ldmatrix reads 8 rows without a bank conflict; the Q tile is loaded
//     once, the same way;
//   * S = Q K^T by mma.sync.m16n8k16 (bf16 in, float32 out), operands by
//     ldmatrix; the online softmax runs on the accumulators in registers in
//     float32 (exp2 of pre-scaled scores), a row's max and sum reduced over
//     its quad of lanes by shuffles; P is rounded to bf16 in registers and
//     is the A operand of O += P V, whose B operand comes by ldmatrix.trans
//     from V's row-major tile (the layout of C and of A line up, so P never
//     goes to shared memory);
//   * masking: causal key tiles wholly above the block's last row are never
//     loaded, and only a tile that crosses the diagonal or the end of S is
//     masked element by element; rows past T and keys past S are zero-filled
//     by the copies (no padding copy in device memory);
//   * widths: Dh and Dv multiples of 16 up to 256, run by the instantiation
//     for the next power of two (16 .. 256) with the columns past them
//     zero-filled and never stored.
//
// Numerics: scores and the softmax state in float32, P rounded to bf16 for
// the value product (the plain version rounds its weights to v's dtype the
// same way), output acc / l in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_prompt {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockM = 64;    // query rows per block, 16 per warp

struct Params {
  const __nv_bfloat16* q;  // rows at b * q_sb + t * q_stok, heads dense
  const __nv_bfloat16* k;  // arena rows (b * s_stride + j) * KV + kv, Dh each
  const __nv_bfloat16* v;  // same, Dv each
  __nv_bfloat16* out;      // (B, T, H, Dv)
  long q_sb, q_stok;
  int B, T, S, H, KV, Dh, Dv, s_stride, causal;
  float scale_log2;        // scale * log2(e)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// DP: Dh and Dv padded to a power of two; KT: keys per tile
template <int DP, int KT>
__global__ void __launch_bounds__(kThreads) flash_prompt_kernel(Params p) {
  constexpr int LD = DP + 8;  // padded row (elements): 8 rows hit distinct banks
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBlockM][LD]
  __nv_bfloat16* sK = sQ + kBlockM * LD;                             // [2][KT][LD]
  __nv_bfloat16* sV = sK + 2 * KT * LD;                              // [2][KT][LD]

  const int mt = gridDim.x - 1 - blockIdx.x;  // the causal tiles with most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv = h / (p.H / p.KV);
  const int m0 = mt * kBlockM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wrow = warp * 16;  // the warp's first row in the tile

  // keys this block sees: all S, or (causal) up to its last row
  const int kend = p.causal ? min(p.S, min(p.T, m0 + kBlockM)) : p.S;
  const int ntiles = (kend + KT - 1) / KT;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + (long)h * p.Dh;
  for (int i = tid; i < kBlockM * CH; i += kThreads) {
    const int r = i / CH, c = i % CH, t = m0 + r;
    const bool ok = t < p.T && c * 8 < p.Dh;
    cp_async16(sQ + r * LD + c * 8, ok ? qb + t * p.q_stok + c * 8 : p.q, ok);
  }
  auto load_kv = [&](int tile, int buf) {
    for (int i = tid; i < KT * CH; i += kThreads) {
      const int r = i / CH, c = i % CH, j = tile * KT + r;
      const long row = ((long)b * p.s_stride + j) * p.KV + kv;
      const bool okk = j < p.S && c * 8 < p.Dh, okv = j < p.S && c * 8 < p.Dv;
      cp_async16(sK + (buf * KT + r) * LD + c * 8, okk ? p.k + row * p.Dh + c * 8 : p.k, okk);
      cp_async16(sV + (buf * KT + r) * LD + c * 8, okv ? p.v + row * p.Dv + c * 8 : p.v, okv);
    }
  };
  load_kv(0, 0);
  cp_commit();  // Q and the first tile

  float o[DP / 8][4];
#pragma unroll
  for (int d = 0; d < DP / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // rows lane/4, lane/4 + 8
  const int row0 = m0 + wrow + (lane >> 2);

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, j0 = it * KT;
    if (it + 1 < ntiles) load_kv(it + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();  // this tile (and Q) have landed
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's KT keys
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(sQ + (wrow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) {
        uint32_t bk[4];
        const int key = nn * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(bk, smem_u32(sK + (buf * KT + key) * LD + kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * nn], a, bk[0], bk[1]);
        mma_bf16(s[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
    if (j0 + KT > p.S || (p.causal && j0 + KT - 1 > m0)) {  // the ragged or diagonal tile
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= p.S || (p.causal && key > row)) s[n][e] = -INFINITY;
        }
    }

    // online softmax on the accumulators, float32
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float msc[2], corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      msc[i] = mx[i] == -INFINITY ? 0.f : mx[i] * p.scale_log2;  // no key seen yet
      corr[i] = exp2f(m_r[i] * p.scale_log2 - msc[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n) {
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
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(bv, smem_u32(sV + (buf * KT + key) * LD + dn * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dn], a, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the tile is consumed before the next prefetch reuses its buffer
  }
  cp_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + i * 8;
    if (t >= p.T) continue;
    __nv_bfloat16* op = p.out + ((long)(b * p.T + t) * p.H + h) * p.Dv;
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
      const int col = d * 8 + (lane & 3) * 2;
      if (col < p.Dv)
        *reinterpret_cast<uint32_t*>(op + col) =
            pack_bf16(o[d][2 * i] * inv[i], o[d][2 * i + 1] * inv[i]);
    }
  }
}

template <int DP, int KT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = sizeof(__nv_bfloat16) * (size_t)(kBlockM + 4 * KT) * (DP + 8);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_prompt_kernel<DP, KT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.T + kBlockM - 1) / kBlockM, p.H, p.B);
  flash_prompt_kernel<DP, KT><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace flash_prompt

// q, k, v, out bf16; q's rows at b * q_sb + t * q_stok elements (heads
// dense), k and v rows b * s_stride + j. Dh and Dv multiples of 16 up to
// 256. Returns the CUDA error of the launch (cudaErrorInvalidValue for a
// shape it does not take).
extern "C" int flash_prompt_launch(const void* q, const void* k, const void* v, void* out,
                                   int B, int T, int S, int H, int KV, int Dh, int Dv,
                                   long q_sb, long q_stok, int s_stride, int causal,
                                   float scale, void* stream) {
  using namespace flash_prompt;
  if (B < 1 || T < 1 || S < 1 || KV < 1 || H % KV != 0 || s_stride < S ||
      Dh % 16 != 0 || Dv % 16 != 0 || Dh < 16 || Dv < 16 || Dh > 256 || Dv > 256 ||
      q_sb % 8 != 0 || q_stok % 8 != 0 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.q_sb = q_sb;
  p.q_stok = q_stok;
  p.B = B;
  p.T = T;
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.Dh = Dh;
  p.Dv = Dv;
  p.s_stride = s_stride;
  p.causal = causal;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int D = Dh > Dv ? Dh : Dv;
  if (D <= 16) return launch<16, 64>(p, s);
  if (D <= 32) return launch<32, 64>(p, s);
  if (D <= 64) return launch<64, 64>(p, s);
  if (D <= 128) return launch<128, 64>(p, s);
  return launch<256, 32>(p, s);
}

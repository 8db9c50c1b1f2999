// Flash-attention forward kernels for Hopper (sm_90a): K1 (bf16), K2 (int8
// Q.K^T), K2v (int8 V) and K3 (static-bound softmax).
//
// K1 replaces stableavatar_tpu/ops/flash_attention.py:_flash_fwd_impl (body
// `_fwd_body`): softmax(q k^T * scale) v over [B, L, N, D] bf16, read in
// place, with keys at or past k_lens[b] masked; base-2 online softmax (the
// caller folds log2(e) into scale_log2), out rounded to bf16 once.  With a
// non-null `lse` (K1-LSE) it also writes the natural-log log-sum-exp of
// every query row, m * ln2 + log(max(l, 1e-30)) as `_fwd_body` finalizes
// it, in fp32 laid out [B, N, Lq] (no 128-lane broadcast); the backward
// (K4, flash_attention_bwd.cu) recomputes P from it.  A null `lse` skips
// the write, as the JAX package's primal-only path does.
//
// K2, K2-LSE, K2v and K3 replace stableavatar_tpu/ops/flash_attention.py:
// _flash_int8_impl.  Q and K arrive as int8 [B, L, N, D] with one scale per
// (batch, head) slab (the prep is plain torch, as it was XLA on the TPU):
// Q8.K8^T runs on the s8 tensor cores into s32, converted to fp32 and
// multiplied by sqk[b*N + h] = sq * sk * scale * log2(e) -- the TPU's
// `dot(int32).astype(f32) * sqk`, exactly (the integer products are exact).
// Then, by the V path and the softmax:
//   - K2, quant="qk" (body `_int8_fwd_body`, branch `else`): K1's online
//     softmax, bf16 P.V;
//   - K3-qk (`_int8_fwd_body_static`): p = exp2(s - M) with M = sqk *
//     max|q8| * max|k8| over 64 query rows and all keys (Cauchy-Schwarz,
//     computed by the wrapper, `static_bound`): no running max, no rescale;
//   - K2v "qkv" (`v_int8` branch): V int8, widened to bf16 in registers for
//     the P.V product, its per-channel scale applied once at finalize; K3-qkv
//     the same under the static bound;
//   - K2v "qkpv" (`quant_pv` branch): P rescaled to its row max within the
//     JAX package's key block (`pv_block` keys, a multiple of 64: 1536 or
//     1024 capped to the sequence rounded up to 128), rounded to int8 and
//     multiplied with int8 V into s32, times exp2(m_block - m_new) / 127.
//     Each block of pv_block / 64 key tiles is swept twice: first for the
//     row max of its logits, then for P.V (Q.K^T is computed twice).
// With a non-null `lse` every variant also writes the natural-log LSE of
// each query row, m * ln2 + log(max(l, 1e-30)) (M in place of m for K3), in
// fp32 laid out [B, N, Lq]: K2-LSE, the combinable partials of ring
// attention (`flash_attention_with_stats(quant=...)`).  K is read row-major
// [B, L, N, D]: the TPU's [D, L] pre-transpose is a layout of its matrix
// unit and has no use here.
//
// What bounds them on the H100: the two L^2 * D products per head (Q.K^T
// and P.V) -- at the DiT self-attention [3, 21504, 12, 128] 8.5e12
// operations against 0.2 GB of operands, so operations: 8.6 ms at 989
// TFLOP/s for K1, 6.5 ms for K2 / K3 (Q.K^T at the 1,979 TOP/s int8 peak),
// with the softmax's exp2 on the SFUs (64 per thread and key tile) as the
// next limit.  The first designs (4 warps of mma.sync over 64-key tiles, one
// cp.async stage, two block barriers a tile) ran at a fifth of that, and
// their products without the softmax (the S3 probe) took 83% of their time.
// So K1, K2 and K3-qk are one Hopper design (`ffwd::flash_fwd_kernel<D,
// QK>`, D = 128 and D = 64, QK = bf16, int8 or int8 under the static bound):
//
// - a block owns 128 query rows of one (batch, head); one producer thread
//   (a warpgroup with its registers handed over by setmaxnreg, 24 / 240)
//   loads the block's Q once and streams 128-key K and V tiles through a
//   ring in dynamic shared memory (TMA from 3-D tensor maps over
//   [B, L, N * D], rows past L read as zeros; K and V of a stage complete on
//   mbarriers of their own, and an `empty` mbarrier hands the stage back).
//   bf16: 128-byte swizzle, 3 stages, 224 KB at D = 128.  int8: Q8 and K8
//   rows of D bytes in the 128-byte swizzle, or at D = 64 the 64-byte one
//   (8 rows in 512 bytes, its own descriptor layout); V stays bf16; 4 stages
//   (16 KB of Q8 plus 48 KB a stage: 208 KB at D = 128);
// - two consumer warpgroups own 64 query rows each: S = Q K^T is one
//   wgmma m64n128 chain with both operands K-major in shared memory (bf16
//   k16 steps into fp32, or s8 k32 steps into s32, converted in place and
//   scaled by sqk), the softmax (online: running max m and row sum l, the
//   rescale of O; K3: exp2(s - M), no rescale) runs in registers in wgmma's
//   accumulator layout, P is packed to bf16 A fragments in registers and
//   O += P V is a register-A wgmma with V MN-major; O stays in fp32
//   registers for the whole key loop;
// - inside a warpgroup, S of tile j + 1 is issued before P V of tile j and
//   its softmax runs while that product is on the tensor cores (so K runs a
//   tile ahead of V: hence at least three stages); the two warpgroups do not
//   wait for each other, so one's softmax also overlaps the other's
//   products.  On the card this gained 2-3% for K1 over one tile at a time
//   with two stages (PERF.md);
// - zero fill is not a mask (a zero key has logit 0): keys at or past
//   k_lens[b] (and Lk) get p = 0 in the kernel, tiles wholly past
//   k_lens[b] are not loaded (a block with none writes zero rows and the LSE
//   of an empty row), and rows past Lq are neither stored nor given an LSE.
//   K3's bound is per 64 query rows, so each consumer warpgroup reads its
//   own.  No atomics: two launches agree bit for bit.
//
// K1-rope (`flash_attention(rope=)`, on no main path) keeps the first
// mma.sync design: 4 warps own 64 query rows, one cp.async K/V stage of
// 64-key tiles, with the split-pair rotation of `_fwd_body`'s `rope=`
// branch (`_rot`, :142-143) inside -- Q is rotated in fp32 on its way into
// the A fragments, each K tile in place in shared memory after it lands,
// both rounded to bf16 once as `_rot(...).astype(dt)` does.  So do the
// int8-V variants (K2v-qkv, K2v-qkpv, K3-qkv; `flash_fwd_int8v_kernel`):
// s8 wgmma takes 8-bit operands only K-major, and int8 V is the B operand
// of P.V with D contiguous (MN-major), so they need a V8 laid out K-major by
// the prep, or a transpose in shared memory -- a design of their own.
#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace sa {

// K1-rope (and its LSE), the first mma.sync design: 4 warps own 64 query
// rows, one cp.async K/V stage of 64 keys.  At most 168 registers, so that
// 3 blocks of 128 threads share an SM (the rotation's loads would take more)
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_bf16_rope_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int* __restrict__ k_lens,
                           const float* __restrict__ rope, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Lq, int Lk, int N, float scale_log2) {
  constexpr int kPitch = D + 8;
  __shared__ __align__(16) unsigned short Ks[kBlockK * kPitch];
  __shared__ __align__(16) unsigned short Vs[kBlockK * kPitch];

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + (lane >> 2);
  const long long rs = (long long)N * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;

  uint32_t qa[D / 16][4];
  load_q_bf16_rope<D>(qa, q + ((long long)b * Lq * N + h) * D, rs, row_a, Lq, rope);

  const char* kb = reinterpret_cast<const char*>(k + ((long long)b * Lk * N + h) * D);
  const char* vb = reinterpret_cast<const char*>(v + ((long long)b * Lk * N + h) * D);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int ntiles = (klen + kBlockK - 1) / kBlockK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<D * 2>(reinterpret_cast<char*>(Ks), kb, rs * 2, k0, Lk);
    cp_async_commit();
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), vb, rs * 2, k0, Lk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    rope_tile<D>(Ks, rope, k0, Lk);
    __syncthreads();

    float s[kNT][4];
    qk_bf16<D>(s, qa, Ks);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] *= scale_log2;
      s[nt][1] *= scale_log2;
      s[nt][2] *= scale_log2;
      s[nt][3] *= scale_log2;
    }
    softmax_update<D>(s, m, l, acc, k0, klen);

    cp_async_wait<0>();
    __syncthreads();
    pv_bf16<D>(acc, s, Vs);
    __syncthreads();
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] /= l0;
    acc[nd][1] /= l0;
    acc[nd][2] /= l1;
    acc[nd][3] /= l1;
  }
  store_rows<D>(out + ((long long)b * Lq * N + h) * D, rs, row_a, Lq, acc);
  if (lse != nullptr && (lane & 3) == 0) {
    // m is the base-2 running max (shared by the quad), l the row sum
    float* lse_bh = lse + (long long)bh * Lq;
    if (row_a < Lq) lse_bh[row_a] = m[0] * kLn2 + logf(l0);
    if (row_a + 8 < Lq) lse_bh[row_a + 8] = m[1] * kLn2 + logf(l1);
  }
}

// --------------------------------------------------------------------------
// K1, K1-LSE, K2, K2-LSE qk and K3-qk: one producer warpgroup feeds a TMA
// ring, two consumer warpgroups run wgmma
// --------------------------------------------------------------------------

namespace ffwd {

constexpr int kBlockM = 128;   // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;   // keys per K / V tile
constexpr int kConsumers = 256;
constexpr int kThreads = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int kRow = 128;      // bytes of one swizzled bf16 row (64 bf16)

// Q.K^T and the softmax of an instance (template parameter)
enum Qk {
  kQkBf16 = 0,        // K1: bf16 Q, K; online softmax
  kQkInt8 = 1,        // K2: int8 Q8, K8 on the s8 tensor cores, times sqk; online softmax
  kQkInt8Static = 2,  // K3-qk: as K2 under K3's static bound, no running max
};

// shared-memory layout (byte offsets from a 1024-byte boundary); every
// swizzled operand starts on a 1024-byte boundary
template <int D, int QK>
struct Smem {
  static constexpr bool kInt8 = QK != kQkBf16;
  // S runs a tile ahead of P V: at least 3 stages.  K8 is half the bytes of
  // a bf16 K, so int8 fits a fourth (208 KB at D = 128): K2 ran 1% faster
  // with it than with 3 on the H100 (PERF.md)
  static constexpr int kStages = kInt8 ? 4 : 3;
  static constexpr int kQKRow = kInt8 ? D : kRow;     // bytes of a swizzled Q / K row
  static constexpr int kQKParts = kInt8 ? 1 : D / 64;  // swizzled column tiles of Q / K
  static constexpr int kVHalves = D / 64;
  static constexpr int kQ = kQKParts * kBlockM * kQKRow;  // the block's Q
  static constexpr int kK = kQKParts * kBlockN * kQKRow;  // one K stage
  static constexpr int kV = kVHalves * kBlockN * kRow;    // one V stage
  static constexpr int off_q = 0;
  static constexpr int off_k = off_q + kQ;
  static constexpr int off_v = off_k + kStages * kK;
  static constexpr int off_bar = off_v + kStages * kV;
  static constexpr int bytes = off_bar + (1 + 3 * kStages) * 8;
  static constexpr int launch_bytes = bytes + 1024;  // room to align the base
};

// S = Q K^T [64 queries, 128 keys] of one K tile, both operands K-major;
// issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t q_wg, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qo = (kk >> 2) * kBlockM * kRow + (kk & 3) * 32;
    const uint32_t ko = (kk >> 2) * kBlockN * kRow + (kk & 3) * 32;
    wgmma_ss_n128<0, 0>(sacc, make_desc(q_wg + qo, 16, 1024), make_desc(kb + ko, 16, 1024),
                        kk > 0);
  }
  wgmma_commit();
}

// S = Q8 K8^T [64 queries, 128 keys] of one K8 tile on the s8 tensor cores
// into s32: D / 32 k-steps of 32 bytes inside rows of D bytes (the 128- or
// 64-byte swizzle, 8 rows in 8 D bytes), both operands K-major; issued and
// committed, not waited for
template <int D>
__device__ __forceinline__ void issue_qk_s8(int (&sacc)[64], uint32_t q_wg, uint32_t kb) {
  wgmma_fence();
  wgmma_s8_n128_first(sacc, make_desc(q_wg, 16, 8 * D, D), make_desc(kb, 16, 8 * D, D));
#pragma unroll
  for (int kk = 1; kk < D / 32; ++kk) {
    wgmma_s8_n128(sacc, make_desc(q_wg + kk * 32, 16, 8 * D, D),
                  make_desc(kb + kk * 32, 16, 8 * D, D), 1);
  }
  wgmma_commit();
}

// Keys at or past klen get the logit -1e30 (zero-filled keys past Lk, and
// keys past k_lens[b]): TMA's fill is not a mask, a zero key has logit 0.
// Element 4j + e of the accumulator layout is row g (e < 2) or g + 8, key
// k0 + 8j + 2t + (e & 1).
__device__ __forceinline__ void mask_tile(float (&sacc)[64], int k0, int klen) {
  const int t = threadIdx.x & 3;
  if (k0 + kBlockN > klen) {
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * j + 2 * t + (e & 1) >= klen) sacc[4 * j + e] = kNegInf;
      }
    }
  }
}

// Online softmax of the tile of keys [k0, k0 + 128) in the accumulator
// layout: turns the raw logits into p = exp2(s * scale_log2 - m_new),
// updates the running max m (base 2, scaled) and this thread's partial row
// sums l, and returns in c0 / c1 the factors that rescale O to the new max.
__device__ __forceinline__ void softmax_tile(float (&sacc)[64], int k0, int klen,
                                             float scale_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& c0, float& c1) {
  mask_tile(sacc, k0, klen);
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // scale > 0, so the max of the scaled logits is the scaled max; every row
  // has a valid key in every tile it sees (tile 0 holds key 0)
  const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
  c0 = exp2f(m0 - mn0);
  c1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sacc[4 * j + e] = exp2f(fmaf(sacc[4 * j + e], scale_log2, -mn0));
      sacc[4 * j + 2 + e] = exp2f(fmaf(sacc[4 * j + 2 + e], scale_log2, -mn1));
      rs0 += sacc[4 * j + e];
      rs1 += sacc[4 * j + 2 + e];
    }
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
}

// K3's softmax of one tile (TPU `_int8_fwd_body_static`): p = exp2(s - M)
// under the static bound M of this warpgroup's 64 query rows, no running
// max and no rescale
__device__ __forceinline__ void softmax_static_tile(float (&sacc)[64], int k0, int klen,
                                                    float bound, float& l0, float& l1) {
  mask_tile(sacc, k0, klen);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sacc[4 * j + e] = exp2f(sacc[4 * j + e] - bound);
      sacc[4 * j + 2 + e] = exp2f(sacc[4 * j + 2 + e] - bound);
      rs0 += sacc[4 * j + e];
      rs1 += sacc[4 * j + 2 + e];
    }
  }
  l0 += rs0;
  l1 += rs1;
}

// P as bf16 A fragments of the k16 steps over the 128 keys
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBlockN / 16][4], const float (&p)[64]) {
#pragma unroll
  for (int kq = 0; kq < kBlockN / 16; ++kq) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kq][r] = pack_bf16(p[8 * kq + 2 * r], p[8 * kq + 2 * r + 1]);
  }
}

// O += P V: A (P) from registers, V [128 keys, D] of one stage MN-major;
// issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBlockN / 16][4],
                                         uint32_t vb) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < kBlockN / 16; ++kq) {
    wgmma_rs_d<D>(o, pa[kq], make_desc(vb + kq * 16 * kRow, kBlockN * kRow, 1024));
  }
  wgmma_commit();
}

// After the wait for S: the int8 instances' s32 logits to fp32 times the
// slab scale (the TPU's `dot(int32).astype(f32) * sqk`), then the online
// softmax (K1 on the raw bf16 logits with scale_log2, K2 on the scaled
// ones) or K3's static one
template <int QK, int NI>
__device__ __forceinline__ void logits_softmax(float (&sacc)[64], int (&si)[NI], int k0, int klen,
                                               float scale_log2, float slab, float bound,
                                               float& m0, float& m1, float& l0, float& l1,
                                               float& c0, float& c1) {
  if constexpr (QK != kQkBf16) {
    fence_regs(si);
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = __int2float_rn(si[i]) * slab;
  } else {
    fence_regs(sacc);
  }
  if constexpr (QK == kQkInt8Static) {
    softmax_static_tile(sacc, k0, klen, bound, l0, l1);
  } else {
    softmax_tile(sacc, k0, klen, QK == kQkBf16 ? scale_log2 : 1.f, m0, m1, l0, l1, c0, c1);
  }
}

// `sqk` [B*N] (int8 instances): the slab scales of the int32 logits
// (sq * sk * scale * log2 e); `mstat` [B*N, ceil(Lq / 64)] (K3): the bound
// of each 64 query rows; `scale_log2` (K1): the scale of the bf16 logits
template <int D, int QK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ k_lens,
                 const float* __restrict__ sqk, const float* __restrict__ mstat,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int N,
                 float scale_log2) {
  using S = Smem<D, QK>;
  constexpr bool kInt8 = S::kInt8, kStatic = QK == kQkInt8Static;
  constexpr int kStages = S::kStages;
  constexpr int kAcc = D / 2;  // fp32 registers of a [64, D] output accumulator
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int q0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;
  const int ntiles = (max(klen, 0) + kBlockN - 1) / kBlockN;  // tiles past k_lens[b]: skipped
  const int nqb = (Lq + 63) / 64;  // K3's bounds per (batch, head): one per 64 query rows

  if (ntiles == 0) {
    // no valid key: zero rows, and the LSE of an empty row (as K4 reads it)
    const long long rs = (long long)N * D;
    for (int i = threadIdx.x; i < kBlockM * D / 2; i += kThreads) {
      const int r = i / (D / 2), c = (i % (D / 2)) * 2;
      if (q0 + r < Lq) {
        *reinterpret_cast<uint32_t*>(out + ((long long)b * Lq * N + h) * D + (q0 + r) * rs + c) =
            0u;
      }
    }
    const int r = threadIdx.x;
    if (lse != nullptr && r < kBlockM && q0 + r < Lq) {
      const float m = kStatic ? mstat[(long long)bh * nqb + (q0 + r) / 64] : kNegInf;
      lse[(long long)bh * Lq + q0 + r] = m * kLn2 + logf(1e-30f);
    }
    return;
  }

  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::off_bar);  // Q landed
  uint64_t* k_full = q_full + 1;         // K of stage s landed
  uint64_t* v_full = k_full + kStages;   // V of stage s landed
  uint64_t* empty = v_full + kStages;    // both consumer warpgroups are done with stage s
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {
    // ---------------- producer warpgroup: one thread issues every load
    SA_SETMAXNREG_DEC(24);
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(q_full, S::kQ);
#pragma unroll
      for (int p = 0; p < S::kQKParts; ++p) {
        tma_load_3d(sm + S::off_q + p * kBlockM * S::kQKRow, &tm_q, q_full, h * D + p * 64, q0,
                    b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages, k0 = it * kBlockN;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], S::kK);
#pragma unroll
        for (int p = 0; p < S::kQKParts; ++p) {
          tma_load_3d(sm + S::off_k + s * S::kK + p * kBlockN * S::kQKRow, &tm_k, &k_full[s],
                      h * D + p * 64, k0, b);
        }
        mbar_arrive_expect_tx(&v_full[s], S::kV);
#pragma unroll
        for (int hf = 0; hf < S::kVHalves; ++hf) {
          tma_load_3d(sm + S::off_v + s * S::kV + hf * kBlockN * kRow, &tm_v, &v_full[s],
                      h * D + hf * 64, k0, b);
        }
      }
    }
  } else {
    // ---------------- two consumer warpgroups of 64 query rows each
    SA_SETMAXNREG_INC(240);
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row_a = q0 + wg * 64 + wl * 16 + g, row_b = row_a + 8;
    const uint32_t q_wg = smem_u32(sm + S::off_q) + wg * 64 * S::kQKRow;  // this warpgroup's rows
    // the int8 logits leave the tensor cores unscaled; K3's bound is this
    // warpgroup's (its 64 rows are one 64-row block of the bound)
    const float slab = kInt8 ? sqk[bh] : 0.f;
    const int qb = blockIdx.x * 2 + wg;
    const float bound = kStatic && qb < nqb ? mstat[(long long)bh * nqb + qb] : 0.f;

    float o[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    // base-2 running max (scaled logits) and this thread's partial row sum
    // of rows g and g + 8
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // S of tile it + 1 is issued before P V of tile it, and its softmax runs
    // while that product is on the tensor cores
    float sacc[64], c0 = 1.f, c1 = 1.f;
    int si[kInt8 ? 64 : 1];  // the int8 instances' s32 logits
    uint32_t pa[kBlockN / 16][4];
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    if constexpr (kInt8) {
      issue_qk_s8<D>(si, q_wg, smem_u32(sm + S::off_k));
    } else {
      issue_qk<D>(sacc, q_wg, smem_u32(sm + S::off_k));
    }
    wgmma_wait<0>();
    logits_softmax<QK>(sacc, si, 0, klen, scale_log2, slab, bound, m0, m1, l0, l1, c0,
                       c1);  // O is 0: no rescale
    pack_p(pa, sacc);
    for (int it = 0; it < ntiles - 1; ++it) {
      const int s = it % kStages, s1 = (it + 1) % kStages;
      mbar_wait(&k_full[s1], ((it + 1) / kStages) & 1);
      if constexpr (kInt8) {
        issue_qk_s8<D>(si, q_wg, smem_u32(sm + S::off_k + s1 * S::kK));
      } else {
        issue_qk<D>(sacc, q_wg, smem_u32(sm + S::off_k + s1 * S::kK));
      }
      mbar_wait(&v_full[s], (it / kStages) & 1);
      issue_pv<D>(o, pa, smem_u32(sm + S::off_v + s * S::kV));
      wgmma_wait<1>();  // S of tile it + 1 (committed first) is done
      logits_softmax<QK>(sacc, si, (it + 1) * kBlockN, klen, scale_log2, slab, bound, m0, m1,
                         l0, l1, c0, c1);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kq = 0; kq < kBlockN / 16; ++kq) fence_regs(pa[kq]);  // read until here
      mbar_arrive(&empty[s]);  // K and V of stage s are read
      if constexpr (!kStatic) {
#pragma unroll
        for (int i = 0; i < kAcc / 4; ++i) {
          o[4 * i] *= c0;
          o[4 * i + 1] *= c0;
          o[4 * i + 2] *= c1;
          o[4 * i + 3] *= c1;
        }
      }
      pack_p(pa, sacc);
    }
    const int s_last = (ntiles - 1) % kStages;
    mbar_wait(&v_full[s_last], ((ntiles - 1) / kStages) & 1);
    issue_pv<D>(o, pa, smem_u32(sm + S::off_v + s_last * S::kV));
    wgmma_wait<0>();
    fence_regs(o);

    const float lf0 = fmaxf(quad_sum(l0), 1e-30f), lf1 = fmaxf(quad_sum(l1), 1e-30f);
    const long long rs = (long long)N * D;
    __nv_bfloat16* ob = out + ((long long)b * Lq * N + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      if (row_a < Lq) {
        *reinterpret_cast<uint32_t*>(ob + row_a * rs + c) =
            pack_bf16(o[4 * j] / lf0, o[4 * j + 1] / lf0);
      }
      if (row_b < Lq) {
        *reinterpret_cast<uint32_t*>(ob + row_b * rs + c) =
            pack_bf16(o[4 * j + 2] / lf1, o[4 * j + 3] / lf1);
      }
    }
    if (lse != nullptr && t == 0) {
      // K3's M is its bound; the others' the running max
      float* lse_bh = lse + (long long)bh * Lq;
      if (row_a < Lq) lse_bh[row_a] = (kStatic ? bound : m0) * kLn2 + logf(lf0);
      if (row_b < Lq) lse_bh[row_b] = (kStatic ? bound : m1) * kLn2 + logf(lf1);
    }
  }
}

}  // namespace ffwd

// V path of the int8-V kernels (template parameter); K2 and K3-qk (bf16 V)
// are instances of ffwd::flash_fwd_kernel above.
enum VMode {
  kVInt8 = 1,  // K2v-qkv / K3-qkv: int8 V widened to bf16 for the P.V product
  kPV8 = 2,    // K2v-qkpv: P quantised per row to its key-block max, int8 P.V into s32
};

// K3's softmax for one key tile: p = exp2(s - M) under the static bound M of
// this block's query rows, no running max and no rescale (TPU
// `_int8_fwd_body_static`).  Keys at or past `klen` are masked.
__device__ __forceinline__ void softmax_static(float (&s)[kNT][4], float bound, float (&l)[2],
                                               int k0, int klen) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = k0 + nt * 8 + t * 2 + e >= klen;
      s[nt][e] = exp2f((masked ? kNegInf : s[nt][e]) - bound);
      s[nt][2 + e] = exp2f((masked ? kNegInf : s[nt][2 + e]) - bound);
      l[0] += s[nt][e];
      l[1] += s[nt][2 + e];
    }
  }
}

// K2v-qkpv, first sweep: fold this tile's masked logits into the running
// row maxima mx (per thread; the caller reduces them over the quad).
__device__ __forceinline__ void tile_row_max(const float (&s)[kNT][4], float (&mx)[2], int k0,
                                             int klen) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (k0 + nt * 8 + t * 2 + e < klen) {
        mx[0] = fmaxf(mx[0], s[nt][e]);
        mx[1] = fmaxf(mx[1], s[nt][2 + e]);
      }
    }
  }
}

// K2v-qkpv, second sweep (TPU `_int8_fwd_body`, `quant_pv`): `s` leaves as
// p_rel = exp2(s - m_block) with m_block the row max over the whole key
// block (masked keys 0), and the row sum gains sum(p_rel) * f_raw with
// f_raw = exp2(m_block - m_new), the block's factor.
__device__ __forceinline__ void softmax_pv8(float (&s)[kNT][4], const float (&mb)[2],
                                            const float (&f_raw)[2], float (&l)[2], int k0,
                                            int klen) {
  const int t = threadIdx.x & 3;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = k0 + nt * 8 + t * 2 + e >= klen;
      s[nt][e] = masked ? 0.f : exp2f(s[nt][e] - mb[0]);
      s[nt][2 + e] = masked ? 0.f : exp2f(s[nt][2 + e] - mb[1]);
      rs0 += s[nt][e];
      rs1 += s[nt][2 + e];
    }
  }
  l[0] += rs0 * f_raw[0];
  l[1] += rs1 * f_raw[1];
}

// acc[16, D] += bf16(P[16, 64]) . bf16(V8_tile[64, D]): as pv_bf16, with V
// int8 in shared memory (int8 values are exact in bf16).
template <int D>
__device__ __forceinline__ void pv_int8_bf16(float (&acc)[D / 8][4], const float (&p)[kNT][4],
                                             const int8_t* Vs) {
  constexpr int kPitch = D + 16;  // bytes
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBlockK / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const int8_t* v0 = Vs + (j * 16 + t * 2) * kPitch + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int8_t* vc = v0 + nd * 8;
      mma_bf16_16816(acc[nd], pa, pack_bf16(float(vc[0]), float(vc[kPitch])),
                     pack_bf16(float(vc[8 * kPitch]), float(vc[9 * kPitch])));
    }
  }
}

// four int8 -> one register, the first in the low byte (mma fragment order)
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t(a) & 0xffu) | ((uint32_t(b) & 0xffu) << 8) | ((uint32_t(c) & 0xffu) << 16) |
         (uint32_t(d) & 0xffu) << 24;
}

// p8 = clamp(round_half_even(127 p), 0, 127)
__device__ __forceinline__ int quant_p(float p) { return min(max(__float2int_rn(p * 127.f), 0), 127); }

// acc[16, D] += (int8(P) . V8_tile) * f on the s8 tensor cores (m16n8k32,
// s32 sums).  P's A fragments come from the logit C fragments of four
// neighbouring n-tiles, so the 32 keys of a k-step are taken in a permuted
// order: A column 4t + i (and 16 + 4t + i) holds key (i / 2) * 8 + 2t + i % 2
// (and 16 + that), the keys thread t already holds; V's B fragments read
// their rows in the same order.  The sum over keys does not depend on it.
template <int D>
__device__ __forceinline__ void pv_int8(float (&acc)[D / 8][4], const float (&p)[kNT][4],
                                        const int8_t* Vs, const float (&f)[2]) {
  constexpr int kPitch = D + 16;  // bytes
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int pv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) pv[nd][0] = pv[nd][1] = pv[nd][2] = pv[nd][3] = 0;
#pragma unroll
  for (int j = 0; j < kBlockK / 32; ++j) {
    const float(&p0)[4] = p[4 * j], (&p1)[4] = p[4 * j + 1];
    const float(&p2)[4] = p[4 * j + 2], (&p3)[4] = p[4 * j + 3];
    const uint32_t pa[4] = {
        pack_s8(quant_p(p0[0]), quant_p(p0[1]), quant_p(p1[0]), quant_p(p1[1])),
        pack_s8(quant_p(p0[2]), quant_p(p0[3]), quant_p(p1[2]), quant_p(p1[3])),
        pack_s8(quant_p(p2[0]), quant_p(p2[1]), quant_p(p3[0]), quant_p(p3[1])),
        pack_s8(quant_p(p2[2]), quant_p(p2[3]), quant_p(p3[2]), quant_p(p3[3]))};
    const int8_t* v0 = Vs + (j * 32 + t * 2) * kPitch + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int8_t* vc = v0 + nd * 8;
      const uint32_t b0 = pack_s8(vc[0], vc[kPitch], vc[8 * kPitch], vc[9 * kPitch]);
      const uint32_t b1 =
          pack_s8(vc[16 * kPitch], vc[17 * kPitch], vc[24 * kPitch], vc[25 * kPitch]);
      mma_s8_16832(pv[nd], pa, b0, b1);
    }
  }
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] += float(pv[nd][0]) * f[0];
    acc[nd][1] += float(pv[nd][1]) * f[0];
    acc[nd][2] += float(pv[nd][2]) * f[1];
    acc[nd][3] += float(pv[nd][3]) * f[1];
  }
}

// S[16, 64] = Q8[16, D] . K8_tile[64, D]^T on the s8 tensor cores, times
// the slab scale (int32 -> fp32: the products are integers).
template <int D>
__device__ __forceinline__ void qk_int8(float (&s)[kNT][4], const uint32_t (&qa)[D / 32][4],
                                        const int8_t* Ks, float scale) {
  constexpr int kPitch8 = D + 16;  // bytes
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int si[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) si[nt][0] = si[nt][1] = si[nt][2] = si[nt][3] = 0;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int8_t* kr = Ks + (nt * 8 + g) * kPitch8 + kk * 32 + t * 4;
      mma_s8_16832(si[nt], qa[kk], ld32(kr), ld32(kr + 16));
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    s[nt][0] = float(si[nt][0]) * scale;
    s[nt][1] = float(si[nt][1]) * scale;
    s[nt][2] = float(si[nt][2]) * scale;
    s[nt][3] = float(si[nt][3]) * scale;
  }
}

// The int8-V flash forward on mma.sync: K2v (kVInt8 / kPV8, online) and
// K3-qkv (kVInt8, STATIC).  `sv` [B, N, D] scales the int8 V at
// finalize; `mstat` [B*N, Lq / 64 blocks] is K3's bound; `pv_block` is
// kPV8's quantisation block in keys (a multiple of kBlockK); `lse` (may be
// null) receives m * ln2 + log(max(l, 1e-30)) as [B, N, Lq] -- K2-LSE, or
// K3's M * ln2 + log(l).
// At most 168 registers a thread (3 blocks of 128 threads on an SM's 65,536):
// at 173 the online K2v-qkv instance fell to 2 blocks per SM and ran 8.7%
// slower than at 168 (profile_window.py kernels, NVIDIA H100 80GB HBM3).
template <int D, int VMODE, bool STATIC>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_int8v_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                       const int8_t* __restrict__ v8, const float* __restrict__ sv,
                       const float* __restrict__ sqk, const float* __restrict__ mstat,
                       const int* __restrict__ k_lens, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Lq, int Lk, int N, int pv_block) {
  constexpr int kPitch8 = D + 16;  // bytes
  __shared__ __align__(16) int8_t Ks[kBlockK * kPitch8];
  __shared__ __align__(16) int8_t Vs[kBlockK * kPitch8];

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + g, row_b = row_a + 8;
  const long long rs = (long long)N * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;
  const float scale = sqk[bh];
  const float bound = STATIC ? mstat[(long long)bh * gridDim.x + blockIdx.x] : 0.f;

  // int8 A fragments (m16n8k32): 4 consecutive int8 per register
  uint32_t qa[D / 32][4];
  const int8_t* qb = q8 + ((long long)b * Lq * N + h) * D;
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int c = kk * 32 + t * 4;
    qa[kk][0] = row_a < Lq ? ld32(qb + row_a * rs + c) : 0u;
    qa[kk][1] = row_b < Lq ? ld32(qb + row_b * rs + c) : 0u;
    qa[kk][2] = row_a < Lq ? ld32(qb + row_a * rs + c + 16) : 0u;
    qa[kk][3] = row_b < Lq ? ld32(qb + row_b * rs + c + 16) : 0u;
  }

  const char* kb = reinterpret_cast<const char*>(k8 + ((long long)b * Lk * N + h) * D);
  const char* vb = reinterpret_cast<const char*>(v8 + ((long long)b * Lk * N + h) * D);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  // tiles (and kPV8's blocks) wholly past klen are skipped: their mass is 0
  const int ntiles = (klen + kBlockK - 1) / kBlockK;
  float mb[2], f_raw[2], f[2];  // kPV8: the block's row max and factors
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    if constexpr (VMODE == kPV8) {
      if (k0 % pv_block == 0) {
        // a new quantisation block: first sweep for the row max of its
        // masked logits, then rescale acc and l once to the new running max
        const int t1 = min(ntiles, it + pv_block / kBlockK);
        float mx[2] = {kNegInf, kNegInf};
        for (int jt = it; jt < t1; ++jt) {
          load_tile<D>(reinterpret_cast<char*>(Ks), kb, rs, jt * kBlockK, Lk);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          float s[kNT][4];
          qk_int8<D>(s, qa, Ks, scale);
          tile_row_max(s, mx, jt * kBlockK, klen);
          __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[r], mx[r]);
          const float c = exp2f(m[r] - mn);
          l[r] *= c;
#pragma unroll
          for (int nd = 0; nd < D / 8; ++nd) {
            acc[nd][2 * r] *= c;
            acc[nd][2 * r + 1] *= c;
          }
          m[r] = mn;
          mb[r] = mx[r];
          f_raw[r] = exp2f(mx[r] - mn);
          f[r] = f_raw[r] * (1.f / 127.f);
        }
      }
    }
    load_tile<D>(reinterpret_cast<char*>(Ks), kb, rs, k0, Lk);
    cp_async_commit();
    load_tile<D>(reinterpret_cast<char*>(Vs), vb, rs, k0, Lk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[kNT][4];
    qk_int8<D>(s, qa, Ks, scale);
    if constexpr (STATIC) {
      softmax_static(s, bound, l, k0, klen);
    } else if constexpr (VMODE == kPV8) {
      softmax_pv8(s, mb, f_raw, l, k0, klen);
    } else {
      softmax_update<D>(s, m, l, acc, k0, klen);
    }

    cp_async_wait<0>();
    __syncthreads();
    if constexpr (VMODE == kVInt8) {
      pv_int8_bf16<D>(acc, s, Vs);
    } else {
      pv_int8<D>(acc, s, Vs, f);
    }
    __syncthreads();
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const float* svb = sv + (long long)bh * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] /= l0;
    acc[nd][1] /= l0;
    acc[nd][2] /= l1;
    acc[nd][3] /= l1;
    const int c = nd * 8 + t * 2;
    acc[nd][0] *= svb[c];
    acc[nd][1] *= svb[c + 1];
    acc[nd][2] *= svb[c];
    acc[nd][3] *= svb[c + 1];
  }
  store_rows<D>(out + ((long long)b * Lq * N + h) * D, rs, row_a, Lq, acc);
  if (lse != nullptr && t == 0) {
    // the running max m is shared by the quad (reduced before every update);
    // K3's M is the block's bound
    const float m0 = STATIC ? bound : m[0], m1 = STATIC ? bound : m[1];
    float* lse_bh = lse + (long long)bh * Lq;
    if (row_a < Lq) lse_bh[row_a] = m0 * kLn2 + logf(l0);
    if (row_b < Lq) lse_bh[row_b] = m1 * kLn2 + logf(l1);
  }
}

}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().  k_lens may be NULL
// (every key valid), and so may lse (no LSE output).
// --------------------------------------------------------------------------

namespace {

// K1 (QK = kQkBf16: q, k bf16) or K2 / K3-qk (q8, k8 int8 with the slab
// scales sqk, and K3's bounds mstat); v bf16
template <int D, int QK>
int launch_fwd(const void* q, const void* k, const void* v, const void* k_lens, const void* sqk,
               const void* mstat, void* out, void* lse, int B, int Lq, int Lk, int N,
               float scale_log2, cudaStream_t st) {
  using namespace sa::ffwd;
  using S = Smem<D, QK>;
  CUtensorMap mq, mk, mv;
  const bool ok = S::kInt8 ? sa::make_map_s8(&mq, q, B, Lq, N * D, kBlockM, D) &&
                                 sa::make_map_s8(&mk, k, B, Lk, N * D, kBlockN, D)
                           : sa::make_map(&mq, q, B, Lq, N * D, kBlockM) &&
                                 sa::make_map(&mk, k, B, Lk, N * D, kBlockN);
  if (!ok || !sa::make_map(&mv, v, B, Lk, N * D, kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = S::launch_bytes;
  int rc;
  if ((rc = sa::allow_smem(flash_fwd_kernel<D, QK>, smem))) return rc;
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, B * N);
  flash_fwd_kernel<D, QK><<<grid, kThreads, smem, st>>>(
      mq, mk, mv, static_cast<const int*>(k_lens), static_cast<const float*>(sqk),
      static_cast<const float*>(mstat), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Lq, Lk, N, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int QK>
int launch_fwd_d(const void* q, const void* k, const void* v, const void* k_lens,
                 const void* sqk, const void* mstat, void* out, void* lse, int B, int Lq, int Lk,
                 int N, int D, float scale_log2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return launch_fwd<128, QK>(q, k, v, k_lens, sqk, mstat, out, lse, B, Lq, Lk, N, scale_log2,
                               st);
  }
  if (D == 64) {
    return launch_fwd<64, QK>(q, k, v, k_lens, sqk, mstat, out, lse, B, Lq, Lk, N, scale_log2,
                              st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K1 (K1-LSE with a non-null lse [B, N, Lq]); q and k roped by the caller.
// Global rows must be 16-byte multiples (N * D * 2) and the tensors
// 16-byte aligned (TMA).
extern "C" int sa_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* k_lens,
                                 void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                 float scale_log2, void* stream) {
  return launch_fwd_d<sa::ffwd::kQkBf16>(q, k, v, k_lens, nullptr, nullptr, out, lse, B, Lq, Lk,
                                         N, D, scale_log2, stream);
}

// K1-rope: q and k in split-pair layout, rotated in the kernel by the packed
// fp32 table rope [L, D] (L >= Lq and L >= Lk; row i is position i)
extern "C" int sa_flash_fwd_bf16_rope(const void* q, const void* k, const void* v,
                                      const void* k_lens, const void* rope, void* out, void* lse,
                                      int B, int Lq, int Lk, int N, int D, float scale_log2,
                                      void* stream) {
  if (rope == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k_ = static_cast<const __nv_bfloat16*>(k);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto kl = static_cast<const int*>(k_lens);
  auto r_ = static_cast<const float*>(rope);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  auto lse_ = static_cast<float*>(lse);
  if (D == 128) {
    sa::flash_fwd_bf16_rope_kernel<128><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v_, kl, r_, o_, lse_, Lq, Lk, N, scale_log2);
  } else if (D == 64) {
    sa::flash_fwd_bf16_rope_kernel<64><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v_, kl, r_, o_, lse_, Lq, Lk, N, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// the int8-V instances of the mma.sync template
template <int VMODE, bool STATIC>
int launch_int8v(const void* q8, const void* k8, const void* v8, const void* sv, const void* sqk,
                 const void* mstat, const void* k_lens, void* out, void* lse, int B, int Lq,
                 int Lk, int N, int D, int pv_block, void* stream) {
  if (VMODE == sa::kPV8 && (pv_block <= 0 || pv_block % sa::kBlockK != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const int8_t*>(q8);
  auto k_ = static_cast<const int8_t*>(k8);
  auto v_ = static_cast<const int8_t*>(v8);
  auto sv_ = static_cast<const float*>(sv);
  auto s_ = static_cast<const float*>(sqk);
  auto ms_ = static_cast<const float*>(mstat);
  auto kl = static_cast<const int*>(k_lens);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  auto lse_ = static_cast<float*>(lse);
  if (D == 128) {
    sa::flash_fwd_int8v_kernel<128, VMODE, STATIC><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v_, sv_, s_, ms_, kl, o_, lse_, Lq, Lk, N, pv_block);
  } else if (D == 64) {
    sa::flash_fwd_int8v_kernel<64, VMODE, STATIC><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v_, sv_, s_, ms_, kl, o_, lse_, Lq, Lk, N, pv_block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 (and K2-LSE with a non-null lse [B, N, Lq]): bf16 V, on the wgmma
// kernel
extern "C" int sa_flash_fwd_int8_qk(const void* q8, const void* k8, const void* v,
                                    const void* sqk, const void* k_lens, void* out, void* lse,
                                    int B, int Lq, int Lk, int N, int D, void* stream) {
  return launch_fwd_d<sa::ffwd::kQkInt8>(q8, k8, v, k_lens, sqk, nullptr, out, lse, B, Lq, Lk, N,
                                         D, 0.f, stream);
}

// K2v-qkv: int8 V [B, Lk, N, D] with per-channel scales sv [B, N, D]
extern "C" int sa_flash_fwd_int8_qkv(const void* q8, const void* k8, const void* v8,
                                     const void* sv, const void* sqk, const void* k_lens,
                                     void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                     void* stream) {
  return launch_int8v<sa::kVInt8, false>(q8, k8, v8, sv, sqk, nullptr, k_lens, out, lse, B, Lq,
                                         Lk, N, D, 0, stream);
}

// K2v-qkpv: as qkv, with P quantised to int8 per row against its maximum
// over each block of pv_block keys (a positive multiple of 64)
extern "C" int sa_flash_fwd_int8_qkpv(const void* q8, const void* k8, const void* v8,
                                      const void* sv, const void* sqk, const void* k_lens,
                                      void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                      int pv_block, void* stream) {
  return launch_int8v<sa::kPV8, false>(q8, k8, v8, sv, sqk, nullptr, k_lens, out, lse, B, Lq, Lk,
                                       N, D, pv_block, stream);
}

// K3 with bf16 V, on the wgmma kernel; mstat [B*N, ceil(Lq / 64)], lse
// [B, N, Lq] or NULL
extern "C" int sa_flash_fwd_int8_static_qk(const void* q8, const void* k8, const void* v,
                                           const void* sqk, const void* mstat,
                                           const void* k_lens, void* out, void* lse, int B,
                                           int Lq, int Lk, int N, int D, void* stream) {
  return launch_fwd_d<sa::ffwd::kQkInt8Static>(q8, k8, v, k_lens, sqk, mstat, out, lse, B, Lq,
                                               Lk, N, D, 0.f, stream);
}

// K3 with int8 V and its scales
extern "C" int sa_flash_fwd_int8_static_qkv(const void* q8, const void* k8, const void* v8,
                                            const void* sv, const void* sqk, const void* mstat,
                                            const void* k_lens, void* out, void* lse, int B,
                                            int Lq, int Lk, int N, int D, void* stream) {
  return launch_int8v<sa::kVInt8, true>(q8, k8, v8, sv, sqk, mstat, k_lens, out, lse, B, Lq, Lk,
                                        N, D, 0, stream);
}

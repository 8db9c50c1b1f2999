// Flash-attention forward kernels for Hopper (sm_90a): K1 (bf16), K2 (int8
// Q.K^T), K2v (int8 V) and K3 (static-bound softmax), and the S3 probe.
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
//   - K2v "qkv" (`v_int8` branch): V int8, widened to bf16 for the P.V
//     product (int8 values are exact in bf16), its per-channel scale sv
//     applied once at finalize, before the single bf16 rounding; K3-qkv the
//     same under the static bound;
//   - K2v "qkpv" (`quant_pv` branch): P rescaled to its row max within the
//     JAX package's key block (`pv_block` keys, a multiple of 64: 1536 or
//     1024 capped to the sequence rounded up to 128), rounded to int8 and
//     multiplied with int8 V into s32 summed over the whole block (as the
//     TPU sums it), times exp2(m_block - m_new) / 127.
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
// 4.3 ms for qkpv (both products int8), with the softmax's exp2 on the SFUs
// (64 per thread and key tile) as the next limit.  The first designs (4
// warps of warp-level m16n8k16 products over 64-key tiles, one cp.async
// stage, two block barriers a tile) ran at a fifth of that.  So every
// instance is one Hopper design (`ffwd::flash_fwd_kernel<D, QK, VM>`, D =
// 128 and 64; QK = bf16, int8 or int8 under the static bound; VM = the V
// path: bf16, int8 widened, or int8 P.V):
//
// - a block owns 128 query rows of one (batch, head); one producer thread
//   (a warpgroup with its registers handed over by setmaxnreg, 24 / 240)
//   loads the block's Q once and streams 128-key K and V tiles through a
//   ring in dynamic shared memory (TMA from 3-D tensor maps over
//   [B, L, N * D], rows past L read as zeros; K and V of a stage complete on
//   mbarriers of their own, and an `empty` mbarrier hands the stage back).
//   bf16: 128-byte swizzle, 3 stages, 224 KB at D = 128.  int8: Q8 and K8
//   rows of D bytes in the 128-byte swizzle, or at D = 64 the 64-byte one
//   (8 rows in 512 bytes, its own descriptor layout); bf16 V: 4 stages (16
//   KB of Q8 plus 48 KB a stage: 208 KB at D = 128);
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
// - int8 V (qkv, K3-qkv): V8 lands by TMA unswizzled, [128 keys, D] bytes,
//   and the producer warpgroup's three idle warps widen it into a bf16 tile
//   in the 128-byte swizzle -- the layout K1's V has -- then signal the
//   stage's V mbarrier (16 channels a thread at a time: a 16-byte load,
//   8 x (byte permute, two masks, one bf16x2 subtraction), two 16-byte
//   stores, free of bank conflicts).  The consumers are K2's / K3-qk's,
//   unchanged.  3 stages of K8 16 + V8 16 + bf16 V 32 KB (208 KB at D =
//   128).  The widening and the turn below need more than 24 registers (at
//   24 they spilled), so the int8-V instances hand over 40 / 232;
// - int8 P.V (qkpv): s8 wgmma takes 8-bit operands K-major only, and int8 V
//   is the B operand of P.V with D contiguous.  The turn is made in shared
//   memory (not by a layout pass in the wrapper, which would add a read and
//   a write of V8 to every call): the three idle warps turn each raw V8
//   tile into [D, 128 keys] in the 128-byte swizzle (mm_probe's turn, lane l
//   on n-word l and key word (l / 2) ^ c, conflict-free stores).  P's A
//   fragments come from the s32 logits' accumulator layout, in which thread
//   t of a quad holds keys 8j + 2t + {0, 1}; an 8-bit A fragment wants keys
//   4t..4t + 3 of each 16.  So A column 4t + i (and 16 + 4t + i) of a k32
//   step holds key 2t + {0, 1, 8, 9}[i] (and 16 + that), and the turn
//   writes V8's rows in the same order: the permutation costs nothing (the
//   sum over keys does not depend on it).  Each `pv_block` is swept twice:
//   sweep 1 runs Q8 K8^T only and takes the block's row max on the integer
//   logits (the slab scale is positive, so it commutes with the max; the
//   producer streams only K for it), sweep 2 recomputes Q8 K8^T, quantises
//   P into s8 A fragments in registers (127 p rounded half to even by a
//   multiply and an add of 1.5 * 2^23, the byte taken from the sum) and runs
//   a register-A s8 wgmma m64n{D}k32 into an s32 accumulator kept across the
//   block's tiles, converted once at the block's end as the TPU converts
//   it.  O (64), the s32 sum (64), S (64) and P8 (16 registers) stay live
//   together, so P of tile j + 1 is quantised after P V of tile j is done
//   (quantising it into a second P8 while that product ran spilled and
//   serialised the wgmmas).  K and V have rings of their own (4 stages
//   each; 208 KB at D = 128); a block of 64 keys (or any pv_block % 128 ==
//   64) splits a key tile, so each block masks keys outside its own range;
// - zero fill is not a mask (a zero key has logit 0): keys at or past
//   k_lens[b] (and Lk) get p = 0 in the kernel, tiles wholly past
//   k_lens[b] are not loaded (a block with none writes zero rows and the LSE
//   of an empty row), and rows past Lq are neither stored nor given an LSE.
//   K3's bound is per 64 query rows, so each consumer warpgroup reads its
//   own.  No atomics: two launches agree bit for bit.
//
// S3, the dots probe (`sa_dots_probe`, scripts/bench_attn_blocks.py:
// dots_only / int8_dots_only), is two more instances, QK = kQkBf16Dots and
// kQkInt8Dots with bf16 V: K1's or K2's producer, ring and consumers with
// the softmax taken out -- P = bf16(S), or bf16(float(S >> 7)) of the s32
// logits, no running max, no row sum, no divide, no mask (zero-filled keys
// give P = 0 against zero-filled V).  So K1 - S3 bf16 and K2 - S3 int8 are
// the softmax's share of the template's time.
//
// K1-rope (`flash_attention(rope=)`) is no kernel of its own: the
// split-pair rotation of `_fwd_body`'s `rope=` branch (`_rot`, :142-143)
// depends only on the position, so rope.cu's `sa_rope_rotate` rotates q and
// k once (fp32, one bf16 rounding, as `_rot(...).astype(dt)` does) and the
// K1 instance below runs on the rotated copies.
#include "hopper_common.cuh"

namespace sa {

// --------------------------------------------------------------------------
// K1, K1-LSE, K2, K2v, K2-LSE and K3: one producer warpgroup feeds a TMA
// ring, two consumer warpgroups run wgmma
// --------------------------------------------------------------------------

namespace ffwd {

constexpr int kBlockM = 128;   // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;   // keys per K / V tile
constexpr int kConsumers = 256;
constexpr int kTurners = 96;   // the producer warpgroup's warps 9-11 (int8 V)
constexpr int kThreads = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int kRow = 128;      // bytes of one swizzled bf16 row (64 bf16)

// Q.K^T and the softmax of an instance (template parameter)
enum Qk {
  kQkBf16 = 0,        // K1: bf16 Q, K; online softmax
  kQkInt8 = 1,        // K2: int8 Q8, K8 on the s8 tensor cores, times sqk; online softmax
  kQkInt8Static = 2,  // K3-qk: as K2 under K3's static bound, no running max
  kQkBf16Dots = 3,    // S3 bf16: K1's Q.K^T, P = bf16(S), no softmax
  kQkInt8Dots = 4,    // S3 int8: K2's Q8.K8^T, P = bf16(float(S >> 7)), no softmax
};

// Q and K arrive as int8 (the s8 tensor-core instances)
constexpr bool int8_qk(int qk) { return qk == kQkInt8 || qk == kQkInt8Static || qk == kQkInt8Dots; }

// the V path of an instance (template parameter)
enum Vm {
  kVBf16 = 0,  // K1, K2, K3-qk: bf16 V by TMA
  kVInt8 = 1,  // K2v-qkv, K3-qkv: int8 V widened to bf16 in shared memory, scaled at finalize
  kVPv8 = 2,   // K2v-qkpv: P quantised per key block, int8 P.V on the s8 tensor cores
};

// shared-memory layout (byte offsets from a 1024-byte boundary); every
// swizzled operand starts on a 1024-byte boundary
template <int D, int QK, int VM>
struct Smem {
  static constexpr bool kInt8 = int8_qk(QK);
  // S runs a tile ahead of P V: at least 3 stages.  K8 is half the bytes of
  // a bf16 K, so int8 fits a fourth (208 KB at D = 128): K2 ran 1% faster
  // with it than with 3 on the H100 (PERF.md).  qkv's widened V takes 32 KB
  // more a stage: 3 (208 KB).  qkpv: 4 K8 and 4 V8 stages (208 KB)
  static constexpr int kStages = kInt8 && VM != kVInt8 ? 4 : 3;
  static constexpr int kQKRow = kInt8 ? D : kRow;     // bytes of a swizzled Q / K row
  static constexpr int kQKParts = kInt8 ? 1 : D / 64;  // swizzled column tiles of Q / K
  static constexpr int kVHalves = D / 64;
  static constexpr int kQ = kQKParts * kBlockM * kQKRow;  // the block's Q
  static constexpr int kK = kQKParts * kBlockN * kQKRow;  // one K stage
  // one V stage as wgmma reads it: bf16 [128 keys, D] MN-major, or qkpv's
  // turned V8 [D, 128 keys] K-major
  static constexpr int kV = VM == kVPv8 ? D * kBlockN : kVHalves * kBlockN * kRow;
  static constexpr int kVRaw = VM == kVBf16 ? 0 : kBlockN * D;  // one raw V8 tile
  static constexpr int off_q = 0;
  static constexpr int off_k = off_q + kQ;
  static constexpr int off_v = off_k + kStages * kK;
  static constexpr int off_raw = off_v + kStages * kV;
  static constexpr int off_bar = off_raw + kStages * kVRaw;
  // q_full, then per stage k_full, v_full, empty (and raw_full for int8 V,
  // v_empty for qkpv)
  static constexpr int kBars = 1 + (VM == kVBf16 ? 3 : VM == kVInt8 ? 4 : 5) * kStages;
  static constexpr int bytes = off_bar + kBars * 8;
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
  if constexpr (QK == kQkBf16Dots) {
    fence_regs(sacc);  // S3: P is S itself (rounded by the packing)
  } else if constexpr (QK == kQkInt8Dots) {
    fence_regs(si);  // exact: |S >> 7| < 2^24
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = __int2float_rn(si[i] >> 7);
  } else {
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
}

// ---------------- int8 V (qkv, K3-qkv): V8 widened to bf16 in shared memory

// bytes b0, b1 of w (picked by `sel`, 0x4140 for bytes 0-1, 0x4342 for 2-3)
// as two bf16, exactly: 0x43nn with nn = b & 0x7f is 128 + (b & 0x7f), and
// 0x43nn with nn = b & 0x80 is 128 (b >= 0) or 256 (b < 0); their
// difference is b
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43434343u, sel);
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(p & 0x437f437fu), "r"(p & 0x43804380u));
  return r;
}

// raw V8 [128 keys, D] (unswizzled rows of D bytes) -> bf16 V as K1 has it:
// D / 64 tiles of [128 keys, 64] in the 128-byte swizzle.  The kTurners
// threads take 16 channels of a key at a time (a 16-byte load, two 16-byte
// stores).  At D = 128 a quarter-warp takes 64 channels of rows r and
// r + 1 from opposite column tiles: its loads cover 128 bytes of distinct
// banks, and its stores land in chunks of opposite parity, so neither
// conflicts; at D = 64 a quarter-warp takes rows r and r + 1 whole
template <int D>
__device__ __forceinline__ void widen_v8(unsigned char* vb, const unsigned char* raw, int tid) {
  for (int u = tid; u < kBlockN * D / 16; u += kTurners) {
    int r, h, c;  // key, 64-channel column tile, 16-channel chunk of it
    if constexpr (D == 128) {
      const int v = u & 15, a = (v >> 2) & 1;
      r = 2 * (u >> 4) + a;
      h = a ^ (v >> 3);
      c = v & 3;
    } else {
      r = u >> 2;
      h = 0;
      c = u & 3;
    }
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * D + h * 64 + c * 16);
    uint4 lo, hi;
    lo.x = s8x2_to_bf16x2(w.x, 0x4140);
    lo.y = s8x2_to_bf16x2(w.x, 0x4342);
    lo.z = s8x2_to_bf16x2(w.y, 0x4140);
    lo.w = s8x2_to_bf16x2(w.y, 0x4342);
    hi.x = s8x2_to_bf16x2(w.z, 0x4140);
    hi.y = s8x2_to_bf16x2(w.z, 0x4342);
    hi.z = s8x2_to_bf16x2(w.w, 0x4140);
    hi.w = s8x2_to_bf16x2(w.w, 0x4342);
    unsigned char* row = vb + h * kBlockN * kRow + r * kRow;
    *reinterpret_cast<uint4*>(row + (((2 * c) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// ---------------- int8 P.V (qkpv)

// raw V8 [128 keys, D] -> the K-major B operand [D, 128 keys] in the
// 128-byte swizzle (16-byte chunk c of row n at c ^ (n % 8)), with the keys
// of each 32-key k-step in P's A-fragment order: 4-byte key word kw holds
// keys 32 (kw / 8) + 16 ((kw / 4) % 2) + 2 (kw % 4) + {0, 1, 8, 9}.  Warp
// `tw` (0-2) of the turners takes the sweeps i = tw, tw + 3, ...; lane l
// turns the 4 x 4 bytes of n-word l (l % 16 at D = 64) and key word
// (l / 2) ^ c around in registers (mm_probe's turn: at D = 128 its loads hit
// 32 banks, at D = 64 two lanes share one; its stores hit 32 banks)
template <int D>
__device__ __forceinline__ void turn_v8(unsigned char* vt, const unsigned char* raw, int tw) {
  const int lane = threadIdx.x & 31;
  const int nw = D == 128 ? lane : (lane & 15);
  for (int i = tw; i < D / 4; i += 3) {
    // D = 64: the sweeps c in [0, 8) and [16, 24) cover each (n-word, key word) once
    const int c = D == 128 ? i : ((i & 7) | ((i & 8) << 1));
    const int kw = (lane >> 1) ^ c;
    const int r0 = 32 * (kw >> 3) + 16 * ((kw >> 2) & 1) + 2 * (kw & 3);
    const unsigned char* src = raw + r0 * D + nw * 4;
    const uint32_t w0 = ld32(src), w1 = ld32(src + D);
    const uint32_t w2 = ld32(src + 8 * D), w3 = ld32(src + 9 * D);
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nw * 4 + j;
      const int off = n * 128 + ((((kw >> 2) ^ (n & 7)) << 4) | ((kw & 3) << 2));
      *reinterpret_cast<uint32_t*>(vt + off) = col[j];
    }
  }
}

// qkpv's first sweep: fold one tile's integer logits of the keys in
// [lo, hi) into this thread's row maxima (rows g and g + 8).  MASK: the
// tile holds keys outside [lo, hi)
template <bool MASK>
__device__ __forceinline__ void block_row_max(const int (&si)[64], int k0, int lo, int hi,
                                              int& mx0, int& mx1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + 8 * j + 2 * t + e;
      if (!MASK || (key >= lo && key < hi)) {
        mx0 = max(mx0, si[4 * j + e]);
        mx1 = max(mx1, si[4 * j + 2 + e]);
      }
    }
  }
}

// the low bytes of four words, in order
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// qkpv's second sweep on one tile (TPU `quant_pv`): p_rel = exp2(s - m_block)
// with s = float(si) * slab (keys outside [lo, hi) 0), its row sums added to
// rs0 / rs1, and p8 = round_half_even(127 p_rel) in [0, 127] (p_rel <= 1)
// packed as the s8 A fragments of the four k32 steps: register r of step kk
// holds accumulator elements 16 kk + {0, 1, 4, 5}, {2, 3, 6, 7},
// {8, 9, 12, 13}, {10, 11, 14, 15} (rows g, g + 8, g, g + 8; keys 2t +
// {0, 1, 8, 9} of the step's first 16, then of its second 16)
template <bool MASK>
__device__ __forceinline__ void quant_tile(const int (&si)[64], float slab, int k0, int lo, int hi,
                                           float mb0, float mb1, float& rs0, float& rs1,
                                           uint32_t (&pa)[kBlockN / 32][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 32; ++kk) {
    uint32_t b[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // element 4j + e: row g (e < 2) or g + 8, key k0 + 8j + 2t + (e & 1)
      const int x = 16 * kk + i;
      const int key = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
      float s = __fmul_rn(__int2float_rn(si[x]), slab);
      if (MASK && (key < lo || key >= hi)) s = kNegInf;
      const float p = exp2f(__fsub_rn(s, (x & 2) ? mb1 : mb0));
      if (x & 2) {
        rs1 += p;
      } else {
        rs0 += p;
      }
      // 1.5 * 2^23 + k holds k in its low byte: 127 p rounded once, then
      // to an integer half to even, as jnp.round(p * 127.0)
      b[i] = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), 12582912.f));
    }
    pa[kk][0] = low_bytes(b[0], b[1], b[4], b[5]);
    pa[kk][1] = low_bytes(b[2], b[3], b[6], b[7]);
    pa[kk][2] = low_bytes(b[8], b[9], b[12], b[13]);
    pa[kk][3] = low_bytes(b[10], b[11], b[14], b[15]);
  }
}

// PV += P8 V8 of one tile on the s8 tensor cores: A (P8) from registers, V8
// turned K-major [D, 128 keys]; the first k-step overwrites PV unless
// `accumulate`; issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_pv8(int (&pv)[D / 2], const uint32_t (&pa)[kBlockN / 32][4],
                                          uint32_t vt, int accumulate) {
  fence_regs(pv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 32; ++kk) {
    wgmma_s8_rs_d<D>(pv, pa[kk], make_desc(vt + kk * 32, 16, 1024), kk > 0 ? 1 : accumulate);
  }
  wgmma_commit();
}

// qkpv's consumer warpgroup: for each block of pv_block keys, sweep 1 takes
// its row max m_block (S only), O and l are rescaled to the new running max
// once, and sweep 2 sums p8 . v8 over the block's tiles in s32 (S of tile
// j + 1 issued before P V of tile j, quantised once both are done: a
// second P buffer, quantised while P V runs, spilled); the block's sum
// enters O as float(sum) * exp2(m_block - m_new) / 127.  K tiles come from
// the K ring (k_full / empty, one tile per sweep and key tile), V tiles from
// the V ring (v_full / v_empty, sweep 2 only).  Every address derives from
// the shared-memory base `sb` at the layout's fixed offsets, so that
// nothing but O, PV, S and P8 takes many registers
template <int D, typename S>
__device__ __forceinline__ void consume_pv8(float (&o)[D / 2], float& m0, float& m1, float& l0,
                                            float& l1, uint32_t sb, uint32_t q_wg, int klen,
                                            int pv_block, float slab) {
  constexpr int kS = S::kStages;
  // mbarriers: q_full, k_full[kS], v_full[kS], empty[kS], raw_full[kS], v_empty[kS]
  const uint32_t k_full = sb + S::off_bar + 8, v_full = k_full + 8 * kS;
  const uint32_t k_empty = v_full + 8 * kS, v_empty = k_empty + 16 * kS;
  int si[64], pv[D / 2];
  uint32_t pa[kBlockN / 32][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) pv[i] = 0;
  int kt = 0, vt = 0;  // K and V tiles taken from the rings
  for (int lo = 0; lo < klen; lo += pv_block) {
    const int hi = min(lo + pv_block, klen);
    const int t0 = lo / kBlockN, n = (hi + kBlockN - 1) / kBlockN - t0;

    // sweep 1: the row max of the block's integer logits (sqk > 0 commutes
    // with the max; a block always holds a valid key)
    int mx0 = -2147483647 - 1, mx1 = -2147483647 - 1;
    for (int j = 0; j < n; ++j, ++kt) {
      const int s = kt % kS, k0 = (t0 + j) * kBlockN;
      mbar_wait(k_full + 8 * s, (kt / kS) & 1);
      issue_qk_s8<D>(si, q_wg, sb + S::off_k + s * S::kK);
      wgmma_wait<0>();
      fence_regs(si);
      mbar_arrive(k_empty + 8 * s);
      if (k0 < lo || k0 + kBlockN > hi) {  // keys of a neighbouring block, or past klen
        block_row_max<true>(si, k0, lo, hi, mx0, mx1);
      } else {
        block_row_max<false>(si, k0, lo, hi, mx0, mx1);
      }
    }
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mb0 = __fmul_rn(__int2float_rn(mx0), slab);
    const float mb1 = __fmul_rn(__int2float_rn(mx1), slab);
    {
      const float mn0 = fmaxf(m0, mb0), mn1 = fmaxf(m1, mb1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= c0;
        o[4 * i + 1] *= c0;
        o[4 * i + 2] *= c1;
        o[4 * i + 3] *= c1;
      }
      l0 *= c0;
      l1 *= c1;
      m0 = mn0;
      m1 = mn1;
    }

    // sweep 2: P quantised against m_block, p8 . v8 summed in s32
    float rs0 = 0.f, rs1 = 0.f;
    {
      const int s = kt % kS, k0 = t0 * kBlockN;
      mbar_wait(k_full + 8 * s, (kt / kS) & 1);
      issue_qk_s8<D>(si, q_wg, sb + S::off_k + s * S::kK);
      wgmma_wait<0>();
      fence_regs(si);
      mbar_arrive(k_empty + 8 * s);
      ++kt;
      if (k0 < lo || k0 + kBlockN > hi) {
        quant_tile<true>(si, slab, k0, lo, hi, mb0, mb1, rs0, rs1, pa);
      } else {
        quant_tile<false>(si, slab, k0, lo, hi, mb0, mb1, rs0, rs1, pa);
      }
    }
    for (int j = 0; j < n; ++j, ++vt) {
      const bool more = j + 1 < n;
      const int s = kt % kS, vs = vt % kS, k1 = (t0 + j + 1) * kBlockN;
      if (more) {
        mbar_wait(k_full + 8 * s, (kt / kS) & 1);
        issue_qk_s8<D>(si, q_wg, sb + S::off_k + s * S::kK);
      }
      mbar_wait(v_full + 8 * vs, (vt / kS) & 1);
      issue_pv8<D>(pv, pa, sb + S::off_v + vs * S::kV, j > 0);
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 32; ++kk) fence_regs(pa[kk]);  // read until here
      mbar_arrive(v_empty + 8 * vs);
      if (more) {
        fence_regs(si);
        mbar_arrive(k_empty + 8 * s);
        ++kt;
        if (k1 < lo || k1 + kBlockN > hi) {
          quant_tile<true>(si, slab, k1, lo, hi, mb0, mb1, rs0, rs1, pa);
        } else {
          quant_tile<false>(si, slab, k1, lo, hi, mb0, mb1, rs0, rs1, pa);
        }
      }
    }
    // the block's factor exp2(m_block - m_new), and / 127 for the sum
    const float f0 = exp2f(mb0 - m0), f1 = exp2f(mb1 - m1);
    const float g0 = f0 * (1.f / 127.f), g1 = f1 * (1.f / 127.f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] += __int2float_rn(pv[4 * i]) * g0;
      o[4 * i + 1] += __int2float_rn(pv[4 * i + 1]) * g0;
      o[4 * i + 2] += __int2float_rn(pv[4 * i + 2]) * g1;
      o[4 * i + 3] += __int2float_rn(pv[4 * i + 3]) * g1;
    }
    l0 += rs0 * f0;
    l1 += rs1 * f1;
  }
}

// `sqk` [B*N] (int8 instances): the slab scales of the int32 logits
// (sq * sk * scale * log2 e); `mstat` [B*N, ceil(Lq / 64)] (K3): the bound
// of each 64 query rows; `sv` [B*N, D] (int8 V): V8's per-channel scales;
// `scale_log2` (K1): the scale of the bf16 logits; `pv_block` (qkpv): the
// key block P is quantised on, a positive multiple of 64.  tm_v maps bf16 V
// (swizzled boxes of 64 channels) or V8 (unswizzled [128 keys, D] boxes)
template <int D, int QK, int VM>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ k_lens,
                 const float* __restrict__ sqk, const float* __restrict__ mstat,
                 const float* __restrict__ sv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int Lq, int Lk, int N, float scale_log2, int pv_block) {
  using S = Smem<D, QK, VM>;
  constexpr bool kInt8 = S::kInt8, kStatic = QK == kQkInt8Static;
  constexpr bool kDots = QK == kQkBf16Dots || QK == kQkInt8Dots;  // S3: no softmax
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
  uint64_t* k_full = q_full + 1;          // K of stage s landed
  uint64_t* v_full = k_full + kStages;    // V of stage s ready (landed, widened or turned)
  uint64_t* empty = v_full + kStages;     // both consumer warpgroups are done with stage s
                                          // (qkpv: with its K)
  uint64_t* raw_full = empty + kStages;   // int8 V: the raw V8 tile of stage s landed
  uint64_t* v_empty = raw_full + kStages;  // qkpv: both consumer warpgroups are done with its V
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], VM == kVBf16 ? 1 : kTurners);
      mbar_init(&empty[s], kConsumers);
      if constexpr (VM != kVBf16) mbar_init(&raw_full[s], 1);
      if constexpr (VM == kVPv8) mbar_init(&v_empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {
    // ---------------- producer warpgroup: one thread issues every load; for
    // int8 V the other three warps widen or turn each V8 tile
    if constexpr (VM == kVBf16) {
      SA_SETMAXNREG_DEC(24);
    } else {
      SA_SETMAXNREG_DEC(40);  // the turners' loops: 24 registers spilled
    }
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(q_full, S::kQ);
#pragma unroll
      for (int p = 0; p < S::kQKParts; ++p) {
        tma_load_3d(sm + S::off_q + p * kBlockM * S::kQKRow, &tm_q, q_full, h * D + p * 64, q0,
                    b);
      }
      if constexpr (VM == kVPv8) {
        // per key block: its K tiles for sweep 1, then K and V for sweep 2
        int kt = 0, vt = 0;
        for (int lo = 0; lo < klen; lo += pv_block) {
          const int hi = min(lo + pv_block, klen);
          for (int pass = 0; pass < 2; ++pass) {
            for (int t = lo / kBlockN; t * kBlockN < hi; ++t, ++kt) {
              const int s = kt % kStages;
              mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
              mbar_arrive_expect_tx(&k_full[s], S::kK);
              tma_load_3d(sm + S::off_k + s * S::kK, &tm_k, &k_full[s], h * D, t * kBlockN, b);
              if (pass == 1) {
                const int vs = vt % kStages;
                mbar_wait(&v_empty[vs], ((vt / kStages) & 1) ^ 1);
                mbar_arrive_expect_tx(&raw_full[vs], S::kVRaw);
                tma_load_3d(sm + S::off_raw + vs * S::kVRaw, &tm_v, &raw_full[vs], h * D,
                            t * kBlockN, b);
                ++vt;
              }
            }
          }
        }
      } else {
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % kStages, k0 = it * kBlockN;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&k_full[s], S::kK);
#pragma unroll
          for (int p = 0; p < S::kQKParts; ++p) {
            tma_load_3d(sm + S::off_k + s * S::kK + p * kBlockN * S::kQKRow, &tm_k, &k_full[s],
                        h * D + p * 64, k0, b);
          }
          if constexpr (VM == kVBf16) {
            mbar_arrive_expect_tx(&v_full[s], S::kV);
#pragma unroll
            for (int hf = 0; hf < S::kVHalves; ++hf) {
              tma_load_3d(sm + S::off_v + s * S::kV + hf * kBlockN * kRow, &tm_v, &v_full[s],
                          h * D + hf * 64, k0, b);
            }
          } else {
            mbar_arrive_expect_tx(&raw_full[s], S::kVRaw);
            tma_load_3d(sm + S::off_raw + s * S::kVRaw, &tm_v, &raw_full[s], h * D, k0, b);
          }
        }
      }
    } else if constexpr (VM != kVBf16) {
      if (warp > 8) {
        // ---------------- warps 9-11: each raw V8 tile into the operand
        if constexpr (VM == kVInt8) {
          for (int it = 0; it < ntiles; ++it) {
            const int s = it % kStages;
            mbar_wait(&raw_full[s], (it / kStages) & 1);
            widen_v8<D>(sm + S::off_v + s * S::kV, sm + S::off_raw + s * S::kVRaw,
                        threadIdx.x - 9 * 32);
            fence_proxy_async();  // the generic-proxy stores, visible to wgmma
            mbar_arrive(&v_full[s]);
          }
        } else {
          int vt = 0;
          for (int lo = 0; lo < klen; lo += pv_block) {
            const int hi = min(lo + pv_block, klen);
            for (int t = lo / kBlockN; t * kBlockN < hi; ++t, ++vt) {
              const int s = vt % kStages;
              mbar_wait(&raw_full[s], (vt / kStages) & 1);
              turn_v8<D>(sm + S::off_v + s * S::kV, sm + S::off_raw + s * S::kVRaw, warp - 9);
              fence_proxy_async();
              mbar_arrive(&v_full[s]);
            }
          }
        }
      }
    }
  } else {
    // ---------------- two consumer warpgroups of 64 query rows each
    if constexpr (VM == kVBf16) {
      SA_SETMAXNREG_INC(240);
    } else {
      SA_SETMAXNREG_INC(232);  // 2 x 128 x 232 + 128 x 40 = 384 x 168
    }
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row_a = q0 + wg * 64 + wl * 16 + g, row_b = row_a + 8;
    const uint32_t q_wg = smem_u32(sm + S::off_q) + wg * 64 * S::kQKRow;  // this warpgroup's rows
    // the int8 logits leave the tensor cores unscaled; K3's bound is this
    // warpgroup's (its 64 rows are one 64-row block of the bound)
    const float slab = kInt8 && !kDots ? sqk[bh] : 0.f;
    const int qb = blockIdx.x * 2 + wg;
    const float bound = kStatic && qb < nqb ? mstat[(long long)bh * nqb + qb] : 0.f;

    float o[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    // base-2 running max (scaled logits) and this thread's partial row sum
    // of rows g and g + 8
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    if constexpr (VM == kVPv8) {
      mbar_wait(q_full, 0);
      consume_pv8<D, S>(o, m0, m1, l0, l1, smem_u32(sm), q_wg, klen, pv_block, slab);
    } else {
      // S of tile it + 1 is issued before P V of tile it, and its softmax
      // runs while that product is on the tensor cores
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
        if constexpr (!kStatic && !kDots) {
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
    }

    // S3 sums P V unnormalised
    const float lf0 = kDots ? 1.f : fmaxf(quad_sum(l0), 1e-30f);
    const float lf1 = kDots ? 1.f : fmaxf(quad_sum(l1), 1e-30f);
    const long long rs = (long long)N * D;
    __nv_bfloat16* ob = out + ((long long)b * Lq * N + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      float x0 = o[4 * j] / lf0, x1 = o[4 * j + 1] / lf0;
      float x2 = o[4 * j + 2] / lf1, x3 = o[4 * j + 3] / lf1;
      if constexpr (VM != kVBf16) {
        // V8's per-channel scale, once, before the bf16 rounding
        const float s0 = sv[(long long)bh * D + c], s1 = sv[(long long)bh * D + c + 1];
        x0 *= s0;
        x1 *= s1;
        x2 *= s0;
        x3 *= s1;
      }
      if (row_a < Lq) *reinterpret_cast<uint32_t*>(ob + row_a * rs + c) = pack_bf16(x0, x1);
      if (row_b < Lq) *reinterpret_cast<uint32_t*>(ob + row_b * rs + c) = pack_bf16(x2, x3);
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

}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().  k_lens may be NULL
// (every key valid), and so may lse (no LSE output).
// --------------------------------------------------------------------------

namespace {

// K1 (QK = kQkBf16: q, k bf16) or K2 / K2v / K3 (q8, k8 int8 with the slab
// scales sqk, and K3's bounds mstat); v bf16 (VM = kVBf16), or int8 with
// its per-channel scales sv and, for qkpv, the key block pv_block
template <int D, int QK, int VM>
int launch_fwd(const void* q, const void* k, const void* v, const void* sv, const void* k_lens,
               const void* sqk, const void* mstat, void* out, void* lse, int B, int Lq, int Lk,
               int N, float scale_log2, int pv_block, cudaStream_t st) {
  using namespace sa::ffwd;
  using S = Smem<D, QK, VM>;
  CUtensorMap mq, mk, mv;
  const bool ok = S::kInt8 ? sa::make_map_s8(&mq, q, B, Lq, N * D, kBlockM, D) &&
                                 sa::make_map_s8(&mk, k, B, Lk, N * D, kBlockN, D)
                           : sa::make_map(&mq, q, B, Lq, N * D, kBlockM) &&
                                 sa::make_map(&mk, k, B, Lk, N * D, kBlockN);
  const bool ok_v = VM == kVBf16 ? sa::make_map(&mv, v, B, Lk, N * D, kBlockN)
                                 : sa::make_map_s8(&mv, v, B, Lk, N * D, kBlockN, D, false);
  if (!ok || !ok_v) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = S::launch_bytes;
  int rc;
  if ((rc = sa::allow_smem(flash_fwd_kernel<D, QK, VM>, smem))) return rc;
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, B * N);
  flash_fwd_kernel<D, QK, VM><<<grid, kThreads, smem, st>>>(
      mq, mk, mv, static_cast<const int*>(k_lens), static_cast<const float*>(sqk),
      static_cast<const float*>(mstat), static_cast<const float*>(sv),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Lq, Lk, N, scale_log2,
      pv_block);
  return static_cast<int>(cudaGetLastError());
}

template <int QK, int VM>
int launch_fwd_d(const void* q, const void* k, const void* v, const void* sv, const void* k_lens,
                 const void* sqk, const void* mstat, void* out, void* lse, int B, int Lq, int Lk,
                 int N, int D, float scale_log2, int pv_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return launch_fwd<128, QK, VM>(q, k, v, sv, k_lens, sqk, mstat, out, lse, B, Lq, Lk, N,
                                   scale_log2, pv_block, st);
  }
  if (D == 64) {
    return launch_fwd<64, QK, VM>(q, k, v, sv, k_lens, sqk, mstat, out, lse, B, Lq, Lk, N,
                                  scale_log2, pv_block, st);
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
  return launch_fwd_d<sa::ffwd::kQkBf16, sa::ffwd::kVBf16>(
      q, k, v, nullptr, k_lens, nullptr, nullptr, out, lse, B, Lq, Lk, N, D, scale_log2, 0,
      stream);
}

// The int8 instances: q8, k8 int8 [B, L, N, D], sqk [B*N], lse [B, N, Lq] or
// NULL.  K2 (and K2-LSE): bf16 V
extern "C" int sa_flash_fwd_int8_qk(const void* q8, const void* k8, const void* v,
                                    const void* sqk, const void* k_lens, void* out, void* lse,
                                    int B, int Lq, int Lk, int N, int D, void* stream) {
  return launch_fwd_d<sa::ffwd::kQkInt8, sa::ffwd::kVBf16>(
      q8, k8, v, nullptr, k_lens, sqk, nullptr, out, lse, B, Lq, Lk, N, D, 0.f, 0, stream);
}

// K2v-qkv: int8 V [B, Lk, N, D] with per-channel scales sv [B, N, D]
extern "C" int sa_flash_fwd_int8_qkv(const void* q8, const void* k8, const void* v8,
                                     const void* sv, const void* sqk, const void* k_lens,
                                     void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                     void* stream) {
  return launch_fwd_d<sa::ffwd::kQkInt8, sa::ffwd::kVInt8>(
      q8, k8, v8, sv, k_lens, sqk, nullptr, out, lse, B, Lq, Lk, N, D, 0.f, 0, stream);
}

// K2v-qkpv: as qkv, with P quantised to int8 per row against its maximum
// over each block of pv_block keys (a positive multiple of 64)
extern "C" int sa_flash_fwd_int8_qkpv(const void* q8, const void* k8, const void* v8,
                                      const void* sv, const void* sqk, const void* k_lens,
                                      void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                      int pv_block, void* stream) {
  if (pv_block <= 0 || pv_block % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd_d<sa::ffwd::kQkInt8, sa::ffwd::kVPv8>(
      q8, k8, v8, sv, k_lens, sqk, nullptr, out, lse, B, Lq, Lk, N, D, 0.f, pv_block, stream);
}

// K3 with bf16 V; mstat [B*N, ceil(Lq / 64)]
extern "C" int sa_flash_fwd_int8_static_qk(const void* q8, const void* k8, const void* v,
                                           const void* sqk, const void* mstat,
                                           const void* k_lens, void* out, void* lse, int B,
                                           int Lq, int Lk, int N, int D, void* stream) {
  return launch_fwd_d<sa::ffwd::kQkInt8Static, sa::ffwd::kVBf16>(
      q8, k8, v, nullptr, k_lens, sqk, mstat, out, lse, B, Lq, Lk, N, D, 0.f, 0, stream);
}

// K3 with int8 V and its scales
extern "C" int sa_flash_fwd_int8_static_qkv(const void* q8, const void* k8, const void* v8,
                                            const void* sv, const void* sqk, const void* mstat,
                                            const void* k_lens, void* out, void* lse, int B,
                                            int Lq, int Lk, int N, int D, void* stream) {
  return launch_fwd_d<sa::ffwd::kQkInt8Static, sa::ffwd::kVInt8>(
      q8, k8, v8, sv, k_lens, sqk, mstat, out, lse, B, Lq, Lk, N, D, 0.f, 0, stream);
}

// S3 (the probe of csrc/probes.cu's header): out [BH, L, D] bf16 from q, k
// [BH, L, D] (bf16, or int8 with int8 != 0) and v [BH, L, D] bf16 -- the
// template's [B, L, N * D] with N = 1, every key valid
extern "C" int sa_dots_probe(const void* q, const void* k, const void* v, void* out, int BH,
                             int L, int D, int int8, void* stream) {
  if (int8) {
    return launch_fwd_d<sa::ffwd::kQkInt8Dots, sa::ffwd::kVBf16>(
        q, k, v, nullptr, nullptr, nullptr, nullptr, out, nullptr, BH, L, L, 1, D, 0.f, 0, stream);
  }
  return launch_fwd_d<sa::ffwd::kQkBf16Dots, sa::ffwd::kVBf16>(
      q, k, v, nullptr, nullptr, nullptr, nullptr, out, nullptr, BH, L, L, 1, D, 0.f, 0, stream);
}

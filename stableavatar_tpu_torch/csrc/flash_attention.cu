// Flash-attention forward kernels for Hopper (sm_90a): K1 (bf16), K2 (int8
// Q.K^T), K2v (int8 V) and K3 (static-bound softmax).
//
// K1 replaces stableavatar_tpu/ops/flash_attention.py:_flash_fwd_impl (body
// `_fwd_body`): softmax(q k^T * scale) v over [B, L, N, D] bf16 with keys at
// or past k_lens[b] masked.  K1-rope (ROPE, `flash_attention(rope=)`) is the
// same kernel with the split-pair rotation of `_fwd_body`'s `rope=` branch
// (`_rot`, :142-143) inside: Q is rotated in fp32 on its way into the A
// fragments, each K tile in place in shared memory after it lands, both
// rounded to bf16 once as `_rot(...).astype(dt)` does; the mma loop is
// K1's.  Without ROPE the caller applies rope first.  With a non-null
// `lse` it also writes the natural-log log-sum-exp of every query row,
// m * ln2 + log(max(l, 1e-30)) as `_fwd_body` finalizes it, in fp32 laid out
// [B, N, Lq] (no 128-lane broadcast); the backward (K4,
// flash_attention_bwd.cu) recomputes P from it.  A null `lse` skips the
// write, as the JAX package's primal-only path does.
//
// K2, K2v, K2-LSE and K3 replace stableavatar_tpu/ops/flash_attention.py:
// _flash_int8_impl, one template (`flash_fwd_int8_kernel`) for all
// variants.  Q and K arrive as int8 with one scale per (batch, head) slab
// (the prep is plain torch, as it was XLA on the TPU); the kernel runs
// Q8.K8^T on the s8 tensor cores into s32 and multiplies by sqk[b*N + h] =
// sq * sk * scale * log2(e).  Then, by the V path and the softmax:
//   - K2, quant="qk" (body `_int8_fwd_body`): K1's online softmax, bf16 P.V;
//   - K2v "qkv" (`v_int8` branch): V int8, widened to bf16 in registers for
//     the P.V product, its per-channel scale applied once at finalize;
//   - K2v "qkpv" (`quant_pv` branch): P rescaled to its row max within the
//     JAX package's key block (`pv_block` keys, a multiple of 64: 1536 or
//     1024 capped to the sequence rounded up to 128), rounded to int8 and
//     multiplied with int8 V into s32, times exp2(m_block - m_new) / 127.
//     Each block of pv_block / 64 key tiles is swept twice: first for the
//     row max of its logits, then for P.V (Q.K^T is computed twice);
//   - K3 (`_int8_fwd_body_static`, "qk" or "qkv"): no running max -- p =
//     exp2(s - M) with M = sqk * max|q8| * max|k8| over this block's 64
//     query rows and all keys (Cauchy-Schwarz, computed by the wrapper), no
//     rescale.
// With a non-null `lse` every variant also writes the natural-log LSE of
// each query row, m * ln2 + log(max(l, 1e-30)) (M in place of m for K3), in
// fp32 laid out [B, N, Lq]: K2-LSE, the combinable partials of ring
// attention (`flash_attention_with_stats(quant=...)`).
// K is read row-major [B, L, N, D]: the TPU's [D, L] pre-transpose is a
// layout of its matrix unit and has no use here.
//
// What bounds them on the H100: at the DiT self-attention shape (B*N = 36,
// L = 21,504, D = 128) all are compute-bound -- 4*L^2*D operations per head
// (half int8 for Q.K^T, half bf16 for P.V, or all int8 for qkpv, whose Q.K^T
// runs twice) against 3*L*D bytes per head of input read once per 64-row
// query tile from L2.
// All kernels read Q, K and V straight from the [B, L, N, D] activations
// (no transpose or padding pass), keep the logits and probabilities in
// registers, and keep K/V tiles in shared memory shared by 4 warps.  This
// first version uses mma.sync rather than wgmma and has a single K/V stage
// (the V copy overlaps the Q.K^T and softmax of the same tile); wgmma, TMA
// and warp specialisation are later work.
#include "attention_common.cuh"

namespace sa {

template <int D, bool ROPE>
__device__ __forceinline__ void flash_fwd_bf16_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ k_lens,
    const float* __restrict__ rope, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    int Lq, int Lk, int N, float scale_log2) {
  constexpr int kPitch = D + 8;
  __shared__ __align__(16) unsigned short Ks[kBlockK * kPitch];
  __shared__ __align__(16) unsigned short Vs[kBlockK * kPitch];

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + (lane >> 2);
  const long long rs = (long long)N * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;

  uint32_t qa[D / 16][4];
  if constexpr (ROPE) {
    load_q_bf16_rope<D>(qa, q + ((long long)b * Lq * N + h) * D, rs, row_a, Lq, rope);
  } else {
    load_q_bf16<D>(qa, q + ((long long)b * Lq * N + h) * D, rs, row_a, Lq);
  }

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
    if constexpr (ROPE) {
      rope_tile<D>(Ks, rope, k0, Lk);
      __syncthreads();
    }

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

// K1 (and K1-LSE)
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ k_lens,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk,
                      int N, float scale_log2) {
  flash_fwd_bf16_body<D, false>(q, k, v, k_lens, nullptr, out, lse, Lq, Lk, N, scale_log2);
}

// K1-rope (and its LSE): at most 168 registers, so that 3 blocks of 128
// threads share an SM as K1's do (the rotation's loads would take more)
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_bf16_rope_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int* __restrict__ k_lens,
                           const float* __restrict__ rope, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Lq, int Lk, int N, float scale_log2) {
  flash_fwd_bf16_body<D, true>(q, k, v, k_lens, rope, out, lse, Lq, Lk, N, scale_log2);
}

// V path and softmax of the int8 kernels (template parameters).
enum VMode {
  kVBf16 = 0,  // K2 / K3-qk: bf16 V, bf16 P.V
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

// The int8 flash forward: K2 (kVBf16, online), K2v (kVInt8 / kPV8, online)
// and K3 (kVBf16 / kVInt8, STATIC).  `sv` [B, N, D] scales the int8 V at
// finalize; `mstat` [B*N, Lq / 64 blocks] is K3's bound; `pv_block` is
// kPV8's quantisation block in keys (a multiple of kBlockK); `lse` (may be
// null) receives m * ln2 + log(max(l, 1e-30)) as [B, N, Lq] -- K2-LSE, or
// K3's M * ln2 + log(l).
// At most 168 registers a thread (3 blocks of 128 threads on an SM's 65,536):
// at 173 the online K2v-qkv instance fell to 2 blocks per SM and ran 8.7%
// slower than at 168 (profile_window.py kernels, NVIDIA H100 80GB HBM3).
template <int D, int VMODE, bool STATIC>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                      const void* __restrict__ v, const float* __restrict__ sv,
                      const float* __restrict__ sqk, const float* __restrict__ mstat,
                      const int* __restrict__ k_lens, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Lq, int Lk, int N, int pv_block) {
  constexpr int kPitch8 = D + 16;  // bytes
  constexpr int kVRow = VMODE == kVBf16 ? 2 * D : D;  // bytes of one V row
  __shared__ __align__(16) int8_t Ks[kBlockK * kPitch8];
  __shared__ __align__(16) char Vs[kBlockK * (kVRow + 16)];

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
  const long long v_rs = VMODE == kVBf16 ? rs * 2 : rs;  // bytes between V rows
  const char* vb = static_cast<const char*>(v) + ((long long)b * Lk * N + h) * kVRow;

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
    load_tile<kVRow>(Vs, vb, v_rs, k0, Lk);
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
    if constexpr (VMODE == kVBf16) {
      pv_bf16<D>(acc, s, reinterpret_cast<const unsigned short*>(Vs));
    } else if constexpr (VMODE == kVInt8) {
      pv_int8_bf16<D>(acc, s, reinterpret_cast<const int8_t*>(Vs));
    } else {
      pv_int8<D>(acc, s, reinterpret_cast<const int8_t*>(Vs), f);
    }
    __syncthreads();
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f), l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  const float* svb = VMODE == kVBf16 ? nullptr : sv + (long long)bh * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] /= l0;
    acc[nd][1] /= l0;
    acc[nd][2] /= l1;
    acc[nd][3] /= l1;
    if constexpr (VMODE != kVBf16) {
      const int c = nd * 8 + t * 2;
      acc[nd][0] *= svb[c];
      acc[nd][1] *= svb[c + 1];
      acc[nd][2] *= svb[c];
      acc[nd][3] *= svb[c + 1];
    }
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

template <bool ROPE>
int launch_bf16(const void* q, const void* k, const void* v, const void* k_lens,
                const void* rope, void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                float scale_log2, void* stream) {
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k_ = static_cast<const __nv_bfloat16*>(k);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto kl = static_cast<const int*>(k_lens);
  auto r_ = static_cast<const float*>(rope);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  auto lse_ = static_cast<float*>(lse);
  if (D == 128 && ROPE) {
    sa::flash_fwd_bf16_rope_kernel<128><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v_, kl, r_, o_, lse_, Lq, Lk, N, scale_log2);
  } else if (D == 128) {
    sa::flash_fwd_bf16_kernel<128><<<grid, sa::kThreads, 0, st>>>(q_, k_, v_, kl, o_, lse_, Lq,
                                                                  Lk, N, scale_log2);
  } else if (D == 64 && ROPE) {
    sa::flash_fwd_bf16_rope_kernel<64><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v_, kl, r_, o_, lse_, Lq, Lk, N, scale_log2);
  } else if (D == 64) {
    sa::flash_fwd_bf16_kernel<64><<<grid, sa::kThreads, 0, st>>>(q_, k_, v_, kl, o_, lse_, Lq,
                                                                 Lk, N, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 (K1-LSE with a non-null lse [B, N, Lq]); q and k roped by the caller
extern "C" int sa_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* k_lens,
                                 void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                 float scale_log2, void* stream) {
  return launch_bf16<false>(q, k, v, k_lens, nullptr, out, lse, B, Lq, Lk, N, D, scale_log2,
                            stream);
}

// K1-rope: q and k in split-pair layout, rotated in the kernel by the packed
// fp32 table rope [L, D] (L >= Lq and L >= Lk; row i is position i)
extern "C" int sa_flash_fwd_bf16_rope(const void* q, const void* k, const void* v,
                                      const void* k_lens, const void* rope, void* out, void* lse,
                                      int B, int Lq, int Lk, int N, int D, float scale_log2,
                                      void* stream) {
  if (rope == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16<true>(q, k, v, k_lens, rope, out, lse, B, Lq, Lk, N, D, scale_log2,
                           stream);
}

namespace {

template <int VMODE, bool STATIC>
int launch_int8(const void* q8, const void* k8, const void* v, const void* sv, const void* sqk,
                const void* mstat, const void* k_lens, void* out, void* lse, int B, int Lq,
                int Lk, int N, int D, int pv_block, void* stream) {
  if (VMODE == sa::kPV8 && (pv_block <= 0 || pv_block % sa::kBlockK != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const int8_t*>(q8);
  auto k_ = static_cast<const int8_t*>(k8);
  auto sv_ = static_cast<const float*>(sv);
  auto s_ = static_cast<const float*>(sqk);
  auto ms_ = static_cast<const float*>(mstat);
  auto kl = static_cast<const int*>(k_lens);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  auto lse_ = static_cast<float*>(lse);
  if (D == 128) {
    sa::flash_fwd_int8_kernel<128, VMODE, STATIC><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v, sv_, s_, ms_, kl, o_, lse_, Lq, Lk, N, pv_block);
  } else if (D == 64) {
    sa::flash_fwd_int8_kernel<64, VMODE, STATIC><<<grid, sa::kThreads, 0, st>>>(
        q_, k_, v, sv_, s_, ms_, kl, o_, lse_, Lq, Lk, N, pv_block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 (and K2-LSE with a non-null lse [B, N, Lq]): bf16 V
extern "C" int sa_flash_fwd_int8_qk(const void* q8, const void* k8, const void* v,
                                    const void* sqk, const void* k_lens, void* out, void* lse,
                                    int B, int Lq, int Lk, int N, int D, void* stream) {
  return launch_int8<sa::kVBf16, false>(q8, k8, v, nullptr, sqk, nullptr, k_lens, out, lse, B,
                                        Lq, Lk, N, D, 0, stream);
}

// K2v-qkv: int8 V [B, Lk, N, D] with per-channel scales sv [B, N, D]
extern "C" int sa_flash_fwd_int8_qkv(const void* q8, const void* k8, const void* v8,
                                     const void* sv, const void* sqk, const void* k_lens,
                                     void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                     void* stream) {
  return launch_int8<sa::kVInt8, false>(q8, k8, v8, sv, sqk, nullptr, k_lens, out, lse, B, Lq,
                                        Lk, N, D, 0, stream);
}

// K2v-qkpv: as qkv, with P quantised to int8 per row against its maximum
// over each block of pv_block keys (a positive multiple of 64)
extern "C" int sa_flash_fwd_int8_qkpv(const void* q8, const void* k8, const void* v8,
                                      const void* sv, const void* sqk, const void* k_lens,
                                      void* out, void* lse, int B, int Lq, int Lk, int N, int D,
                                      int pv_block, void* stream) {
  return launch_int8<sa::kPV8, false>(q8, k8, v8, sv, sqk, nullptr, k_lens, out, lse, B, Lq, Lk,
                                      N, D, pv_block, stream);
}

// K3 with bf16 V; mstat [B*N, ceil(Lq / 64)], lse [B, N, Lq] or NULL
extern "C" int sa_flash_fwd_int8_static_qk(const void* q8, const void* k8, const void* v,
                                           const void* sqk, const void* mstat,
                                           const void* k_lens, void* out, void* lse, int B,
                                           int Lq, int Lk, int N, int D, void* stream) {
  return launch_int8<sa::kVBf16, true>(q8, k8, v, nullptr, sqk, mstat, k_lens, out, lse, B, Lq,
                                       Lk, N, D, 0, stream);
}

// K3 with int8 V and its scales
extern "C" int sa_flash_fwd_int8_static_qkv(const void* q8, const void* k8, const void* v8,
                                            const void* sv, const void* sqk, const void* mstat,
                                            const void* k_lens, void* out, void* lse, int B,
                                            int Lq, int Lk, int N, int D, void* stream) {
  return launch_int8<sa::kVInt8, true>(q8, k8, v8, sv, sqk, mstat, k_lens, out, lse, B, Lq, Lk,
                                       N, D, 0, stream);
}

// Shared building blocks of the hand-written Hopper attention kernels
// (flash_attention.cu, cross_attention.cu).
//
// Tiling, common to all three kernels: one thread block of 4 warps owns 64
// query rows of one (batch, head); each warp owns 16 of them and keeps its
// Q fragments, its online-softmax state (running max m, row sum l) and its
// f32 output accumulator in registers for the whole key loop.  K/V tiles of
// 64 keys stream through shared memory with cp.async; the loop over tiles
// inside the block takes the place of the TPU grid's sequential k axis.
// Products run on the tensor cores through mma.sync (bf16 m16n8k16, and
// s8 m16n8k32 for the int8 Q.K^T), with f32 / s32 accumulators.
//
// Softmax is computed in the base-2 domain like the TPU kernels: log2(e) is
// folded into the logit scale by the caller and exp2 replaces exp.  Masked
// logits are -1e30 (the TPU kernels' NEG_INF) and the final divide guards
// the row sum with max(l, 1e-30).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sa {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;   // query rows per thread block (4 warps x 16)
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kNT = kBlockK / 8;  // m16n8 logit tiles per warp per key tile

// --------------------------------------------------------------------------
// PTX wrappers
// --------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global->shared copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats -> packed bf16x2, low half = first element (mma fragment order)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// --------------------------------------------------------------------------
// tiles
// --------------------------------------------------------------------------

// Copy rows [row0, row0 + kBlockK) of a [L, ROW_BYTES] slab whose rows are
// `g_row_stride` bytes apart into shared memory with a row pitch of
// ROW_BYTES + 16 bytes (the pad keeps the fragment reads bank-conflict
// free).  Rows at or past L are zero-filled.
template <int ROW_BYTES>
__device__ __forceinline__ void load_tile(char* smem, const char* g, long long g_row_stride,
                                          int row0, int L) {
  constexpr int kChunks = ROW_BYTES / 16;
  constexpr int kPitch = ROW_BYTES + 16;
  for (int i = threadIdx.x; i < kBlockK * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < L;
    const char* src = g + (ok ? (long long)(row0 + r) * g_row_stride : 0) + c * 16;
    cp_async16(smem + r * kPitch + c * 16, src, ok);
  }
}

// A fragments of this warp's 16 bf16 query rows (rows >= Lq read as zero).
// q points at element (b, 0, h, 0) of a [B, Lq, N, D] tensor; consecutive
// tokens are `rs` elements apart.
template <int D>
__device__ __forceinline__ void load_q_bf16(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* q,
                                            long long rs, int row_a, int Lq) {
  const int t = threadIdx.x & 3;
  const int row_b = row_a + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = row_a < Lq ? ld32(q + row_a * rs + c) : 0u;
    qa[kk][1] = row_b < Lq ? ld32(q + row_b * rs + c) : 0u;
    qa[kk][2] = row_a < Lq ? ld32(q + row_a * rs + c + 8) : 0u;
    qa[kk][3] = row_b < Lq ? ld32(q + row_b * rs + c + 8) : 0u;
  }
}

// S[16, 64] = Q[16, D] . K_tile[64, D]^T in f32 (bf16 operands).
template <int D>
__device__ __forceinline__ void qk_bf16(float (&s)[kNT][4], const uint32_t (&qa)[D / 16][4],
                                        const unsigned short* Ks) {
  constexpr int kPitch = D + 8;  // elements
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const unsigned short* kr = Ks + (nt * 8 + g) * kPitch + kk * 16 + t * 2;
      mma_bf16_16816(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
    }
  }
}

// Online-softmax update for one key tile (TPU `_fwd_body` lines 158-172).
// `s` holds scaled base-2 logits on entry and the unnormalised
// probabilities p = exp2(s - m_new) on exit.  Keys at or past `klen` are
// masked.  m/l/acc rows: [0] = warp row g, [1] = g + 8.  l is kept as this
// thread's partial row sum and reduced over the quad at finalize.
template <int D>
__device__ __forceinline__ void softmax_update(float (&s)[kNT][4], float (&m)[2], float (&l)[2],
                                               float (&acc)[D / 8][4], int k0, int klen) {
  const int t = threadIdx.x & 3;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (k0 + nt * 8 + t * 2 + e >= klen) {
        s[nt][e] = kNegInf;
        s[nt][2 + e] = kNegInf;
      }
      mx0 = fmaxf(mx0, s[nt][e]);
      mx1 = fmaxf(mx1, s[nt][2 + e]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  const float c0 = exp2f(m[0] - mn0), c1 = exp2f(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = exp2f(s[nt][e] - mn0);
      s[nt][2 + e] = exp2f(s[nt][2 + e] - mn1);
      rs0 += s[nt][e];
      rs1 += s[nt][2 + e];
    }
  }
  l[0] = l[0] * c0 + rs0;
  l[1] = l[1] * c1 + rs1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc[nd][0] *= c0;
    acc[nd][1] *= c0;
    acc[nd][2] *= c1;
    acc[nd][3] *= c1;
  }
}

// acc[16, D] += bf16(P[16, 64]) . V_tile[64, D].  The logit tiles' C
// fragments of two neighbouring n-tiles form one A fragment of P, so P
// never leaves registers.  V is row-major in shared memory; each B
// fragment register packs two keys of one column.
template <int D>
__device__ __forceinline__ void pv_bf16(float (&acc)[D / 8][4], const float (&p)[kNT][4],
                                        const unsigned short* Vs) {
  constexpr int kPitch = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBlockK / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
    const unsigned short* v0 = Vs + (j * 16 + t * 2) * kPitch + g;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const unsigned short* vc = v0 + nd * 8;
      const uint32_t b0 = uint32_t(vc[0]) | (uint32_t(vc[kPitch]) << 16);
      const uint32_t b1 = uint32_t(vc[8 * kPitch]) | (uint32_t(vc[9 * kPitch]) << 16);
      mma_bf16_16816(acc[nd], pa, b0, b1);
    }
  }
}

// Full row sums of this warp's two rows (quad reduction of the partials).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// out rows of this warp (rows >= Lq are not written); o points at element
// (b, 0, h, 0) of a [B, Lq, N, D] bf16 tensor.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, long long rs, int row_a, int Lq,
                                           const float (&val)[D / 8][4]) {
  const int t = threadIdx.x & 3;
  const int row_b = row_a + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + t * 2;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(o + row_a * rs + c) = pack_bf16(val[nd][0], val[nd][1]);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(o + row_b * rs + c) = pack_bf16(val[nd][2], val[nd][3]);
  }
}

}  // namespace sa

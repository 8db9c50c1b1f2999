// Shared building blocks of the mma.sync kernels (K1-rope in
// flash_attention.cu, K4's rope branch in flash_attention_bwd.cu); the wgmma
// forward (K1, K2, K2v, K3, the S3 dots), the fused K4, K5 and mm_probe are
// built on hopper_common.cuh and take only the constants and pack_bf16 /
// quad_sum / ld32 from here.
//
// Tiling, common to these kernels: one thread block of 4 warps owns 64
// query rows of one (batch, head); each warp owns 16 of them and keeps its
// Q fragments, its online-softmax state (running max m, row sum l) and its
// f32 output accumulator in registers for the whole key loop.  K/V tiles of
// 64 keys stream through shared memory with cp.async; the loop over tiles
// inside the block takes the place of the TPU grid's sequential k axis.
// Products run on the tensor cores through mma.sync (bf16 m16n8k16) with f32
// accumulators.
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
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
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


// --------------------------------------------------------------------------
// split-pair rope inside the kernels (TPU `_rot` / `_rot_inv`,
// stableavatar_tpu/ops/flash_attention.py:87-101): pair j of a row sits at
// channels (j, j + D/2); `rope` is the packed fp32 table [L, D] of the
// positions, cos in columns [0, D/2) and sin in [D/2, D).  Products and
// sums are rounded one by one (no fused multiply-add), as the plain PyTorch
// version computes them, and a rotated operand is rounded to bf16 once.
// --------------------------------------------------------------------------

// (x0, x1) -> (x0 c - x1 s, x0 s + x1 c)
__device__ __forceinline__ void rot_pair(float& x0, float& x1, float c, float s) {
  const float y0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
  const float y1 = __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
  x0 = y0;
  x1 = y1;
}

// the inverse (transpose): (g0, g1) -> (g0 c + g1 s, -g0 s + g1 c)
__device__ __forceinline__ void rot_inv_pair(float& g0, float& g1, float c, float s) {
  const float y0 = __fadd_rn(__fmul_rn(g0, c), __fmul_rn(g1, s));
  const float y1 = __fadd_rn(__fmul_rn(-g0, s), __fmul_rn(g1, c));
  g0 = y0;
  g1 = y1;
}

// A fragments of this warp's 16 bf16 query rows, rotated in fp32 on the way
// in (q points at element (b, 0, h, 0) of a [B, Lq, N, D] tensor,
// consecutive tokens `rs` elements apart): the thread that holds channel j
// of a row (fragment kk < D/32) also holds j + D/2 (fragment kk + D/32), so
// each pair rotates in registers.  Rows >= Lq read as zero; rope rows are
// the query positions.
template <int D>
__device__ __forceinline__ void load_q_bf16_rope(uint32_t (&qa)[D / 16][4],
                                                 const __nv_bfloat16* q, long long rs, int row_a,
                                                 int Lq, const float* __restrict__ rope) {
  constexpr int kHalf = D / 2, kH16 = D / 32;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < kH16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // register e: row a / b (e & 1), column + 0 / 8 (e >> 1)
      const int row = row_a + (e & 1) * 8;
      const int c = kk * 16 + t * 2 + (e >> 1) * 8;
      uint32_t lo = 0u, hi = 0u;
      if (row < Lq) {
        const __nv_bfloat16* qr = q + row * rs + c;
        float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr));
        float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + kHalf));
        const float* tr = rope + (long long)row * D + c;
        const float2 cs = *reinterpret_cast<const float2*>(tr);
        const float2 sn = *reinterpret_cast<const float2*>(tr + kHalf);
        rot_pair(x0.x, x1.x, cs.x, sn.x);
        rot_pair(x0.y, x1.y, cs.y, sn.y);
        lo = pack_bf16(x0.x, x0.y);
        hi = pack_bf16(x1.x, x1.y);
      }
      qa[kk][e] = lo;
      qa[kk + kH16][e] = hi;
    }
  }
}

// Rotate a 64-row bf16 tile in shared memory (pitch D + 8 elements, as
// load_tile<2 D> leaves it) in place; tile row r is position row0 + r, and
// rows at or past L (zero-filled) are left alone.  The caller synchronises
// before and after.
template <int D>
__device__ __forceinline__ void rope_tile(unsigned short* tile, const float* __restrict__ rope,
                                          int row0, int L) {
  constexpr int kPitch = D + 8, kHalf = D / 2, kSteps = D / 4;  // two pairs a step
#pragma unroll 4
  for (int i = threadIdx.x; i < kBlockK * kSteps; i += kThreads) {
    const int r = i / kSteps, j = (i % kSteps) * 2;
    if (row0 + r >= L) continue;
    const float* tr = rope + (long long)(row0 + r) * D + j;
    const float2 cs = *reinterpret_cast<const float2*>(tr);
    const float2 sn = *reinterpret_cast<const float2*>(tr + kHalf);
    __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(tile + r * kPitch + j);
    __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(tile + r * kPitch + kHalf + j);
    float2 a = __bfloat1622float2(*lo), b = __bfloat1622float2(*hi);
    rot_pair(a.x, b.x, cs.x, sn.x);
    rot_pair(a.y, b.y, cs.y, sn.y);
    *lo = __floats2bfloat162_rn(a.x, a.y);
    *hi = __floats2bfloat162_rn(b.x, b.y);
  }
}

// Inverse-rotate an fp32 accumulator [16, D] in C-fragment layout (rows
// row_a and row_a + 8 of this thread, columns nd * 8 + 2t and + 1): the
// partner of column j < D/2 is fragment nd + D/16 of the same thread.
// Rows at or past L are left alone (they are never stored).
template <int D>
__device__ __forceinline__ void rope_inv_acc(float (&acc)[D / 8][4], const float* __restrict__ rope,
                                             int row_a, int L) {
  constexpr int kHalf = D / 2, kHN = D / 16;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + r * 8;
    if (row >= L) continue;
    const float* tr = rope + (long long)row * D;
#pragma unroll
    for (int nd = 0; nd < kHN; ++nd) {
      const int c = nd * 8 + t * 2;
      const float2 cs = *reinterpret_cast<const float2*>(tr + c);
      const float2 sn = *reinterpret_cast<const float2*>(tr + kHalf + c);
      rot_inv_pair(acc[nd][2 * r], acc[nd + kHN][2 * r], cs.x, sn.x);
      rot_inv_pair(acc[nd][2 * r + 1], acc[nd + kHN][2 * r + 1], cs.y, sn.y);
    }
  }
}

}  // namespace sa

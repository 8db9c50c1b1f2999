// Flash-attention backward kernels for Hopper (sm_90a): K4a (dK, dV) and K4b
// (dQ).
//
// They replace stableavatar_tpu/ops/flash_attention.py:_flash_bwd_impl, whose
// two Pallas calls run `_bwd_dkdv_body` over the grid (B*N, k-blocks,
// q-blocks) and `_bwd_dq_body` over (B*N, q-blocks, k-blocks).  Inputs are
// the forward's q, k, v and the output gradient dO, all [B, L, N, D] bf16,
// the forward's natural-log LSE [B, N, Lq] fp32 (K1 with `lse`) and
// delta = rowsum(dO * O) [B, N, Lq] fp32 (a plain torch op, as it was a jnp
// op outside Pallas).  Both kernels recompute the probabilities from the LSE
// in the base-2 domain exactly as the TPU bodies do:
//
//   s  = (q . k^T) * scale * log2(e),  keys at or past k_lens[b] -> p = 0
//   p  = exp2(s - lse * log2(e)),      rows with lse <= -5e29 -> p = 0
//   dp = dO . v^T
//   ds = p * (dp - delta) * scale
//
// K4a: one block owns 64 keys of one (batch, head) (4 warps x 16 keys) and
// loops over all query tiles of 64: dV += bf16(P)^T . dO and
// dK += bf16(dS)^T . Q accumulate in fp32 registers.  A block whose keys all
// lie at or past k_lens[b] writes zeros without reading anything.
// K4b: one block owns 64 query rows and loops over the key tiles below
// k_lens[b]: dQ += bf16(dS) . K in fp32 registers.
//
// The rope branch (ROPE; `flash_attention(rope=)` under autograd) takes
// unrotated split-pair q and k and the packed fp32 table [L, D], as the TPU
// bodies do (`_rot` at :731-732 / :804-805, `_rot_inv` at :771 / :837):
// every q and k tile is rotated in place in shared memory where it is
// staged (rope_tile, fp32, one bf16 rounding), so the main loop and its
// registers are the unroped kernel's, and the fp32 dK (K4a) and dQ (K4b)
// accumulators are inverse-rotated once before the store.  dV and delta
// do not change.
//
// Layout: the kernels read q/k/v/dO straight from the [B, L, N, D]
// activations and write dq/dk/dv in bf16 the same way; ragged Lq and Lk are
// masked in-kernel (no padding or transpose pass).  The four 64-row operand
// tiles of a block live in dynamic shared memory (70 KB at D = 128); the
// A fragments of every product are read from shared memory per use, so that
// only the fp32 accumulators and one logit tile stay in registers.
//
// What bounds them on the H100: at the DiT self-attention shape (B*N = 12,
// L = 21,504, D = 128) the five L^2*D products per head make both kernels
// compute-bound (7.1e12 flop against ~0.3 GB of operands).  This first
// version uses mma.sync with one cp.async stage per tile; wgmma, TMA and a
// multi-stage pipeline are later work.
#include "attention_common.cuh"

namespace sa {

constexpr int kTiles = 4;  // 64-row bf16 operand tiles per block

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

template <int D>
constexpr int bwd_smem_bytes() {
  return kTiles * kBlockK * (D + 8) * 2 + 2 * kBlockK * 4;
}

// S[16, 64] = A[16, D] . B[64, D]^T in f32; A is this warp's 16 rows in
// shared memory (pitch D + 8 elements), B a 64-row tile in shared memory.
template <int D>
__device__ __forceinline__ void mm_rows(float (&s)[kNT][4], const unsigned short* As,
                                        const unsigned short* Bs) {
  constexpr int kPitch = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const unsigned short* ar = As + g * kPitch + kk * 16 + t * 2;
    const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * kPitch), ld32(ar + 8),
                           ld32(ar + 8 * kPitch + 8)};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const unsigned short* br = Bs + (nt * 8 + g) * kPitch + kk * 16 + t * 2;
      mma_bf16_16816(s[nt], a, ld32(br), ld32(br + 8));
    }
  }
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ k_lens, const float* __restrict__ rope,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int N, float scale,
                      float scale_log2) {
  constexpr int kPitch = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* Ks = reinterpret_cast<unsigned short*>(smem);
  unsigned short* Vs = Ks + kBlockK * kPitch;
  unsigned short* Qs = Vs + kBlockK * kPitch;
  unsigned short* dOs = Qs + kBlockK * kPitch;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlockK * kPitch);  // lse * log2(e)
  float* delta_s = lse_s + kBlockK;

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kb0 = blockIdx.x * kBlockK;
  const int key_a = kb0 + warp * 16 + g, key_b = key_a + 8;
  const long long rs = (long long)N * D;
  const long long k_off = ((long long)b * Lk * N + h) * D;
  const long long q_off = ((long long)b * Lq * N + h) * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    dk_acc[nd][0] = dk_acc[nd][1] = dk_acc[nd][2] = dk_acc[nd][3] = 0.f;
    dv_acc[nd][0] = dv_acc[nd][1] = dv_acc[nd][2] = dv_acc[nd][3] = 0.f;
  }

  if (kb0 < klen) {
    load_tile<D * 2>(reinterpret_cast<char*>(Ks), reinterpret_cast<const char*>(k + k_off),
                     rs * 2, kb0, Lk);
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), reinterpret_cast<const char*>(v + k_off),
                     rs * 2, kb0, Lk);
    cp_async_commit();
    if constexpr (ROPE) {
      // the block's keys, rotated once (read after the loop's first barrier)
      cp_async_wait<0>();
      __syncthreads();
      rope_tile<D>(Ks, rope, kb0, Lk);
    }
    const float* lse_bh = lse + (long long)bh * Lq;
    const float* delta_bh = delta + (long long)bh * Lq;
    const unsigned short* Kw = Ks + warp * 16 * kPitch;
    const unsigned short* Vw = Vs + warp * 16 * kPitch;

    const int nq = (Lq + kBlockK - 1) / kBlockK;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * kBlockK;
      load_tile<D * 2>(reinterpret_cast<char*>(Qs), reinterpret_cast<const char*>(q + q_off),
                       rs * 2, q0, Lq);
      cp_async_commit();
      load_tile<D * 2>(reinterpret_cast<char*>(dOs),
                       reinterpret_cast<const char*>(dout + q_off), rs * 2, q0, Lq);
      cp_async_commit();
      if (threadIdx.x < kBlockK) {
        const int r = q0 + threadIdx.x;
        const float lv = r < Lq ? lse_bh[r] : kNegInf;
        // +inf makes p = exp2(s - inf) = 0: padded rows and the TPU body's
        // lse > NEG_INF / 2 guard
        lse_s[threadIdx.x] = lv > kNegInf * 0.5f ? lv * kLog2e : pos_inf();
        delta_s[threadIdx.x] = r < Lq ? delta_bh[r] : 0.f;
      }
      cp_async_wait<1>();
      __syncthreads();
      if constexpr (ROPE) {
        rope_tile<D>(Qs, rope, q0, Lq);
        __syncthreads();
      }

      // P^T [16 keys, 64 queries]
      float p[kNT][4];
      mm_rows<D>(p, Kw, Qs);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l2 = lse_s[nt * 8 + t * 2 + e];
          p[nt][e] = key_a < klen ? exp2f(p[nt][e] * scale_log2 - l2) : 0.f;
          p[nt][2 + e] = key_b < klen ? exp2f(p[nt][2 + e] * scale_log2 - l2) : 0.f;
        }
      }
      cp_async_wait<0>();
      __syncthreads();

      pv_bf16<D>(dv_acc, p, dOs);  // dV += P^T . dO
      float dp[kNT][4];
      mm_rows<D>(dp, Vw, dOs);  // dP^T = V . dO^T
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = delta_s[nt * 8 + t * 2 + e];
          p[nt][e] = p[nt][e] * (dp[nt][e] - dl) * scale;
          p[nt][2 + e] = p[nt][2 + e] * (dp[nt][2 + e] - dl) * scale;
        }
      }
      pv_bf16<D>(dk_acc, p, Qs);  // dK += dS^T . Q
      __syncthreads();
    }
  }
  if constexpr (ROPE) rope_inv_acc<D>(dk_acc, rope, key_a, Lk);
  store_rows<D>(dk + k_off, rs, key_a, Lk, dk_acc);
  store_rows<D>(dv + k_off, rs, key_a, Lk, dv_acc);
}

template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ k_lens, const float* __restrict__ rope,
                    __nv_bfloat16* __restrict__ dq, int Lq,
                    int Lk, int N, float scale, float scale_log2) {
  constexpr int kPitch = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* Qs = reinterpret_cast<unsigned short*>(smem);
  unsigned short* dOs = Qs + kBlockK * kPitch;
  unsigned short* Ks = dOs + kBlockK * kPitch;
  unsigned short* Vs = Ks + kBlockK * kPitch;

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const long long rs = (long long)N * D;
  const long long k_off = ((long long)b * Lk * N + h) * D;
  const long long q_off = ((long long)b * Lq * N + h) * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;

  load_tile<D * 2>(reinterpret_cast<char*>(Qs), reinterpret_cast<const char*>(q + q_off),
                   rs * 2, q0, Lq);
  load_tile<D * 2>(reinterpret_cast<char*>(dOs), reinterpret_cast<const char*>(dout + q_off),
                   rs * 2, q0, Lq);
  cp_async_commit();

  // this thread's two rows: lse * log2(e) (+inf where p must be 0) and delta
  const float* lse_bh = lse + (long long)bh * Lq;
  const float* delta_bh = delta + (long long)bh * Lq;
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? row_b : row_a;
    const float lv = r < Lq ? lse_bh[r] : kNegInf;
    l2[i] = lv > kNegInf * 0.5f ? lv * kLog2e : pos_inf();
    dl[i] = r < Lq ? delta_bh[r] : 0.f;
  }
  if constexpr (ROPE) {
    // the block's queries, rotated once (read after the loop's first barrier)
    cp_async_wait<0>();
    __syncthreads();
    rope_tile<D>(Qs, rope, q0, Lq);
  }
  const unsigned short* Qw = Qs + warp * 16 * kPitch;
  const unsigned short* dOw = dOs + warp * 16 * kPitch;

  float dq_acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq_acc[nd][0] = dq_acc[nd][1] = dq_acc[nd][2] = dq_acc[nd][3] = 0.f;

  const int ntiles = (klen + kBlockK - 1) / kBlockK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<D * 2>(reinterpret_cast<char*>(Ks), reinterpret_cast<const char*>(k + k_off),
                     rs * 2, k0, Lk);
    cp_async_commit();
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), reinterpret_cast<const char*>(v + k_off),
                     rs * 2, k0, Lk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (ROPE) {
      rope_tile<D>(Ks, rope, k0, Lk);
      __syncthreads();
    }

    float p[kNT][4];
    mm_rows<D>(p, Qw, Ks);  // S [16 queries, 64 keys]
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + nt * 8 + t * 2 + e < klen;
        p[nt][e] = ok ? exp2f(p[nt][e] * scale_log2 - l2[0]) : 0.f;
        p[nt][2 + e] = ok ? exp2f(p[nt][2 + e] * scale_log2 - l2[1]) : 0.f;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    float dp[kNT][4];
    mm_rows<D>(dp, dOw, Vs);  // dP = dO . V^T
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = p[nt][e] * (dp[nt][e] - dl[0]) * scale;
        p[nt][2 + e] = p[nt][2 + e] * (dp[nt][2 + e] - dl[1]) * scale;
      }
    }
    pv_bf16<D>(dq_acc, p, Ks);  // dQ += dS . K
    __syncthreads();
  }
  if constexpr (ROPE) rope_inv_acc<D>(dq_acc, rope, row_a, Lq);
  store_rows<D>(dq + q_off, rs, row_a, Lq, dq_acc);
}

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns the first CUDA error (0 on success).  k_lens
// may be NULL (every key valid); lse and delta are [B, N, Lq] fp32; the
// rope entry points take the packed fp32 table rope [L, D] (L >= Lq, Lk).
// --------------------------------------------------------------------------

namespace {

template <bool ROPE>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* k_lens, const void* rope, void* dk, void* dv,
                int B, int Lq, int Lk, int N, int D, float scale, float scale_log2,
                void* stream) {
  const dim3 grid((Lk + sa::kBlockK - 1) / sa::kBlockK, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k_ = static_cast<const __nv_bfloat16*>(k);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto do_ = static_cast<const __nv_bfloat16*>(dout);
  auto l_ = static_cast<const float*>(lse);
  auto d_ = static_cast<const float*>(delta);
  auto kl = static_cast<const int*>(k_lens);
  auto r_ = static_cast<const float*>(rope);
  auto dk_ = static_cast<__nv_bfloat16*>(dk);
  auto dv_ = static_cast<__nv_bfloat16*>(dv);
  int rc;
  if (D == 128) {
    constexpr int smem = sa::bwd_smem_bytes<128>();
    if ((rc = sa::allow_smem(sa::flash_bwd_dkdv_kernel<128, ROPE>, smem))) return rc;
    sa::flash_bwd_dkdv_kernel<128, ROPE><<<grid, sa::kThreads, smem, st>>>(
        q_, k_, v_, do_, l_, d_, kl, r_, dk_, dv_, Lq, Lk, N, scale, scale_log2);
  } else if (D == 64) {
    constexpr int smem = sa::bwd_smem_bytes<64>();
    if ((rc = sa::allow_smem(sa::flash_bwd_dkdv_kernel<64, ROPE>, smem))) return rc;
    sa::flash_bwd_dkdv_kernel<64, ROPE><<<grid, sa::kThreads, smem, st>>>(
        q_, k_, v_, do_, l_, d_, kl, r_, dk_, dv_, Lq, Lk, N, scale, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool ROPE>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* k_lens, const void* rope, void* dq, int B, int Lq,
              int Lk, int N, int D, float scale, float scale_log2, void* stream) {
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k_ = static_cast<const __nv_bfloat16*>(k);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto do_ = static_cast<const __nv_bfloat16*>(dout);
  auto l_ = static_cast<const float*>(lse);
  auto d_ = static_cast<const float*>(delta);
  auto kl = static_cast<const int*>(k_lens);
  auto r_ = static_cast<const float*>(rope);
  auto dq_ = static_cast<__nv_bfloat16*>(dq);
  int rc;
  if (D == 128) {
    constexpr int smem = sa::bwd_smem_bytes<128>();
    if ((rc = sa::allow_smem(sa::flash_bwd_dq_kernel<128, ROPE>, smem))) return rc;
    sa::flash_bwd_dq_kernel<128, ROPE><<<grid, sa::kThreads, smem, st>>>(
        q_, k_, v_, do_, l_, d_, kl, r_, dq_, Lq, Lk, N, scale, scale_log2);
  } else if (D == 64) {
    constexpr int smem = sa::bwd_smem_bytes<64>();
    if ((rc = sa::allow_smem(sa::flash_bwd_dq_kernel<64, ROPE>, smem))) return rc;
    sa::flash_bwd_dq_kernel<64, ROPE><<<grid, sa::kThreads, smem, st>>>(
        q_, k_, v_, do_, l_, d_, kl, r_, dq_, Lq, Lk, N, scale, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sa_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* k_lens,
                                 void* dk, void* dv, int B, int Lq, int Lk, int N, int D,
                                 float scale, float scale_log2, void* stream) {
  return launch_dkdv<false>(q, k, v, dout, lse, delta, k_lens, nullptr, dk, dv, B, Lq, Lk, N, D,
                            scale, scale_log2, stream);
}

extern "C" int sa_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* k_lens, void* dq,
                               int B, int Lq, int Lk, int N, int D, float scale, float scale_log2,
                               void* stream) {
  return launch_dq<false>(q, k, v, dout, lse, delta, k_lens, nullptr, dq, B, Lq, Lk, N, D, scale,
                          scale_log2, stream);
}

// K4a with the rope branch: q and k unrotated (split-pair), dK inverse-rotated
extern "C" int sa_flash_bwd_dkdv_rope(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* k_lens, const void* rope, void* dk, void* dv,
                                      int B, int Lq, int Lk, int N, int D, float scale,
                                      float scale_log2, void* stream) {
  if (rope == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dkdv<true>(q, k, v, dout, lse, delta, k_lens, rope, dk, dv, B, Lq, Lk, N, D,
                           scale, scale_log2, stream);
}

// K4b with the rope branch: dQ inverse-rotated
extern "C" int sa_flash_bwd_dq_rope(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    const void* k_lens, const void* rope, void* dq, int B, int Lq,
                                    int Lk, int N, int D, float scale, float scale_log2,
                                    void* stream) {
  if (rope == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dq<true>(q, k, v, dout, lse, delta, k_lens, rope, dq, B, Lq, Lk, N, D, scale,
                         scale_log2, stream);
}

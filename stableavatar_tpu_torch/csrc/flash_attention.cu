// Flash-attention forward kernels for Hopper (sm_90a): K1 (bf16) and K2
// (int8 Q.K^T).
//
// K1 replaces stableavatar_tpu/ops/flash_attention.py:_flash_fwd_impl (body
// `_fwd_body`): softmax(q k^T * scale) v over [B, L, N, D] bf16 with keys at
// or past k_lens[b] masked; forward only, no LSE output, rope applied by the
// caller.
//
// K2 replaces stableavatar_tpu/ops/flash_attention.py:_flash_int8_impl with
// quant="qk" (body `_int8_fwd_body`): Q and K arrive as int8 with one scale
// per (batch, head) slab (the prep is plain torch, as it was XLA on the TPU);
// the kernel runs Q8.K8^T on the s8 tensor cores into s32, multiplies by
// sqk[b*N + h] = sq * sk * scale * log2(e), then the same online softmax
// and bf16 P.V as K1.  K is read row-major [B, L, N, D]: the TPU's [D, L]
// pre-transpose is a layout of its matrix unit and has no use here.
//
// What bounds them on the H100: at the DiT self-attention shape (B*N = 36,
// L = 21,504, D = 128) both are compute-bound -- 4*L^2*D flops per head
// against 3*L*D*2 bytes per head read once per 64-row query tile from L2.
// Both kernels read Q, K and V straight from the [B, L, N, D] activations
// (no transpose or padding pass), keep the logits and probabilities in
// registers, and keep K/V tiles in shared memory shared by 4 warps.  This
// first version uses mma.sync rather than wgmma and has a single K/V stage
// (the V copy overlaps the Q.K^T and softmax of the same tile); wgmma, TMA
// and warp specialisation are later work.
#include "attention_common.cuh"

namespace sa {

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ k_lens,
                      __nv_bfloat16* __restrict__ out, int Lq, int Lk, int N, float scale_log2) {
  constexpr int kPitch = D + 8;
  __shared__ __align__(16) unsigned short Ks[kBlockK * kPitch];
  __shared__ __align__(16) unsigned short Vs[kBlockK * kPitch];

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + (lane >> 2);
  const long long rs = (long long)N * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;

  uint32_t qa[D / 16][4];
  load_q_bf16<D>(qa, q + ((long long)b * Lq * N + h) * D, rs, row_a, Lq);

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
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_int8_qk_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ sqk,
                         const int* __restrict__ k_lens, __nv_bfloat16* __restrict__ out, int Lq,
                         int Lk, int N) {
  constexpr int kPitch8 = D + 16;  // bytes
  constexpr int kPitch = D + 8;    // bf16 elements
  __shared__ __align__(16) int8_t Ks[kBlockK * kPitch8];
  __shared__ __align__(16) unsigned short Vs[kBlockK * kPitch];

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + g, row_b = row_a + 8;
  const long long rs = (long long)N * D;
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;
  const float scale = sqk[bh];

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
  const char* vb = reinterpret_cast<const char*>(v + ((long long)b * Lk * N + h) * D);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int ntiles = (klen + kBlockK - 1) / kBlockK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<D>(reinterpret_cast<char*>(Ks), kb, rs, k0, Lk);
    cp_async_commit();
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), vb, rs * 2, k0, Lk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

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
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = float(si[nt][0]) * scale;
      s[nt][1] = float(si[nt][1]) * scale;
      s[nt][2] = float(si[nt][2]) * scale;
      s[nt][3] = float(si[nt][3]) * scale;
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
}

}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().  k_lens may be NULL
// (every key valid).
// --------------------------------------------------------------------------

extern "C" int sa_flash_fwd_bf16(const void* q, const void* k, const void* v, const void* k_lens,
                                 void* out, int B, int Lq, int Lk, int N, int D,
                                 float scale_log2, void* stream) {
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k_ = static_cast<const __nv_bfloat16*>(k);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto kl = static_cast<const int*>(k_lens);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    sa::flash_fwd_bf16_kernel<128><<<grid, sa::kThreads, 0, st>>>(q_, k_, v_, kl, o_, Lq, Lk, N,
                                                                  scale_log2);
  } else if (D == 64) {
    sa::flash_fwd_bf16_kernel<64><<<grid, sa::kThreads, 0, st>>>(q_, k_, v_, kl, o_, Lq, Lk, N,
                                                                 scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sa_flash_fwd_int8_qk(const void* q8, const void* k8, const void* v,
                                    const void* sqk, const void* k_lens, void* out, int B, int Lq,
                                    int Lk, int N, int D, void* stream) {
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const int8_t*>(q8);
  auto k_ = static_cast<const int8_t*>(k8);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto s_ = static_cast<const float*>(sqk);
  auto kl = static_cast<const int*>(k_lens);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    sa::flash_fwd_int8_qk_kernel<128><<<grid, sa::kThreads, 0, st>>>(q_, k_, v_, s_, kl, o_, Lq,
                                                                     Lk, N);
  } else if (D == 64) {
    sa::flash_fwd_int8_qk_kernel<64><<<grid, sa::kThreads, 0, st>>>(q_, k_, v_, s_, kl, o_, Lq,
                                                                    Lk, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

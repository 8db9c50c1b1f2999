// Dual-context cross-attention for Hopper (sm_90a): K5.
//
// Replaces stableavatar_tpu/ops/cross_attention.py:dual_context_attention
// (body `_dual_body`): out = attn(q, k1, v1) + attn(q, k2, v2), two separate
// softmaxes over the text (L1 = 512) and CLIP-image (L2 = 257) contexts,
// summed, with q read once and out written once.
//
// The TPU kernel pads each segment to 128 lanes, concatenates them into one
// resident [768, D] block and takes one exact softmax per segment over a
// [block_q, 768] logit tile.  Here a 64 x 769 f32 logit tile does not fit a
// block's registers, so each segment runs the same online softmax as the
// flash kernels (two accumulators, two row sums, two running maxima) over
// 64-key tiles, and the output is acc1 / l1 + acc2 / l2.  No padding
// columns exist: the ragged tile edge of each segment is masked in-kernel.
//
// Numerics: the TPU kernel normalises P per segment before one bf16 P.V
// product; this kernel rounds the unnormalised P (relative to the running
// max) to bf16 and divides at the end, so the two agree up to bf16 rounding
// of P.
//
// What bounds it on the H100: per (batch, head) the kernel does
// 4 * Lq * (L1 + L2) * D flops against reading Lq * D * 2 bytes of q and
// writing as many -- at Lq = 21,504, L1 + L2 = 769 that is about 770 flops
// per byte of q/out traffic, above the card's ~295 bf16 flops/byte ridge but
// not by much, so it sits near the line.  Each 64-row query tile reads q once
// into registers and streams the 769 context rows through shared memory
// (they stay resident in L2 across query tiles).
#include "attention_common.cuh"

namespace sa {

// One segment of the dual softmax: the online loop over its key tiles.
template <int D>
__device__ __forceinline__ void attend_segment(const uint32_t (&qa)[D / 16][4], const char* kb,
                                               const char* vb, long long row_bytes, int L,
                                               float scale_log2, unsigned short* Ks,
                                               unsigned short* Vs, float (&m)[2], float (&l)[2],
                                               float (&acc)[D / 8][4]) {
  const int ntiles = (L + kBlockK - 1) / kBlockK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<D * 2>(reinterpret_cast<char*>(Ks), kb, row_bytes, k0, L);
    cp_async_commit();
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), vb, row_bytes, k0, L);
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
    softmax_update<D>(s, m, l, acc, k0, L);

    cp_async_wait<0>();
    __syncthreads();
    pv_bf16<D>(acc, s, Vs);
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dual_context_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k1,
                    const __nv_bfloat16* __restrict__ v1, const __nv_bfloat16* __restrict__ k2,
                    const __nv_bfloat16* __restrict__ v2, __nv_bfloat16* __restrict__ out, int Lq,
                    int L1, int L2, int N, float scale_log2) {
  constexpr int kPitch = D + 8;
  __shared__ __align__(16) unsigned short Ks[kBlockK * kPitch];
  __shared__ __align__(16) unsigned short Vs[kBlockK * kPitch];

  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + (lane >> 2);
  const long long rs = (long long)N * D;

  uint32_t qa[D / 16][4];
  load_q_bf16<D>(qa, q + ((long long)b * Lq * N + h) * D, rs, row_a, Lq);

  float m1[2] = {kNegInf, kNegInf}, l1[2] = {0.f, 0.f};
  float m2[2] = {kNegInf, kNegInf}, l2[2] = {0.f, 0.f};
  float acc1[D / 8][4], acc2[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc1[nd][0] = acc1[nd][1] = acc1[nd][2] = acc1[nd][3] = 0.f;
    acc2[nd][0] = acc2[nd][1] = acc2[nd][2] = acc2[nd][3] = 0.f;
  }

  attend_segment<D>(qa, reinterpret_cast<const char*>(k1 + ((long long)b * L1 * N + h) * D),
                    reinterpret_cast<const char*>(v1 + ((long long)b * L1 * N + h) * D), rs * 2,
                    L1, scale_log2, Ks, Vs, m1, l1, acc1);
  attend_segment<D>(qa, reinterpret_cast<const char*>(k2 + ((long long)b * L2 * N + h) * D),
                    reinterpret_cast<const char*>(v2 + ((long long)b * L2 * N + h) * D), rs * 2,
                    L2, scale_log2, Ks, Vs, m2, l2, acc2);

  const float a0 = fmaxf(quad_sum(l1[0]), 1e-30f), a1 = fmaxf(quad_sum(l1[1]), 1e-30f);
  const float c0 = fmaxf(quad_sum(l2[0]), 1e-30f), c1 = fmaxf(quad_sum(l2[1]), 1e-30f);
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    acc1[nd][0] = acc1[nd][0] / a0 + acc2[nd][0] / c0;
    acc1[nd][1] = acc1[nd][1] / a0 + acc2[nd][1] / c0;
    acc1[nd][2] = acc1[nd][2] / a1 + acc2[nd][2] / c1;
    acc1[nd][3] = acc1[nd][3] / a1 + acc2[nd][3] / c1;
  }
  store_rows<D>(out + ((long long)b * Lq * N + h) * D, rs, row_a, Lq, acc1);
}

}  // namespace sa

// Plain C entry point (loaded with ctypes): launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int sa_dual_context(const void* q, const void* k1, const void* v1, const void* k2,
                               const void* v2, void* out, int B, int Lq, int L1, int L2, int N,
                               int D, float scale_log2, void* stream) {
  const dim3 grid((Lq + sa::kBlockQ - 1) / sa::kBlockQ, B * N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k1_ = static_cast<const __nv_bfloat16*>(k1);
  auto v1_ = static_cast<const __nv_bfloat16*>(v1);
  auto k2_ = static_cast<const __nv_bfloat16*>(k2);
  auto v2_ = static_cast<const __nv_bfloat16*>(v2);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    sa::dual_context_kernel<128><<<grid, sa::kThreads, 0, st>>>(q_, k1_, v1_, k2_, v2_, o_, Lq, L1,
                                                               L2, N, scale_log2);
  } else if (D == 64) {
    sa::dual_context_kernel<64><<<grid, sa::kThreads, 0, st>>>(q_, k1_, v1_, k2_, v2_, o_, Lq, L1,
                                                              L2, N, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

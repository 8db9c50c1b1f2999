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
// block's registers, so each segment sweeps its keys twice in 64-key tiles:
// the first sweep takes the row max m and the row sum l of exp2(s - m)
// (online, K tiles only); the second recomputes the logits and forms the
// normalised p = exp2(s - m) * (1 / max(l, 1e-30)), rounds it to bf16 and
// adds p . V into one fp32 accumulator that both segments share.  So P is
// rounded where the TPU body rounds it (normalised, per segment, before one
// P.V over both segments) and the output is rounded once.  No padding
// columns exist: the ragged tile edge of each segment is masked in-kernel.
//
// What bounds it on the H100: per (batch, head) the two sweeps do
// 6 * Lq * (L1 + L2) * D flops (Q.K^T twice, P.V once) against reading
// Lq * D * 2 bytes of q and writing as many -- at Lq = 21,504, L1 + L2 = 769
// that is about 1,150 flops per byte of q/out traffic, above the card's
// ~295 bf16 flops/byte ridge: compute-bound.  Each 64-row query tile reads
// q once into registers and streams the 769 context rows through shared
// memory (they stay resident in L2 across query tiles).
#include "attention_common.cuh"

namespace sa {

// Scaled base-2 logits of one key tile, keys at or past L masked to -1e30.
template <int D>
__device__ __forceinline__ void segment_logits(float (&s)[kNT][4], const uint32_t (&qa)[D / 16][4],
                                               const unsigned short* Ks, int k0, int L,
                                               float scale_log2) {
  const int t = threadIdx.x & 3;
  qk_bf16<D>(s, qa, Ks);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = k0 + nt * 8 + t * 2 + e < L;
      s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
      s[nt][2 + e] = ok ? s[nt][2 + e] * scale_log2 : kNegInf;
    }
  }
}

// One segment: sweep 1 (row max and row sum), then sweep 2 (normalised,
// bf16-rounded P times V into acc).
template <int D>
__device__ __forceinline__ void attend_segment(const uint32_t (&qa)[D / 16][4], const char* kb,
                                               const char* vb, long long row_bytes, int L,
                                               float scale_log2, unsigned short* Ks,
                                               unsigned short* Vs, float (&acc)[D / 8][4]) {
  const int ntiles = (L + kBlockK - 1) / kBlockK;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<D * 2>(reinterpret_cast<char*>(Ks), kb, row_bytes, k0, L);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[kNT][4];
    segment_logits<D>(s, qa, Ks, k0, L, scale_log2);
    __syncthreads();
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      rs0 += exp2f(s[nt][0] - mn0) + exp2f(s[nt][1] - mn0);
      rs1 += exp2f(s[nt][2] - mn1) + exp2f(s[nt][3] - mn1);
    }
    l[0] = l[0] * exp2f(m[0] - mn0) + rs0;
    l[1] = l[1] * exp2f(m[1] - mn1) + rs1;
    m[0] = mn0;
    m[1] = mn1;
  }
  // the reciprocal of the clamped row sum, as the TPU body multiplies by it
  const float r0 = 1.0f / fmaxf(quad_sum(l[0]), 1e-30f);
  const float r1 = 1.0f / fmaxf(quad_sum(l[1]), 1e-30f);
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<D * 2>(reinterpret_cast<char*>(Ks), kb, row_bytes, k0, L);
    cp_async_commit();
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), vb, row_bytes, k0, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[kNT][4];
    segment_logits<D>(s, qa, Ks, k0, L, scale_log2);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m[0]) * r0;
      s[nt][1] = exp2f(s[nt][1] - m[0]) * r0;
      s[nt][2] = exp2f(s[nt][2] - m[1]) * r1;
      s[nt][3] = exp2f(s[nt][3] - m[1]) * r1;
    }
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

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  attend_segment<D>(qa, reinterpret_cast<const char*>(k1 + ((long long)b * L1 * N + h) * D),
                    reinterpret_cast<const char*>(v1 + ((long long)b * L1 * N + h) * D), rs * 2,
                    L1, scale_log2, Ks, Vs, acc);
  attend_segment<D>(qa, reinterpret_cast<const char*>(k2 + ((long long)b * L2 * N + h) * D),
                    reinterpret_cast<const char*>(v2 + ((long long)b * L2 * N + h) * D), rs * 2,
                    L2, scale_log2, Ks, Vs, acc);
  store_rows<D>(out + ((long long)b * Lq * N + h) * D, rs, row_a, Lq, acc);
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

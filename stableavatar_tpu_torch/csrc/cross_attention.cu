// Dual-context cross-attention for Hopper (sm_90a): K5.
//
// Replaces stableavatar_tpu/ops/cross_attention.py:dual_context_attention
// (body `_dual_body`): out = attn(q, k1, v1) + attn(q, k2, v2), two separate
// softmaxes over the text (L1 = 512) and CLIP-image (L2 = 257) contexts,
// summed, with q read once and out written once.
//
// The TPU kernel pads each segment to 128 lanes, concatenates them into one
// resident [768, D] block and takes one exact softmax per segment over a
// [block_q, 768] logit tile.  A 64 x 769 fp32 logit tile does not fit a
// warpgroup's registers, so each segment sweeps its keys twice: sweep 1 takes
// the row max m and the row sum l of exp2(s - m) (online, K tiles only);
// sweep 2 recomputes the logits and forms the normalised p = exp2(s - m) *
// (1 / max(l, 1e-30)), rounds it to bf16 and adds p . V into one fp32
// accumulator that both segments share.  So P is rounded where the TPU body
// rounds it (normalised, per segment, before one P.V over both segments) and
// the output is rounded once.  No padding columns exist: each segment's
// ragged last tile is masked in the kernel.
//
// What bounds it on the H100: per (batch, head) 4 * Lq * (L1 + L2) * D
// operations by the TPU's count (Q.K^T and P.V once), 0.308 ms at 989 TFLOP/s
// for q [3, 21504, 12, 128] against 512 + 257 keys; the two sweeps issue
// Q.K^T twice over 512 + 384 key columns, 0.54 ms of tensor work.  Beside
// the tensor cores: the SFUs (one exp2 per logit and sweep), the L2 -> SM
// traffic (every 128-row block reads K twice and V once) and, in each
// warpgroup, the chain S -> statistics of sweep 1, which nothing overlaps
// but the other warpgroup's products.  On the card neither the SFUs nor the
// traffic bound it (PERF.md: without either it ran no faster); the
// chain does.  The design (`dual_context_kernel<D>`, D = 128 and 64):
//
// - a block owns 128 query rows of one (batch, head): one producer thread (a
//   warpgroup with its registers handed over by setmaxnreg, 24 / 240) loads
//   Q once by TMA and streams the schedule text K (sweep 1), text K + V
//   (sweep 2), image K, image K + V through two mbarrier rings in dynamic
//   shared memory (4 K stages, 2 V stages, 128-byte swizzle, 224 KB at D =
//   128), from 3-D tensor maps over [B, L, N * D] whose rows past L read as
//   zeros;
// - two consumer warpgroups own 64 query rows each: S = Q K^T is a wgmma
//   m64n128 chain with both operands K-major in shared memory, the softmax
//   runs in registers in wgmma's accumulator layout (exp2 as one MUFU.EX2),
//   P is packed to bf16 A fragments and O += P V is a register-A wgmma with V
//   MN-major; O stays in fp32 registers across both segments.  In sweep 2, S
//   of tile j + 1 is issued before P V of tile j and its exp2 runs while that
//   product is on the tensor cores; the two warpgroups do not wait for each
//   other (the variants measured against this layout: PERF.md section 6);
// - O is rounded to bf16 once, written into the warpgroup's own Q rows in
//   shared memory (the 128-byte swizzle, free of bank conflicts) and stored
//   by TMA, which clips the rows past Lq.
#include "hopper_common.cuh"

namespace sa {
namespace k5 {

constexpr int kBlockM = 128;  // query rows per block: two consumer warpgroups of 64
constexpr int kBlockN = 128;  // keys per K / V tile (ops/cross_attention.py: KERNEL_BLOCK_K)
constexpr int kKStages = 4;   // sweep 1 streams K alone: K runs ahead of V
constexpr int kVStages = 2;
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int kRow = 128;      // bytes of one swizzled bf16 row (64 bf16)

// shared-memory layout (byte offsets from a 1024-byte boundary)
template <int D>
struct Smem {
  static constexpr int kQ = D / 64 * kBlockM * kRow;  // the block's Q (then its O)
  static constexpr int kT = D / 64 * kBlockN * kRow;  // one K or V stage
  static constexpr int off_q = 0;
  static constexpr int off_k = kQ;
  static constexpr int off_v = off_k + kKStages * kT;
  static constexpr int off_bar = off_v + kVStages * kT;
  // q_full, k_full[kKStages], k_empty[kKStages], v_full[kVStages], v_empty[kVStages]
  static constexpr int bytes = off_bar + (1 + 2 * (kKStages + kVStages)) * 8;
  static constexpr int launch_bytes = bytes + 1024;  // room to align the base
};

// 2^x on the SFU, results below 2^-126 flushed to 0 (exp2f wraps the same
// MUFU.EX2 in a range fix-up of three more instructions: 5% of K5's time)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S[64, 128] = Q K^T of one K tile, both operands K-major; issued and
// committed, not waited for
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_wg, uint32_t kb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qo = (kk >> 2) * kBlockM * kRow + (kk & 3) * 32;
    const uint32_t ko = (kk >> 2) * kBlockN * kRow + (kk & 3) * 32;
    wgmma_ss_n128<0, 0>(s, make_desc(q_wg + qo, 16, 1024), make_desc(kb + ko, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Keys at or past `nvalid` of a segment's last tile get the logit -1e30
// (TMA's zero fill is not a mask: a zero key has logit 0), so that both
// sweeps give them p = 0.  Element 4j + e of the accumulator layout is row
// g (e < 2) or g + 8, key 8j + 2t + (e & 1)
__device__ __forceinline__ void mask_tile(float (&s)[64], int nvalid) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (8 * j + 2 * t + (e & 1) >= nvalid) s[4 * j + e] = kNegInf;
    }
  }
}

// Sweep 1 on one tile: fold its raw logits into the base-2 running max m
// (scaled by c = scale * log2 e) and this thread's partial row sums l of
// rows g and g + 8
__device__ __forceinline__ void row_stats(const float (&s)[64], float c, float& m0, float& m1,
                                          float& l0, float& l1) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // c > 0: the max of the scaled logits is the scaled max; every tile holds
  // a valid key
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs0 += ex2(fmaf(s[4 * j + e], c, -mn0));
      rs1 += ex2(fmaf(s[4 * j + 2 + e], c, -mn1));
    }
  }
  l0 = l0 * ex2(m0 - mn0) + rs0;
  l1 = l1 * ex2(m1 - mn1) + rs1;
  m0 = mn0;
  m1 = mn1;
}

// Sweep 2 on one tile: the raw logits into the normalised p = exp2(s c - m)
// * r (rounded to bf16 by pack_p, where the TPU body rounds P)
__device__ __forceinline__ void probs(float (&s)[64], float c, float m0, float m1, float r0,
                                      float r1) {
#pragma unroll
  for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -m0)) * r0;
      s[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], c, -m1)) * r1;
    }
  }
}

__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBlockN / 16][4], const float (&p)[64]) {
#pragma unroll
  for (int kq = 0; kq < kBlockN / 16; ++kq) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kq][r] = pack_bf16(p[8 * kq + 2 * r], p[8 * kq + 2 * r + 1]);
  }
}

// O += P V: A (P) from registers, V [128 keys, D] MN-major; issued and
// committed, not waited for
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

// a consumer hands a stage back: one arrival per warp, after the
// warpgroup's wgmma wait (so every read of the stage is done)
__device__ __forceinline__ void release(uint32_t bar) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// One segment (L keys) of one consumer warpgroup: sweep 1 (row max and row
// sum), then sweep 2 (normalised, bf16-rounded P times V into o).  kt / vt
// count the tiles taken from the K and V rings; every address derives from
// the shared-memory base `sb`
template <int D>
__device__ __forceinline__ void segment(float (&o)[D / 2], int& kt, int& vt, uint32_t sb,
                                        uint32_t q_wg, int L, float c) {
  using S = Smem<D>;
  const uint32_t k_full = sb + S::off_bar + 8, k_empty = k_full + 8 * kKStages;
  const uint32_t v_full = k_empty + 8 * kKStages, v_empty = v_full + 8 * kVStages;
  const int n = (L + kBlockN - 1) / kBlockN, nlast = L - (n - 1) * kBlockN;
  float s[64];
  uint32_t pa[kBlockN / 16][4];

  // sweep 1: K tiles only
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n; ++j, ++kt) {
    const int st = kt % kKStages;
    mbar_wait(k_full + 8 * st, (kt / kKStages) & 1);
    issue_qk<D>(s, q_wg, sb + S::off_k + st * S::kT);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty + 8 * st);
    if (j == n - 1 && nlast < kBlockN) mask_tile(s, nlast);
    row_stats(s, c, m0, m1, l0, l1);
  }
  // the reciprocal of the clamped row sum, as the TPU body multiplies by it
  const float r0 = 1.0f / fmaxf(quad_sum(l0), 1e-30f);
  const float r1 = 1.0f / fmaxf(quad_sum(l1), 1e-30f);

  // sweep 2: S of tile j + 1 is issued before P V of tile j, and its exp2
  // runs while that product is on the tensor cores
  {
    const int st = kt % kKStages;
    mbar_wait(k_full + 8 * st, (kt / kKStages) & 1);
    issue_qk<D>(s, q_wg, sb + S::off_k + st * S::kT);
    wgmma_wait<0>();
    fence_regs(s);
    release(k_empty + 8 * st);
    ++kt;
    if (n == 1 && nlast < kBlockN) mask_tile(s, nlast);
    probs(s, c, m0, m1, r0, r1);
    pack_p(pa, s);
  }
  for (int j = 0; j + 1 < n; ++j, ++vt) {
    const int st = kt % kKStages, vs = vt % kVStages;
    mbar_wait(k_full + 8 * st, (kt / kKStages) & 1);
    issue_qk<D>(s, q_wg, sb + S::off_k + st * S::kT);
    mbar_wait(v_full + 8 * vs, (vt / kVStages) & 1);
    issue_pv<D>(o, pa, sb + S::off_v + vs * S::kT);
    wgmma_wait<1>();  // S of tile j + 1 (committed first) is done
    fence_regs(s);
    release(k_empty + 8 * st);
    ++kt;
    if (j + 2 == n && nlast < kBlockN) mask_tile(s, nlast);
    probs(s, c, m0, m1, r0, r1);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kq = 0; kq < kBlockN / 16; ++kq) fence_regs(pa[kq]);  // read until here
    release(v_empty + 8 * vs);
    pack_p(pa, s);
  }
  const int vs = vt % kVStages;
  mbar_wait(v_full + 8 * vs, (vt / kVStages) & 1);
  issue_pv<D>(o, pa, sb + S::off_v + vs * S::kT);
  wgmma_wait<0>();
  fence_regs(o);
  release(v_empty + 8 * vs);
  ++vt;
}

// tm_q: q [B, Lq, N * D] in 128-row boxes; tm_o: out in 64-row boxes;
// tm_k1 ... tm_v2: the contexts in 128-row boxes (rows past L1 / L2 read as
// zeros)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dual_context_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_o,
                    const __grid_constant__ CUtensorMap tm_k1,
                    const __grid_constant__ CUtensorMap tm_v1,
                    const __grid_constant__ CUtensorMap tm_k2,
                    const __grid_constant__ CUtensorMap tm_v2, int Lq, int L1, int L2, int N,
                    float scale_log2) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int q0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::off_bar);  // Q landed
  uint64_t* k_full = q_full + 1;          // K of stage s landed
  uint64_t* k_empty = k_full + kKStages;  // every consumer warp read it
  uint64_t* v_full = k_empty + kKStages;
  uint64_t* v_empty = v_full + kVStages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {
    // ---------------- producer warpgroup: one thread issues every load, in
    // the consumers' order: per segment its K tiles (sweep 1), then its K
    // and V tiles (sweep 2)
    SA_SETMAXNREG_DEC(24);
    if (warp == 8 && lane == 0) {
      mbar_arrive_expect_tx(q_full, S::kQ);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        tma_load_3d(sm + S::off_q + p * kBlockM * kRow, &tm_q, q_full, h * D + p * 64, q0, b);
      }
      int kt = 0, vt = 0;
      for (int seg = 0; seg < 2; ++seg) {
        const int n = ((seg ? L2 : L1) + kBlockN - 1) / kBlockN;
        const CUtensorMap* mk = seg ? &tm_k2 : &tm_k1;
        const CUtensorMap* mv = seg ? &tm_v2 : &tm_v1;
        for (int pass = 0; pass < 2; ++pass) {
          for (int t = 0; t < n; ++t) {
            const int st = kt % kKStages;
            mbar_wait(&k_empty[st], ((kt / kKStages) & 1) ^ 1);
            mbar_arrive_expect_tx(&k_full[st], S::kT);
#pragma unroll
            for (int p = 0; p < D / 64; ++p) {
              tma_load_3d(sm + S::off_k + st * S::kT + p * kBlockN * kRow, mk, &k_full[st],
                          h * D + p * 64, t * kBlockN, b);
            }
            ++kt;
            if (pass == 1) {
              const int vs = vt % kVStages;
              mbar_wait(&v_empty[vs], ((vt / kVStages) & 1) ^ 1);
              mbar_arrive_expect_tx(&v_full[vs], S::kT);
#pragma unroll
              for (int p = 0; p < D / 64; ++p) {
                tma_load_3d(sm + S::off_v + vs * S::kT + p * kBlockN * kRow, mv, &v_full[vs],
                            h * D + p * 64, t * kBlockN, b);
              }
              ++vt;
            }
          }
        }
      }
    }
  } else {
    // ---------------- two consumer warpgroups of 64 query rows each
    SA_SETMAXNREG_INC(240);
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t sb = smem_u32(sm);
    unsigned char* qb = sm + S::off_q + wg * 64 * kRow;  // this warpgroup's rows
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    int kt = 0, vt = 0;
    mbar_wait(q_full, 0);
    segment<D>(o, kt, vt, sb, smem_u32(qb), L1, scale_log2);
    segment<D>(o, kt, vt, sb, smem_u32(qb), L2, scale_log2);

    // O rounded once into this warpgroup's Q rows (its products are done;
    // the other warpgroup reads only its own), then stored by TMA
    const int r = wl * 16 + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      unsigned char* half = qb + (j >> 3) * kBlockM * kRow;
      const int chunk = ((j & 7) ^ (r & 7)) << 4;
      *reinterpret_cast<uint32_t*>(half + r * kRow + chunk + 4 * t) =
          pack_bf16(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(half + (r + 8) * kRow + chunk + 4 * t) =
          pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
    fence_proxy_async();  // the generic-proxy stores, visible to TMA
    named_bar_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0 && q0 + wg * 64 < Lq) {
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        tma_store_3d(&tm_o, qb + p * kBlockM * kRow, h * D + p * 64, q0 + wg * 64, b);
      }
      bulk_commit();
      bulk_wait_read();  // shared memory is read before the block exits
    }
  }
}

template <int D>
int launch_dual(const void* q, const void* k1, const void* v1, const void* k2, const void* v2,
                void* out, int B, int Lq, int L1, int L2, int N, float scale_log2,
                cudaStream_t st) {
  using S = Smem<D>;
  CUtensorMap mq, mo, mk1, mv1, mk2, mv2;
  const int nd = N * D;
  const bool ok = make_map(&mq, q, B, Lq, nd, kBlockM) && make_map(&mo, out, B, Lq, nd, 64) &&
                  make_map(&mk1, k1, B, L1, nd, kBlockN) && make_map(&mv1, v1, B, L1, nd, kBlockN) &&
                  make_map(&mk2, k2, B, L2, nd, kBlockN) && make_map(&mv2, v2, B, L2, nd, kBlockN);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if ((rc = allow_smem(dual_context_kernel<D>, S::launch_bytes))) return rc;
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, B * N);
  dual_context_kernel<D><<<grid, kThreads, S::launch_bytes, st>>>(mq, mo, mk1, mv1, mk2, mv2, Lq,
                                                                  L1, L2, N, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k5
}  // namespace sa

// Plain C entry point (loaded with ctypes): launches on `stream`, allocates
// nothing, returns cudaGetLastError().  q [B, Lq, N, D], k1 / v1 [B, L1, N, D],
// k2 / v2 [B, L2, N, D], out like q, all bf16 and 16-byte aligned (TMA);
// L1, L2 >= 1
extern "C" int sa_dual_context(const void* q, const void* k1, const void* v1, const void* k2,
                               const void* v2, void* out, int B, int Lq, int L1, int L2, int N,
                               int D, float scale_log2, void* stream) {
  if (L1 < 1 || L2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) {
    return sa::k5::launch_dual<128>(q, k1, v1, k2, v2, out, B, Lq, L1, L2, N, scale_log2, st);
  }
  if (D == 64) {
    return sa::k5::launch_dual<64>(q, k1, v1, k2, v2, out, B, Lq, L1, L2, N, scale_log2, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

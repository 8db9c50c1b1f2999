// Flash-attention backward for Hopper (sm_90a): K4, one fused pass that
// writes dQ, dK and dV (and, with rope.cu's `sa_rope_finalize_bwd`, its
// rope branch).
//
// They replace stableavatar_tpu/ops/flash_attention.py:_flash_bwd_impl
// (:859), whose two Pallas calls run `_bwd_dkdv_body` over the grid (B*N,
// k-blocks, q-blocks) (:905) and `_bwd_dq_body` over (B*N, q-blocks,
// k-blocks) (:941).  Inputs are the forward's q, k, v and the output gradient
// dO, all [B, L, N, D] bf16, the forward's natural-log LSE [B, N, Lq] fp32
// (K1 with `lse`) and delta = rowsum(dO * O) [B, N, Lq] fp32 (a plain torch
// op, as it was a jnp op outside Pallas).  Every kernel recomputes the
// probabilities from the LSE in the base-2 domain exactly as the TPU bodies
// do:
//
//   s  = (q . k^T) * scale * log2(e),  keys at or past k_lens[b] -> p = 0
//   p  = exp2(s - lse * log2(e)),      rows with lse <= -5e29 -> p = 0
//   dp = dO . v^T
//   ds = p * (dp - delta) * scale
//
// with P and dS rounded to bf16 before their products and dK, dV and dQ
// summed in fp32 and rounded to bf16 once.
//
// K4 (`flash_bwd_fused_kernel`, entry point sa_flash_bwd).  What bounds it
// on the H100: the five L^2 * D products per head (S, dP, dV, dK, dQ) --
// 7.1e12 flop at the DiT self-attention shape [1, 21504, 12, 128] against
// 0.3 GB of operands, so operations.  The TPU ran the two bodies one after
// the other because its grid is sequential and has no atomics, so each body
// recomputed S and dP (seven products).  Here one pass computes each product
// once:
//
// - one block owns 128 keys of one (batch, head) (blockIdx.x) and a range of
//   64-row query tiles (blockIdx.z splits the queries where the key blocks
//   alone are too few for the card's 132 SMs: the cross-attention shapes);
// - a producer warp keeps a 2-stage ring of Q and dO tiles (TMA from 3-D
//   tensor maps over [B, L, N * D], 128-byte swizzle, rows past L read as
//   zeros) and the tile's LSE / delta in shared memory, completion and
//   release on mbarriers; K and V of the block are loaded once;
// - two consumer warpgroups own 64 keys each and run wgmma: S^T = K Q^T and
//   dP^T = V dO^T from shared memory, so P^T and dS^T land in the
//   accumulator layout, which is also wgmma's register-A layout; then
//   dV += P^T dO and dK += dS^T Q take A from registers and B (dO, Q) from
//   shared memory through the transpose bit; dK and dV stay in fp32
//   registers for the whole query loop;
// - dS^T (bf16) goes to shared memory once (double-buffered), and each
//   warpgroup computes dQ for its 64 of the D columns over all 128 keys
//   (dS . K, both operands MN-major) and adds it to an fp32 buffer
//   [B, Lq, N, D] with bulk reductions (cp.reduce.async.bulk .add.f32, one
//   256-byte row per thread); the wrapper zeroes that buffer before and
//   rounds it to bf16 after.  The order of those additions changes from run
//   to run, so dQ may differ between two runs by a few fp32 ulps of its sum
//   before the bf16 rounding (at most one bf16 ulp after it); dK and dV do
//   not (split partials are summed by the wrapper in a fixed order);
// - setmaxnreg hands the producer warpgroup's registers to the consumers
//   (24 / 240 a thread).
//
// Zero fill does not mask: a zero key gives the logit 0, so keys at or past
// k_lens[b] (and Lk) still get p = 0 explicitly, and query rows past Lq get
// lse = +inf (p = 0) and are never added to dQ.  A block whose keys all lie
// past k_lens[b] writes zero dK and dV and adds nothing.
//
// K4-rope (`flash_attention(rope=)` under autograd) is this kernel on the
// forward's rotated q and k, writing fp32 dK and dV through the partial
// outputs (also with one split), then rope.cu's `sa_rope_finalize_bwd`:
// the TPU bodies inverse-rotate the fp32 dK and dQ sums (`_rot_inv` at :771
// / :837) before their one rounding, and dQ is only whole once every key
// block has added into it, so the inverse rotation follows the kernel.
#include "hopper_common.cuh"

namespace sa {

// --------------------------------------------------------------------------
// K4: the fused backward
// --------------------------------------------------------------------------

namespace fbwd {

constexpr int kBlockN = 128;   // keys per block: two consumer warpgroups of 64
constexpr int kBlockM = 64;    // query rows per tile
constexpr int kStages = 2;     // Q / dO ring
constexpr int kConsumers = 256;
constexpr int kThreads = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int kPitch = 68;     // fp32 row pitch of the dQ staging tile (64 + 4)
constexpr int kRow = 128;      // bytes of one swizzled row (64 bf16)

// shared-memory layout (byte offsets from a 1024-byte boundary); every
// swizzled operand starts on a 1024-byte boundary
template <int D>
struct Smem {
  static constexpr int kHalves = D / 64;
  static constexpr int kKV = kHalves * kBlockN * kRow;  // K or V of the block
  static constexpr int kQ = kHalves * kBlockM * kRow;   // one Q or dO stage
  static constexpr int kDS = kBlockN * kRow;            // dS^T [128 keys][64 queries]
  static constexpr int kStaging = 2 * kBlockM * kPitch * 4;
  static constexpr int off_k = 0;
  static constexpr int off_v = off_k + kKV;
  static constexpr int off_q = off_v + kKV;
  static constexpr int off_do = off_q + kStages * kQ;
  static constexpr int off_ds = off_do + kStages * kQ;
  static constexpr int off_dq = off_ds + 2 * kDS;
  static constexpr int off_lse = off_dq + kStaging;
  static constexpr int off_delta = off_lse + kStages * kBlockM * 4;
  static constexpr int off_bar = off_delta + kStages * kBlockM * 4;
  static constexpr int bytes = off_bar + (2 * kStages + 1) * 8;
  static constexpr int launch_bytes = bytes + 1024;  // room to align the base
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_fused_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                       const float* __restrict__ delta, const int* __restrict__ k_lens,
                       float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, float* __restrict__ dk_part,
                       float* __restrict__ dv_part, int B, int Lq, int Lk, int N,
                       int tiles_per_split, float scale, float scale_log2) {
  using S = Smem<D>;
  constexpr int kAcc = D / 2;  // fp32 registers of a [64, D] accumulator
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int kb0 = blockIdx.x * kBlockN;
  const int bh = blockIdx.y, b = bh / N, h = bh % N;
  const int nq = (Lq + kBlockM - 1) / kBlockM;
  const int t0 = blockIdx.z * tiles_per_split, t1 = min(nq, t0 + tiles_per_split);
  const int klen = k_lens ? min(k_lens[b], Lk) : Lk;
  const long long rs = (long long)N * D;
  const long long k_off = ((long long)b * Lk * N + h) * D;
  const bool part = dk_part != nullptr;
  const long long part_off = (long long)blockIdx.z * B * Lk * N * D;

  if (kb0 >= klen || t0 >= t1) {
    // no valid key in the block, or no query tile: zero dK and dV
    for (int i = threadIdx.x; i < kBlockN * D / 2; i += kThreads) {
      const int r = i / (D / 2), c = (i % (D / 2)) * 2;
      if (kb0 + r >= Lk) continue;
      const long long o = k_off + (long long)(kb0 + r) * rs + c;
      if (part) {
        *reinterpret_cast<float2*>(dk_part + part_off + o) = make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dv_part + part_off + o) = make_float2(0.f, 0.f);
      } else {
        *reinterpret_cast<uint32_t*>(dk + o) = 0u;
        *reinterpret_cast<uint32_t*>(dv + o) = 0u;
      }
    }
    return;
  }

  float* lse_s = reinterpret_cast<float*>(sm + S::off_lse);      // lse * log2(e), or +inf
  float* delta_s = reinterpret_cast<float*>(sm + S::off_delta);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::off_bar);  // Q, dO, lse, delta in
  uint64_t* empty = full + kStages;                               // the stage's readers done
  uint64_t* kv_full = empty + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 33);  // the TMA thread's expect_tx + the producer warp's 32 lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {
    // ---------------- producer warpgroup: one warp loads, three idle
    SA_SETMAXNREG_DEC(24);
    if (warp == 8) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * S::kKV);
#pragma unroll
        for (int hf = 0; hf < S::kHalves; ++hf) {
          tma_load_3d(sm + S::off_k + hf * kBlockN * kRow, &tm_k, kv_full, h * D + hf * 64, kb0,
                      b);
          tma_load_3d(sm + S::off_v + hf * kBlockN * kRow, &tm_v, kv_full, h * D + hf * 64, kb0,
                      b);
        }
      }
      const float* lse_bh = lse + (long long)bh * Lq;
      const float* delta_bh = delta + (long long)bh * Lq;
      for (int it = t0; it < t1; ++it) {
        const int i = it - t0, s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        const int q0 = it * kBlockM;
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * S::kQ);
#pragma unroll
          for (int hf = 0; hf < S::kHalves; ++hf) {
            tma_load_3d(sm + S::off_q + s * S::kQ + hf * kBlockM * kRow, &tm_q, &full[s],
                        h * D + hf * 64, q0, b);
            tma_load_3d(sm + S::off_do + s * S::kQ + hf * kBlockM * kRow, &tm_do, &full[s],
                        h * D + hf * 64, q0, b);
          }
        }
        for (int r = lane; r < kBlockM; r += 32) {
          const int row = q0 + r;
          const float lv = row < Lq ? lse_bh[row] : kNegInf;
          // +inf makes p = exp2(s - inf) = 0: rows past Lq and the TPU
          // body's lse > NEG_INF / 2 guard
          lse_s[s * kBlockM + r] = lv > kNegInf * 0.5f ? lv * kLog2e : __int_as_float(0x7f800000);
          delta_s[s * kBlockM + r] = row < Lq ? delta_bh[row] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---------------- two consumer warpgroups of 64 keys each
    SA_SETMAXNREG_INC(240);
    const int wg = warp >> 2, wl = warp & 3;
    const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
    const int key_a = kb0 + wg * 64 + wl * 16 + g, key_b = key_a + 8;
    const bool ok_a = key_a < klen, ok_b = key_b < klen;
    const bool do_dq = wg * 64 < D;  // D = 64: the first warpgroup takes all of dQ

    const uint32_t k_wg = smem_u32(sm + S::off_k) + wg * 64 * kRow;  // this warpgroup's keys
    const uint32_t v_wg = smem_u32(sm + S::off_v) + wg * 64 * kRow;
    const uint32_t k_dq = smem_u32(sm + S::off_k) + wg * kBlockN * kRow;  // D columns of dQ
    float* staging = reinterpret_cast<float*>(sm + S::off_dq) + wg * kBlockM * kPitch;

    float dk_acc[kAcc], dv_acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = t0; it < t1; ++it) {
      const int i = it - t0, s = i % kStages;
      const int q0 = it * kBlockM;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t qb = smem_u32(sm + S::off_q + s * S::kQ);
      const uint32_t dob = smem_u32(sm + S::off_do + s * S::kQ);
      const float* l2 = lse_s + s * kBlockM;
      const float* dl = delta_s + s * kBlockM;

      // S^T = K Q^T and dP^T = V dO^T [64 keys, 64 queries], K-major operands
      float sacc[32], dpacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * kBlockN * kRow + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * kBlockM * kRow + (kk & 3) * 32;
        wgmma_ss_n64<0, 0>(sacc, make_desc(k_wg + ko, 16, 1024), make_desc(qb + qo, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ko = (kk >> 2) * kBlockN * kRow + (kk & 3) * 32;
        const uint32_t qo = (kk >> 2) * kBlockM * kRow + (kk & 3) * 32;
        wgmma_ss_n64<0, 0>(dpacc, make_desc(v_wg + ko, 16, 1024), make_desc(dob + qo, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();

      // P^T while dP^T runs; element 4j + e: key row g (e < 2) or g + 8,
      // query column 8j + 2t + (e & 1)
      wgmma_wait<1>();
      fence_regs(sacc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = l2[8 * j + 2 * t + (e & 1)];
          const bool ok = e < 2 ? ok_a : ok_b;
          sacc[4 * j + e] = ok ? exp2f(sacc[4 * j + e] * scale_log2 - lv) : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dpacc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dd = dl[8 * j + 2 * t + (e & 1)];
          dpacc[4 * j + e] = sacc[4 * j + e] * (dpacc[4 * j + e] - dd) * scale;
        }
      }
      // bf16 A fragments of the k16 steps over the 64 queries
      uint32_t pa[4][4], dsa[4][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kq][r] = pack_bf16(sacc[8 * kq + 2 * r], sacc[8 * kq + 2 * r + 1]);
          dsa[kq][r] = pack_bf16(dpacc[8 * kq + 2 * r], dpacc[8 * kq + 2 * r + 1]);
        }
      }
      // dS^T to shared memory (128-byte swizzle) for dQ; buffer i % 2
      unsigned char* dsb = sm + S::off_ds + (i & 1) * S::kDS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wg * 64 + wl * 16 + g + 8 * hr;
          *reinterpret_cast<uint32_t*>(dsb + r * kRow + ((j ^ (r & 7)) << 4) + 4 * t) =
              dsa[j >> 1][(j & 1) * 2 + hr];
        }
      }
      fence_proxy_async();

      // dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        wgmma_rs_d<D>(dv_acc, pa[kq], make_desc(dob + kq * 16 * kRow, kBlockM * kRow, 1024));
      }
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        wgmma_rs_d<D>(dk_acc, dsa[kq], make_desc(qb + kq * 16 * kRow, kBlockM * kRow, 1024));
      }
      wgmma_commit();

      named_bar_sync(1, kConsumers);  // both warpgroups' dS^T are in shared memory
      float dq[32];
      if (do_dq) {
        // dQ[64 queries, 64 columns] = dS . K over the block's 128 keys
        const uint32_t dsa_addr = smem_u32(dsb);
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_ss_n64<1, 1>(dq, make_desc(dsa_addr + kk * 16 * kRow, kBlockN * kRow, 1024),
                             make_desc(k_dq + kk * 16 * kRow, kBlockN * kRow, 1024), kk > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);  // Q, dO, lse and delta of stage s are read

      if (do_dq) {
        fence_regs(dq);
        if (tid < kBlockM) bulk_wait_read();  // last tile's reduction has left the staging
        named_bar_sync(2 + wg, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = wl * 16 + g + 8 * hr;
            *reinterpret_cast<float2*>(staging + r * kPitch + 8 * j + 2 * t) =
                make_float2(dq[4 * j + 2 * hr], dq[4 * j + 2 * hr + 1]);
          }
        }
        fence_proxy_async();
        named_bar_sync(2 + wg, 128);
        if (tid < kBlockM && q0 + tid < Lq) {
          bulk_reduce_add_f32(dq_acc + ((long long)(b * Lq + q0 + tid) * N + h) * D + wg * 64,
                              staging + tid * kPitch, 64 * 4);
          bulk_commit();
        }
      }
    }
    if (do_dq && tid < kBlockM) bulk_wait();

    // dK, dV: element 4j + e of key row g (e < 2) or g + 8, column 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int key = hr ? key_b : key_a;
        if (key >= Lk) continue;
        const long long o = k_off + (long long)key * rs + 8 * j + 2 * t;
        const int e = 4 * j + 2 * hr;
        if (part) {
          *reinterpret_cast<float2*>(dk_part + part_off + o) =
              make_float2(dk_acc[e], dk_acc[e + 1]);
          *reinterpret_cast<float2*>(dv_part + part_off + o) =
              make_float2(dv_acc[e], dv_acc[e + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dk_acc[e], dk_acc[e + 1]);
          *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[e], dv_acc[e + 1]);
        }
      }
    }
  }
}

}  // namespace fbwd

}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns the first CUDA error (0 on success).  k_lens
// may be NULL (every key valid); lse and delta are [B, N, Lq] fp32.
// --------------------------------------------------------------------------

namespace {

template <int D>
int launch_fused(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* k_lens, void* dq_acc, void* dk, void* dv,
                 void* dk_part, void* dv_part, int B, int Lq, int Lk, int N, int splits,
                 float scale, float scale_log2, cudaStream_t st) {
  using namespace sa::fbwd;
  CUtensorMap mq, mk, mv, mdo;
  if (!sa::make_map(&mq, q, B, Lq, N * D, kBlockM) ||
      !sa::make_map(&mk, k, B, Lk, N * D, kBlockN) ||
      !sa::make_map(&mv, v, B, Lk, N * D, kBlockN) ||
      !sa::make_map(&mdo, dout, B, Lq, N * D, kBlockM))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<D>::launch_bytes;
  int rc;
  if ((rc = sa::allow_smem(flash_bwd_fused_kernel<D>, smem))) return rc;
  const int nq = (Lq + kBlockM - 1) / kBlockM;
  const int per_split = (nq + splits - 1) / splits;
  const dim3 grid((Lk + kBlockN - 1) / kBlockN, B * N, splits);
  flash_bwd_fused_kernel<D><<<grid, kThreads, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(k_lens), static_cast<float*>(dq_acc),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<float*>(dk_part), static_cast<float*>(dv_part), B, Lq, Lk, N, per_split,
      scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: dQ added into dq_acc [B, Lq, N, D] fp32 (zeroed by the caller); the
// query tiles are split `splits` ways, and each split writes its fp32
// partials to dk_part, dv_part [splits, B, Lk, N, D] (the caller sums
// them), or with one split and null partials dK and dV go to dk, dv
// [B, Lk, N, D] bf16.  Global rows must be 16-byte multiples (N * D * 2).
extern "C" int sa_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* k_lens, void* dq_acc,
                            void* dk, void* dv, void* dk_part, void* dv_part, int B, int Lq,
                            int Lk, int N, int D, int splits, float scale, float scale_log2,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (dk_part == nullptr) != (dv_part == nullptr) ||
      (splits > 1 && dk_part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128)
    return launch_fused<128>(q, k, v, dout, lse, delta, k_lens, dq_acc, dk, dv, dk_part, dv_part,
                             B, Lq, Lk, N, splits, scale, scale_log2, st);
  if (D == 64)
    return launch_fused<64>(q, k, v, dout, lse, delta, k_lens, dq_acc, dk, dv, dk_part, dv_part,
                            B, Lq, Lk, N, splits, scale, scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

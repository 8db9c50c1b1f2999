// Hopper probes (sm_90a): the GEMM of S1-S2 (the flash-grid dots of S3 are
// instances of flash_attention.cu's forward template).
//
// mm_probe replaces the Pallas GEMMs of scripts/microbench_pallas_int8.py:
// mm_pallas (:19) and scripts/microbench_pallas_int8_variants.py:build (:27)
// with its bodies k_requant (:55), k_scaled (:64) and k_bf16 (:72):
// out [M, N] = a [M, K] . b [K, N], both row-major as the JAX scripts lay
// them out, with one of four epilogues, bit for bit the JAX bodies':
//   kBf16    bf16 in, fp32 sums, bf16 out              (mm_pallas(bf16), k_bf16)
//   kWrap    int8 in, int32 sums, int8 out by a truncating cast (mm_pallas(int8):
//            `.astype(int8)` wraps, it does not saturate)
//   kRequant clip(acc >> 8, -127, 127), arithmetic shift    (k_requant)
//   kScaled  bf16(float(acc) * 0.0039f)                     (k_scaled)
// What bounds it on the H100: at the scripts' [21504, 1536] . [1536, 1536]
// the 1.0e11 operations take 0.103 ms at the dense bf16 peak (0.051 ms
// int8) against 0.14 GB of operands (0.041 ms): compute-bound.  The first
// design (8 warps of warp-level m16n8k16 products, two cp.async stages,
// three block barriers a stage) ran at a fifth of the bf16 peak.  This one
// is Hopper's own (`mm_probe_kernel`):
//
// - a block owns a 128 x 128 output tile: two consumer warpgroups of 64 rows
//   run wgmma m64n128 (bf16 k16 steps into fp32, or s8 k32 steps into s32)
//   on stages of 128 bytes of K a row (64 bf16, 128 int8), with the sums in
//   registers for the whole K loop; one producer thread keeps a 4-stage TMA
//   ring of A and B tiles in flight on mbarriers (2-D tensor maps, 128-byte
//   swizzle, parts past M, N or K read as zeros);
// - A [M, K] is K-major as wgmma wants it.  bf16 B [K, N] is MN-major: two
//   [64 k, 64 n] boxes a stage and the descriptor's transpose bit, as K1
//   reads V.  8-bit operands have no transpose bit, so int8 B must reach the
//   tensor cores as [n, k]: TMA lands the raw [128 k, 128 n] tile unswizzled
//   beside the stage, and the producer warpgroup's three idle warps turn it
//   into the swizzled [128 n, 128 k] operand (4 x 4 bytes a thread with
//   __byte_perm; lane l takes n-word l and k-block (l / 2) ^ c, so that its
//   loads and its stores hit 32 distinct banks) while the consumers run
//   earlier stages, then signal the stage's `full` mbarrier.  Cost: 16 KB
//   read and 16 KB written in shared memory per 16 KB stage (beside the
//   consumers' 48 KB of operand reads), 48 KB of ring a stage (192 KB);
// - the epilogue works in registers on the accumulator layout (int8
//   outputs exact, bf16 rounded once), stages the tile in shared memory and
//   writes it out in coalesced 16-byte stores.
//
// dots_probe (S3) replaces scripts/bench_attn_blocks.py:dots_only (:61) and
// int8_dots_only (:119): the flash grid with no softmax, out [BH, L, D] =
// sum over all keys of bf16(q . k^T) . v (bf16 q, k) or of
// bf16(int32(q8 . k8^T) >> 7) . v (int8 q8, k8), fp32 sums, bf16 out; v is
// bf16.  It is two instances of the wgmma forward template
// (flash_attention.cu: `ffwd::flash_fwd_kernel<D, kQkBf16Dots / kQkInt8Dots,
// kVBf16>`, entry `sa_dots_probe` there), so that it measures what K1 and K2
// issue without their softmax.  Bound: 4 L^2 D operations per (batch,
// head), compute-bound like K1 / K2.
#include <type_traits>

#include "hopper_common.cuh"

namespace sa {
namespace probe {

constexpr int kBM = 128, kBN = 128;  // output tile: two consumer warpgroups of 64 rows
constexpr int kBKB = 128;            // K bytes per stage and row (64 bf16, 128 int8)
constexpr int kStagesMM = 4;
constexpr int kConsumersMM = 256;
constexpr int kTransposers = 96;     // the producer warpgroup's warps 1-3 (int8)
constexpr int kThreadsMM = 384;      // two consumer warpgroups, one producer warpgroup
constexpr int kTile = kBM * kBKB;    // 16 KB: an A, B or raw int8 B stage

enum Epilogue { kBf16 = 0, kWrap = 1, kRequant = 2, kScaled = 3 };

// shared-memory layout (byte offsets from a 1024-byte boundary): the A and B
// rings, int8's raw B ring, the mbarriers
template <bool INT8>
struct MMSmem {
  static constexpr int off_a = 0;
  static constexpr int off_b = off_a + kStagesMM * kTile;
  static constexpr int off_raw = off_b + kStagesMM * kTile;
  static constexpr int off_bar = off_raw + (INT8 ? kStagesMM * kTile : 0);
  static constexpr int bytes = off_bar + 3 * kStagesMM * 8;
  static constexpr int launch_bytes = bytes + 1024;  // room to align the base
};

// raw int8 B [128 k][128 n] (unswizzled) -> the swizzled K-major operand
// [128 n][128 k]: 16-byte chunk c of row n at chunk c ^ (n % 8).  Warp `tw`
// (0-2) of the transposers takes the k-block sweeps c = tw, tw + 3, ...;
// lane l turns the 4 x 4 bytes of n-word l and k-block (l / 2) ^ c around
// in registers (loads: one row, 32 words; stores: (l % 2, k-block) give 32
// distinct banks under the swizzle)
__device__ __forceinline__ void transpose_stage(unsigned char* bt, const unsigned char* raw,
                                                int tw) {
  const int lane = threadIdx.x & 31;
  for (int c = tw; c < 32; c += 3) {
    const int kb = (lane >> 1) ^ c;
    const unsigned char* src = raw + kb * 4 * kBN + lane * 4;
    const uint32_t w0 = ld32(src), w1 = ld32(src + kBN);
    const uint32_t w2 = ld32(src + 2 * kBN), w3 = ld32(src + 3 * kBN);
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = lane * 4 + j;
      const int off = n * kBKB + ((((kb >> 2) ^ (n & 7)) << 4) | ((kb & 3) << 2));
      *reinterpret_cast<uint32_t*>(bt + off) = col[j];
    }
  }
}

// two neighbouring outputs (x at column c, y at c + 1) of one row
template <int EPI, typename Acc>
__device__ __forceinline__ void store_pair(void* out, long long idx, Acc x, Acc y) {
  if constexpr (EPI == kBf16) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) = pack_bf16(x, y);
  } else if constexpr (EPI == kScaled) {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + idx) =
        pack_bf16(__fmul_rn(__int2float_rn(x), 0.0039f), __fmul_rn(__int2float_rn(y), 0.0039f));
  } else {
    int a = x, b = y;
    if constexpr (EPI == kRequant) {
      a = min(max(a >> 8, -127), 127);
      b = min(max(b >> 8, -127), 127);
    }
    // the low byte of each: a truncating cast, as XLA's s32 -> s8 convert
    *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + idx) =
        static_cast<uint16_t>((uint32_t(a) & 0xffu) | ((uint32_t(b) & 0xffu) << 8));
  }
}

// a [M, K] (K-major) and b [K, N] through the tensor maps tm_a, tm_b (raw
// [128 k, 128 n] boxes for int8, [64 k, 64 n] swizzled ones for bf16)
template <int EPI>
__global__ void __launch_bounds__(kThreadsMM, 1)
mm_probe_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                void* __restrict__ out, int M, int N, int K) {
  constexpr bool kInt8 = EPI != kBf16;
  constexpr int ES = kInt8 ? 1 : 2;  // bytes of an input element
  using S = MMSmem<kInt8>;
  using Acc = std::conditional_t<kInt8, int, float>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K * ES + kBKB - 1) / kBKB;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::off_bar);  // A and B of stage s ready
  uint64_t* empty = full + kStagesMM;     // both consumer warpgroups are done with stage s
  uint64_t* raw_full = empty + kStagesMM;  // int8: the raw B tile of stage s landed
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesMM; ++s) {
      mbar_init(&full[s], 1 + (kInt8 ? kTransposers : 0));
      mbar_init(&empty[s], kConsumersMM);
      mbar_init(&raw_full[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 8) {
    if (warp == 8) {
      // ---------------- one thread issues every load
      if (lane == 0) {
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % kStagesMM;
          mbar_wait(&empty[s], ((kt / kStagesMM) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kInt8 ? kTile : 2 * kTile);
          tma_load_2d(sm + S::off_a + s * kTile, &tm_a, &full[s], kt * (kBKB / ES), m0);
          if constexpr (kInt8) {
            mbar_arrive_expect_tx(&raw_full[s], kTile);
            tma_load_2d(sm + S::off_raw + s * kTile, &tm_b, &raw_full[s], n0, kt * kBKB);
          } else {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              tma_load_2d(sm + S::off_b + s * kTile + c * (kTile / 2), &tm_b, &full[s],
                          n0 + 64 * c, kt * 64);
            }
          }
        }
      }
    } else if constexpr (kInt8) {
      // ---------------- warps 9-11 turn each raw int8 B tile into the operand
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStagesMM;
        mbar_wait(&raw_full[s], (kt / kStagesMM) & 1);
        transpose_stage(sm + S::off_b + s * kTile, sm + S::off_raw + s * kTile, warp - 9);
        fence_proxy_async();  // the generic-proxy stores, visible to wgmma
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---------------- two consumer warpgroups of 64 rows each
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStagesMM;
    mbar_wait(&full[s], (kt / kStagesMM) & 1);
    const uint32_t a_wg = smem_u32(sm + S::off_a + s * kTile) + wg * 64 * kBKB;
    const uint32_t bs = smem_u32(sm + S::off_b + s * kTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = make_desc(a_wg + kk * 32, 16, 1024);
      if constexpr (kInt8) {
        wgmma_s8_n128(acc, da, make_desc(bs + kk * 32, 16, 1024), 1);
      } else {
        // B MN-major: two 64-column chunks 8 KB apart, k16 steps of 2 KB
        wgmma_ss_n128<0, 1>(acc, da, make_desc(bs + kk * 16 * kBKB, kTile / 2, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % kStagesMM]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: the tile through shared memory (the ring is free once both
  // warpgroups are past their last product), then 16-byte stores
  named_bar_sync(1, kConsumersMM);
  constexpr int OES = (EPI == kBf16 || EPI == kScaled) ? 2 : 1;  // bytes of an output
  constexpr int kPitchO = kBN * OES + 16;
  unsigned char* st = sm + wg * 64 * kPitchO;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * t, r = wl * 16 + g;
    store_pair<EPI>(st + r * kPitchO, c, acc[4 * j], acc[4 * j + 1]);
    store_pair<EPI>(st + (r + 8) * kPitchO, c, acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_bar_sync(2 + wg, 128);
  constexpr int kChunks = kBN * OES / 16;  // 16-byte chunks of a row
  for (int i = threadIdx.x & 127; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks;
    const int row = m0 + wg * 64 + r, col = n0 + ch * (16 / OES);
    // N % 16 == 0: a chunk is wholly in or out
    if (row < M && col < N) {
      *reinterpret_cast<uint4*>(static_cast<char*>(out) + ((long long)row * N + col) * OES) =
          *reinterpret_cast<const uint4*>(st + r * kPitchO + ch * 16);
    }
  }
}

}  // namespace probe

}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns cudaGetLastError().
// --------------------------------------------------------------------------

// out [M, N] = a [M, K] . b [K, N] (row-major, contiguous) with `epilogue`
// 0 bf16 (bf16 a, b, out), 1 int8 wrap, 2 requant (int8 out), 3 scaled
// (bf16 out; int8 a, b); needs K % 64 == 0 and N % 16 == 0
extern "C" int sa_mm_probe(const void* a, const void* b, void* out, int M, int N, int K,
                           int epilogue, void* stream) {
  namespace p = sa::probe;
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 64 || epilogue < 0 || epilogue > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool int8 = epilogue != p::kBf16;
  const int es = int8 ? 1 : 2;
  CUtensorMap ma, mb;
  const bool ok =
      sa::make_map_2d(&ma, a, M, K, es, p::kBM, p::kBKB / es, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (int8 ? sa::make_map_2d(&mb, b, K, N, 1, p::kBKB, p::kBN, CU_TENSOR_MAP_SWIZZLE_NONE)
            : sa::make_map_2d(&mb, b, K, N, 2, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + p::kBN - 1) / p::kBN, (M + p::kBM - 1) / p::kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, int smem) {
    int rc;
    if ((rc = sa::allow_smem(kernel, smem))) return rc;
    kernel<<<grid, p::kThreadsMM, smem, st>>>(ma, mb, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
  };
  constexpr int s16 = p::MMSmem<false>::launch_bytes, s8 = p::MMSmem<true>::launch_bytes;
  switch (epilogue) {
    case p::kBf16:
      return run(p::mm_probe_kernel<p::kBf16>, s16);
    case p::kWrap:
      return run(p::mm_probe_kernel<p::kWrap>, s8);
    case p::kRequant:
      return run(p::mm_probe_kernel<p::kRequant>, s8);
    default:
      return run(p::mm_probe_kernel<p::kScaled>, s8);
  }
}

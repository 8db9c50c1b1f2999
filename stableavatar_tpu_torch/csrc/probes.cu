// Hopper probes (sm_90a): the GEMM of S1-S2 and the flash-grid dots of S3.
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
// int8) against 0.14 GB of operands (0.041 ms): compute-bound.  Design: a
// 128 x 128 output tile per block of 8 warps (2 x 4 warps of 64 x 32),
// mma.sync (bf16 m16n8k16 into fp32, s8 m16n8k32 into s32), K in steps of
// 64 bytes a row staged by cp.async in two stages.  mma.sync wants B
// K-major: the bf16 B fragments come from the row-major [K, N] tile
// through ldmatrix.trans; 8-bit elements have no ldmatrix.trans, so the
// int8 tile is transposed in shared memory first, 4 x 4 bytes a step with
// __byte_perm.  wgmma and TMA are later work.
//
// dots_probe replaces scripts/bench_attn_blocks.py:dots_only (:61) and
// int8_dots_only (:119): the flash grid with no softmax, out [BH, L, D] =
// sum over all keys of bf16(q . k^T) . v (bf16 q, k) or of
// bf16(int32(q8 . k8^T) >> 7) . v (int8 q8, k8), fp32 sums, bf16 out; v is
// bf16.  k8 is read row-major [L, D] (the TPU's [D, L] pre-transpose is a
// layout of its matrix unit).  It is its own kernel on attention_common.cuh's
// tiles and fragments (K1's first design: 64 query rows, 64-key tiles), so the
// int8 flash template and its register budget stay as they are.  Bound:
// 4 L^2 D operations per (batch, head), compute-bound like K1 / K2.
#include <type_traits>

#include "attention_common.cuh"

namespace sa {
namespace probe {

constexpr int kBM = 128, kBN = 128;  // output tile
constexpr int kBKB = 64;             // K bytes per stage and row (32 bf16, 64 int8)
constexpr int kWarps = 8, kThreadsMM = kWarps * 32;
constexpr int kAPitch = kBKB + 16;     // bytes of an A row in shared memory
constexpr int kBPitch16 = kBN + 8;     // elements of a bf16 B row
constexpr int kBRawPitch = kBN + 16;   // bytes of an int8 B row as loaded
constexpr int kBtPitch = kBKB + 4;     // bytes of a transposed int8 B row (17 words)

enum Epilogue { kBf16 = 0, kWrap = 1, kRequant = 2, kScaled = 3 };

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A rows [m0, m0 + 128), bytes [kb0, kb0 + 64) of each (rows >= M zero-filled)
__device__ __forceinline__ void load_a(char* As, const char* a, int M, int row_bytes, int m0,
                                       int kb0) {
  for (int c = threadIdx.x; c < kBM * 4; c += kThreadsMM) {
    const int r = c >> 2, x = (c & 3) * 16;
    const bool ok = m0 + r < M;
    const char* src = a + (ok ? (long long)(m0 + r) * row_bytes : 0) + kb0 + x;
    cp_async16(As + r * kAPitch + x, src, ok);
  }
}

// B rows [k0, k0 + 64 / ES), columns [n0, n0 + 128) (columns >= N
// zero-filled; N % 16 == 0, so a 16-byte chunk is wholly in or out)
template <int ES>
__device__ __forceinline__ void load_b(char* Bs, const char* b, int N, int k0, int n0,
                                       int pitch) {
  constexpr int kRows = kBKB / ES, kChunks = kBN * ES / 16;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreadsMM) {
    const int r = c / kChunks, x = (c % kChunks) * 16;
    const bool ok = n0 * ES + x < N * ES;
    const char* src = b + (long long)(k0 + r) * N * ES + (ok ? n0 * ES + x : 0);
    cp_async16(Bs + r * pitch + x, src, ok);
  }
}

// raw int8 B [64 k][128 n] -> Bt [128 n][64 k]: each thread turns 4 x 4
// bytes around in registers; a warp takes 4 k-blocks x 8 n-blocks, which
// keeps the transposed stores free of bank conflicts (17-word rows)
__device__ __forceinline__ void transpose_b(char* Bt, const char* raw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = warp + i * kWarps;
    const int kb = (blk >> 2) * 4 + (lane >> 3), nb = (blk & 3) * 8 + (lane & 7);
    const char* src = raw + kb * 4 * kBRawPitch + nb * 4;
    const uint32_t w0 = ld32(src), w1 = ld32(src + kBRawPitch);
    const uint32_t w2 = ld32(src + 2 * kBRawPitch), w3 = ld32(src + 3 * kBRawPitch);
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    char* dst = Bt + nb * 4 * kBtPitch + kb * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kBtPitch) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kBtPitch) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kBtPitch) = __byte_perm(t1, t3, 0x7632);
  }
}

// this warp's 64 x 32 of the tile over one stage: two k16 steps (bf16)
__device__ __forceinline__ void mma_stage_bf16(float (&acc)[4][4][4], const char* As,
                                               const char* Bs, int wm, int wn) {
  constexpr int kAP = kAPitch / 2;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned short* A = reinterpret_cast<const unsigned short*>(As);
  const unsigned short* B = reinterpret_cast<const unsigned short*>(Bs);
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const unsigned short* ar = A + (wm * 64 + mt * 16 + g) * kAP + ks * 16 + t * 2;
      af[mt][0] = ld32(ar);
      af[mt][1] = ld32(ar + 8 * kAP);
      af[mt][2] = ld32(ar + 8);
      af[mt][3] = ld32(ar + 8 * kAP + 8);
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      // lanes 0-15 address k rows 0-15 of n-tile 2 np, lanes 16-31 of 2 np + 1
      uint32_t r[4];
      ldmatrix_x4_trans(r, B + (ks * 16 + (lane & 15)) * kBPitch16 + wn * 32 + np * 16 +
                               (lane >> 4) * 8);
      bf[2 * np][0] = r[0];
      bf[2 * np][1] = r[1];
      bf[2 * np + 1][0] = r[2];
      bf[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
}

// the same for int8: two k32 steps, B from the transposed tile
__device__ __forceinline__ void mma_stage_s8(int (&acc)[4][4][4], const char* As,
                                             const char* Bt, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const char* ar = As + (wm * 64 + mt * 16 + g) * kAPitch + ks * 32 + t * 4;
      af[mt][0] = ld32(ar);
      af[mt][1] = ld32(ar + 8 * kAPitch);
      af[mt][2] = ld32(ar + 16);
      af[mt][3] = ld32(ar + 8 * kAPitch + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const char* br = Bt + (wn * 32 + nt * 8 + g) * kBtPitch + ks * 32 + t * 4;
      bf[nt][0] = ld32(br);
      bf[nt][1] = ld32(br + 16);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8_16832(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
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

template <int EPI>
__global__ void __launch_bounds__(kThreadsMM)
mm_probe_kernel(const void* __restrict__ a, const void* __restrict__ b, void* __restrict__ out,
                int M, int N, int K) {
  constexpr bool kInt8 = EPI != kBf16;
  constexpr int ES = kInt8 ? 1 : 2;  // bytes of an input element
  constexpr int kBPitch = kInt8 ? kBRawPitch : kBPitch16 * 2;
  constexpr int kBRows = kBKB / ES;
  using Acc = std::conditional_t<kInt8, int, float>;
  __shared__ __align__(16) char As[2][kBM * kAPitch];
  __shared__ __align__(16) char Bs[2][kBRows * kBPitch];
  __shared__ __align__(16) char Bt[kInt8 ? kBN * kBtPitch : 16];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const char* ab = static_cast<const char*>(a);
  const char* bb = static_cast<const char*>(b);
  const int nk = K * ES / kBKB;

  Acc acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    }
  }

  load_a(As[0], ab, M, K * ES, m0, 0);
  load_b<ES>(Bs[0], bb, N, 0, n0, kBPitch);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {  // the next stage is in flight during this one
      load_a(As[st ^ 1], ab, M, K * ES, m0, (kt + 1) * kBKB);
      load_b<ES>(Bs[st ^ 1], bb, N, (kt + 1) * kBRows, n0, kBPitch);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kInt8) {
      transpose_b(Bt, Bs[st]);
      __syncthreads();
      mma_stage_s8(acc, As[st], Bt, wm, wn);
    } else {
      mma_stage_bf16(acc, As[st], Bs[st], wm, wn);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm * 64 + mt * 16 + g;
      const int col = n0 + wn * 32 + nt * 8 + t * 2;
      if (col >= N) continue;
      if (row < M) store_pair<EPI>(out, (long long)row * N + col, acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < M)
        store_pair<EPI>(out, (long long)(row + 8) * N + col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

}  // namespace probe

// S[16, 64] = float(int32(Q8 . K8_tile^T) >> 7) on the s8 tensor cores
// (the shifted integers are below 2^24, exact in fp32)
template <int D>
__device__ __forceinline__ void qk_s8_shift7(float (&s)[kNT][4], const uint32_t (&qa)[D / 32][4],
                                             const int8_t* Ks) {
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
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = static_cast<float>(si[nt][e] >> 7);
  }
}

// One block: 64 query rows of one (batch, head) against all L keys in
// 64-key tiles; P = bf16(S) is packed into A fragments by pv_bf16 and never
// leaves registers.  Ragged L needs no mask: zero-filled K rows give S = 0
// and zero-filled V rows add nothing.
template <int D, bool INT8>
__global__ void __launch_bounds__(kThreads)
dots_probe_kernel(const void* __restrict__ q, const void* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int L) {
  constexpr int kKRow = INT8 ? D : 2 * D;  // bytes of one K row
  __shared__ __align__(16) char Ks[kBlockK * (kKRow + 16)];
  __shared__ __align__(16) unsigned short Vs[kBlockK * (D + 8)];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_a = blockIdx.x * kBlockQ + warp * 16 + g, row_b = row_a + 8;
  const long long off = (long long)bh * L * D;

  uint32_t qa[INT8 ? D / 32 : D / 16][4];
  if constexpr (INT8) {
    const int8_t* qb = static_cast<const int8_t*>(q) + off;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      const int c = kk * 32 + t * 4;
      qa[kk][0] = row_a < L ? ld32(qb + (long long)row_a * D + c) : 0u;
      qa[kk][1] = row_b < L ? ld32(qb + (long long)row_b * D + c) : 0u;
      qa[kk][2] = row_a < L ? ld32(qb + (long long)row_a * D + c + 16) : 0u;
      qa[kk][3] = row_b < L ? ld32(qb + (long long)row_b * D + c + 16) : 0u;
    }
  } else {
    load_q_bf16<D>(qa, static_cast<const __nv_bfloat16*>(q) + off, D, row_a, L);
  }
  const char* kb = static_cast<const char*>(k) + off * (kKRow / D);
  const char* vb = reinterpret_cast<const char*>(v + off);

  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int ntiles = (L + kBlockK - 1) / kBlockK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK;
    load_tile<kKRow>(Ks, kb, kKRow, k0, L);
    cp_async_commit();
    load_tile<D * 2>(reinterpret_cast<char*>(Vs), vb, D * 2, k0, L);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[kNT][4];
    if constexpr (INT8) {
      qk_s8_shift7<D>(s, qa, reinterpret_cast<const int8_t*>(Ks));
    } else {
      qk_bf16<D>(s, qa, reinterpret_cast<const unsigned short*>(Ks));
    }

    cp_async_wait<0>();
    __syncthreads();
    pv_bf16<D>(acc, s, Vs);
    __syncthreads();
  }
  store_rows<D>(out + off, D, row_a, L, acc);
}

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
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + p::kBN - 1) / p::kBN, (M + p::kBM - 1) / p::kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case p::kBf16:
      p::mm_probe_kernel<p::kBf16><<<grid, p::kThreadsMM, 0, st>>>(a, b, out, M, N, K);
      break;
    case p::kWrap:
      p::mm_probe_kernel<p::kWrap><<<grid, p::kThreadsMM, 0, st>>>(a, b, out, M, N, K);
      break;
    case p::kRequant:
      p::mm_probe_kernel<p::kRequant><<<grid, p::kThreadsMM, 0, st>>>(a, b, out, M, N, K);
      break;
    case p::kScaled:
      p::mm_probe_kernel<p::kScaled><<<grid, p::kThreadsMM, 0, st>>>(a, b, out, M, N, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [BH, L, D] bf16 from q, k [BH, L, D] (bf16, or int8 with int8 != 0)
// and v [BH, L, D] bf16; D is 64 or 128
extern "C" int sa_dots_probe(const void* q, const void* k, const void* v, void* out, int BH,
                             int L, int D, int int8, void* stream) {
  const dim3 grid((L + sa::kBlockQ - 1) / sa::kBlockQ, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto v_ = static_cast<const __nv_bfloat16*>(v);
  auto o_ = static_cast<__nv_bfloat16*>(out);
  if (D == 128 && int8) {
    sa::dots_probe_kernel<128, true><<<grid, sa::kThreads, 0, st>>>(q, k, v_, o_, L);
  } else if (D == 128) {
    sa::dots_probe_kernel<128, false><<<grid, sa::kThreads, 0, st>>>(q, k, v_, o_, L);
  } else if (D == 64 && int8) {
    sa::dots_probe_kernel<64, true><<<grid, sa::kThreads, 0, st>>>(q, k, v_, o_, L);
  } else if (D == 64) {
    sa::dots_probe_kernel<64, false><<<grid, sa::kThreads, 0, st>>>(q, k, v_, o_, L);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

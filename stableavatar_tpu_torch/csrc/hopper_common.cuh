// Hopper (sm_90a) building blocks for the hand-written kernels: shared-memory
// addresses, mbarriers, TMA tensor loads and stores and bulk reductions,
// wgmma descriptors and products (bf16 into fp32, s8 into s32, A from shared
// memory or registers), named barriers and register hand-over (setmaxnreg),
// and the host side: TMA tensor maps (bf16 and int8, 3-D over [B, L, N * D]
// and 2-D over matrices) and the dynamic shared-memory opt-in; also the
// softmax constants and the packing helpers the kernels share.  Used by
// flash_attention.cu (K1, K1-LSE, K2, K2v, K2-LSE, K3, the S3 dots),
// flash_attention_bwd.cu (the fused K4), cross_attention.cu (K5) and
// probes.cu (mm_probe).
//
// Softmax runs in the base-2 domain like the TPU kernels: log2(e) is folded
// into the logit scale by the caller and exp2 replaces exp.  Masked logits
// are -1e30 (the TPU kernels' NEG_INF) and the final divide guards the row
// sum with max(l, 1e-30).
//
// Shared-memory operands are stored in the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes: a tile of R rows x 128 bytes (64 bf16
// or 128 int8) whose 16-byte chunk c of row r lies at chunk c ^ (r % 8), the
// tile based on a 1024-byte boundary.  A D-wide bf16 operand is D / 64 such
// tiles ("halves" for D = 128) one after the other.  int8 rows of 64 bytes
// (D = 64) take the 64-byte swizzle: chunk c of row r at c ^ ((r / 2) % 4),
// 8 rows in 512 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sa {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> packed bf16x2, low half = first element (fragment order)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the sum over the four threads of a quad (a row's partial sums in the
// accumulator layout)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// --------------------------------------------------------------------------
// mbarriers
// --------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive(smem_u32(bar)); }

// one arrival that also announces `bytes` of asynchronous (TMA) traffic
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed (the barrier given
// by its shared-memory address, or by a pointer)
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// --------------------------------------------------------------------------
// TMA and bulk copies
// --------------------------------------------------------------------------

// a 3-D box [c0, c1, c2] (innermost first) of `map` into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a 2-D box [c0, c1] (innermost first) of `map` into shared memory
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a 3-D box of shared memory out to `map` at [c0, c1, c2]; parts past the
// tensor's edges are not written.  Completes in this thread's bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the async
// proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// gmem[0, bytes) += smem[0, bytes) in fp32, asynchronously (bytes a multiple
// of 16, both addresses 16-byte aligned)
__device__ __forceinline__ void bulk_reduce_add_f32(float* gmem, const float* smem,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(gmem),
      "r"(smem_u32(smem)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk operations have finished reading shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// barriers among some warps, register hand-over
// --------------------------------------------------------------------------

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

#define SA_SETMAXNREG_DEC(n) asm volatile("setmaxnreg.dec.sync.aligned.u32 " #n ";\n" ::: "memory")
#define SA_SETMAXNREG_INC(n) asm volatile("setmaxnreg.inc.sync.aligned.u32 " #n ";\n" ::: "memory")

// --------------------------------------------------------------------------
// wgmma
// --------------------------------------------------------------------------

// Matrix descriptor of a swizzled operand in shared memory (`swizzle` bytes
// a row: 128, or 64 for the int8 operands of D = 64).
// K-major (K contiguous): SBO = 8 rows (1024 bytes at 128, 512 at 64), LBO
// unused; a K step of 32 bytes (16 bf16 or 32 int8) inside a row adds 32.
// MN-major (M or N contiguous, the transpose bit set; 16-bit types only):
// LBO = the stride between 64-element chunks of M / N, SBO = 1024 (8 rows of
// K); a K step of 16 rows adds 2048 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo,
                                              int swizzle = 128) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= static_cast<uint64_t>(swizzle == 128 ? 1 : 2) << 62;  // layout: 128- or 64-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across an
// asynchronous wgmma (its writes are invisible to the compiler)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SA_ACC8(i)                                                                     \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),      \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64, 64] (+)= A . B^T, both operands in shared memory (bf16, fp32 sums);
// TA / TB: the transpose (MN-major) bits of A / B
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : SA_ACC8(0), SA_ACC8(8), SA_ACC8(16), SA_ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64, 128] (+)= A . B^T, both operands in shared memory
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : SA_ACC8(0), SA_ACC8(8), SA_ACC8(16), SA_ACC8(24), SA_ACC8(32), SA_ACC8(40), SA_ACC8(48),
        SA_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64, 64] (+)= A . B with A in registers (the accumulator layout packed to
// bf16 pairs) and B in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SA_ACC8(0), SA_ACC8(8), SA_ACC8(16), SA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64, 128] (+)= A . B, A in registers, B in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : SA_ACC8(0), SA_ACC8(8), SA_ACC8(16), SA_ACC8(24), SA_ACC8(32), SA_ACC8(40), SA_ACC8(48),
        SA_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#define SA_ACC8I(i)                                                                    \
  "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),      \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define SA_OUT8I(i)                                                                    \
  "=r"(d[i + 0]), "=r"(d[i + 1]), "=r"(d[i + 2]), "=r"(d[i + 3]), "=r"(d[i + 4]),      \
      "=r"(d[i + 5]), "=r"(d[i + 6]), "=r"(d[i + 7])

// D[64, 128] (+)= A . B^T on the s8 tensor cores (s32 sums), both operands
// K-major in shared memory: 8-bit operands have no transpose bit
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : SA_ACC8I(0), SA_ACC8I(8), SA_ACC8I(16), SA_ACC8I(24), SA_ACC8I(32), SA_ACC8I(40),
        SA_ACC8I(48), SA_ACC8I(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 128] = A . B^T on the s8 tensor cores, D overwritten: the first
// k-step of a chain.  D is an output only here, so no earlier value of it
// is kept alive across the issue
__device__ __forceinline__ void wgmma_s8_n128_first(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : SA_OUT8I(0), SA_OUT8I(8), SA_OUT8I(16), SA_OUT8I(24), SA_OUT8I(32), SA_OUT8I(40),
        SA_OUT8I(48), SA_OUT8I(56)
      : "l"(da), "l"(db), "r"(0));
}

// D[64, 128] (+)= A . B^T on the s8 tensor cores, A in registers (per warp
// the m16n8k32 fragment: rows g and g + 8, columns 4t..4t + 3 and 16 + 4t..
// 16 + 4t + 3, four int8 a register), B K-major in shared memory
__device__ __forceinline__ void wgmma_s8_rs_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : SA_ACC8I(0), SA_ACC8I(8), SA_ACC8I(16), SA_ACC8I(24), SA_ACC8I(32), SA_ACC8I(40),
        SA_ACC8I(48), SA_ACC8I(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64, 64] (+)= A . B^T, the same with N = 64
__device__ __forceinline__ void wgmma_s8_rs_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : SA_ACC8I(0), SA_ACC8I(8), SA_ACC8I(16), SA_ACC8I(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef SA_ACC8I
#undef SA_OUT8I
#undef SA_ACC8

// D[64, D] += A . B with A in registers, B a [16, D] step of an MN-major
// tile (D = 64 or 128)
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[D / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db, 1);
  } else {
    wgmma_rs_n64(d, a, db, 1);
  }
}

// D[64, D] (+)= A . B^T on the s8 tensor cores, A in registers, B a [D, 32]
// k-step of a K-major tile (D = 64 or 128)
template <int D>
__device__ __forceinline__ void wgmma_s8_rs_d(int (&d)[D / 2], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  if constexpr (D == 128) {
    wgmma_s8_rs_n128(d, a, db, accumulate);
  } else {
    wgmma_s8_rs_n64(d, a, db, accumulate);
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                             &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a tiled map of `rank` dims (innermost first, strides in bytes of dims 1..)
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 3-D map over a [B, L, N * D] bf16 tensor: boxes of `rows` x 64 elements
// of one batch, 128-byte swizzle; rows past L read as zeros (never the next
// batch's rows)
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int ND, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)ND, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ND * 2, (cuuint64_t)L * ND * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// the same over a [B, L, N * D] int8 tensor: boxes of `rows` x `width`
// bytes (128, or 64 with a 64-byte swizzle; unswizzled rows of `width`
// bytes without `swizzle`).  TMA has no signed 8-bit type; the bytes move
// unchanged as UINT8
inline bool make_map_s8(CUtensorMap* map, const void* ptr, int B, int L, int ND, int rows,
                        int width, bool swizzle = true) {
  const cuuint64_t dims[3] = {(cuuint64_t)ND, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ND, (cuuint64_t)L * ND};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)rows, 1};
  const CUtensorMapSwizzle sw = !swizzle      ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : width == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ptr, dims, strides, box, sw);
}

// 2-D map over a row-major [rows, cols] matrix of `elem_bytes`-byte elements
// (bf16 or int8): boxes of box_rows x box_cols; parts past the edges read as
// zeros
inline bool make_map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int elem_bytes,
                        int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_map(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    2, ptr, dims, strides, box, swizzle);
}

}  // namespace sa

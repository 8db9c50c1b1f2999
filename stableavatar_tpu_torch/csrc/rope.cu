// Split-pair rotary embedding passes for Hopper (sm_90a): the rotation of
// K1-rope and K4-rope (`flash_attention(rope=)`), one elementwise pass on
// each side of the attention kernels.
//
// They replace the rotation inside the Pallas bodies of
// stableavatar_tpu/ops/flash_attention.py: `_rot` (:87) applied to q and k
// in `_fwd_body` (:142-143), `_bwd_dkdv_body` (:731-732) and `_bwd_dq_body`
// (:804-805), and `_rot_inv` (:96) applied to the fp32 dK and dQ sums before
// their one rounding (:771, :837).  Pair j of a row lies at channels
// (j, j + D/2); the packed fp32 table [L, D] holds cos in columns [0, D/2)
// and sin in [D/2, D), row i for position i.
//
// - `rope_rotate_kernel` (entry `sa_rope_rotate`): bf16 q [B, Lq, N, D] and
//   k [B, Lk, N, D] -> rotated bf16 copies, q by table rows [0, Lq), k by
//   [0, Lk), in one launch.  K1-rope is this pass, then the wgmma K1
//   (flash_attention.cu) on the copies; K4-rope's fused K4 takes the same
//   copies, which the autograd Function saves.
// - `rope_finalize_bwd_kernel` (entry `sa_rope_finalize_bwd`): the fused
//   K4's fp32 dQ (its bulk-reduced buffer) and fp32 dK -> inverse-rotated,
//   rounded to bf16; fp32 dV -> bf16; one launch.
//
// The rotation depends only on the position, so doing it once costs one
// read and one write of q and k.  Doing it per (query block, key tile)
// visit, as the TPU bodies do, would read 64 KB of fp32 table a visit from
// L2 -- at [3, 21504, 12, 128] with 128-row tiles 66.6 GB, as much as all
// of K1's K and V traffic.
//
// Each product and sum is rounded on its own (`__fmul_rn`, `__fadd_rn`,
// `__fsub_rn`: nvcc would otherwise contract `a * b - c * d` into a fused
// multiply-add), in the order of `_rot` / `_rot_inv`, and each result is
// rounded to bf16 once, to nearest even: the output equals
// `rope_apply_split(x, rope[:L]).to(bf16)` (ops/rope.py) bit for bit.
//
// What bounds them on the H100: bytes.  The rotation reads q and k and
// writes both (792 MB at [3, 21504, 12, 128], plus 11 MB of table), 0.24 ms
// at 3.35 TB/s; the finalize reads three fp32 gradients and writes three
// bf16 ones (594 MB at [1, 21504, 12, 128]), 0.18 ms.  So a thread moves 16
// bytes a load: one item is 8 pairs of one row -- 16 bytes of each bf16 half
// (or 32 of each fp32 half) and 32 + 32 bytes of table, all read through
// the read-only path (the table, at most 11 MB, stays in L2 for all the
// heads and batches that share a position).  No shared memory, no tensor
// cores.
#include "hopper_common.cuh"

namespace sa {
namespace rope {

constexpr int kThreads = 256;
constexpr int kPairs = 8;  // pairs of one row an item (and 16 channels of dV)

// (x0, x1) -> (x0 c - x1 s, x0 s + x1 c): `_rot`
__device__ __forceinline__ void rot_pair(float& x0, float& x1, float c, float s) {
  const float y0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
  const float y1 = __fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c));
  x0 = y0;
  x1 = y1;
}

// its inverse (transpose): (g0, g1) -> (g0 c + g1 s, -g0 s + g1 c): `_rot_inv`
__device__ __forceinline__ void rot_inv_pair(float& g0, float& g1, float c, float s) {
  const float y0 = __fadd_rn(__fmul_rn(g0, c), __fmul_rn(g1, s));
  const float y1 = __fadd_rn(__fmul_rn(-g0, s), __fmul_rn(g1, c));
  g0 = y0;
  g1 = y1;
}

// 8 bf16 <-> 8 floats
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

// 8 consecutive floats, 16-byte aligned, through the read-only path
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 a = __ldg(v), b = __ldg(v + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// cos and sin of pairs [c, c + 8) of table row `pos`
template <int D>
__device__ __forceinline__ void load_cs(const float* __restrict__ table, unsigned pos, int c,
                                        float (&cs)[8], float (&sn)[8]) {
  const float* t = table + (size_t)pos * D + c;
  load8(t, cs);
  load8(t + D / 2, sn);
}

// item i of a [B, L, N, D] tensor with D / 16 items a row: its row (b, l,
// n), its first pair (or dV channel / 2), and its position l
template <int D>
__device__ __forceinline__ void locate(unsigned i, int L, int N, unsigned& row, int& c,
                                       unsigned& pos) {
  constexpr unsigned kPer = D / (2 * kPairs);
  row = i / kPer;
  c = (i % kPer) * kPairs;
  pos = (row / N) % L;
}

// items [0, items_q) rotate q, [items_q, items) rotate k
template <int D>
__global__ void __launch_bounds__(kThreads)
rope_rotate_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const float* __restrict__ table, __nv_bfloat16* __restrict__ qr,
                   __nv_bfloat16* __restrict__ kr, int Lq, int Lk, int N, unsigned items_q,
                   unsigned items) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const bool is_q = i < items_q;
  unsigned row, pos;
  int c;
  locate<D>(is_q ? i : i - items_q, is_q ? Lq : Lk, N, row, c, pos);
  const size_t off = (size_t)row * D + c;
  const __nv_bfloat16* x = (is_q ? q : k) + off;
  __nv_bfloat16* y = (is_q ? qr : kr) + off;
  float x0[8], x1[8], cs[8], sn[8];
  unpack8(*reinterpret_cast<const uint4*>(x), x0);
  unpack8(*reinterpret_cast<const uint4*>(x + D / 2), x1);
  load_cs<D>(table, pos, c, cs, sn);
#pragma unroll
  for (int e = 0; e < 8; ++e) rot_pair(x0[e], x1[e], cs[e], sn[e]);
  *reinterpret_cast<uint4*>(y) = pack8(x0);
  *reinterpret_cast<uint4*>(y + D / 2) = pack8(x1);
}

// items [0, items_q) finalize dQ, [items_q, items_qk) dK, [items_qk, items) dV
template <int D>
__global__ void __launch_bounds__(kThreads)
rope_finalize_bwd_kernel(const float* __restrict__ dq32, const float* __restrict__ dk32,
                         const float* __restrict__ dv32, const float* __restrict__ table,
                         __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int N,
                         unsigned items_q, unsigned items_qk, unsigned items) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  unsigned row, pos;
  int c;
  if (i >= items_qk) {
    // dV: 16 channels of one row, rounded as they are
    locate<D>(i - items_qk, Lk, N, row, c, pos);
    const size_t off = (size_t)row * D + 2 * c;
    float a[8], b[8];
    load8(dv32 + off, a);
    load8(dv32 + off + 8, b);
    *reinterpret_cast<uint4*>(dv + off) = pack8(a);
    *reinterpret_cast<uint4*>(dv + off + 8) = pack8(b);
    return;
  }
  const bool is_q = i < items_q;
  locate<D>(is_q ? i : i - items_q, is_q ? Lq : Lk, N, row, c, pos);
  const size_t off = (size_t)row * D + c;
  const float* g = (is_q ? dq32 : dk32) + off;
  __nv_bfloat16* y = (is_q ? dq : dk) + off;
  float g0[8], g1[8], cs[8], sn[8];
  load8(g, g0);
  load8(g + D / 2, g1);
  load_cs<D>(table, pos, c, cs, sn);
#pragma unroll
  for (int e = 0; e < 8; ++e) rot_inv_pair(g0[e], g1[e], cs[e], sn[e]);
  *reinterpret_cast<uint4*>(y) = pack8(g0);
  *reinterpret_cast<uint4*>(y + D / 2) = pack8(g1);
}

}  // namespace rope
}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns the first CUDA error (0 on success).  The
// table [L, D] fp32 has L >= Lq and L >= Lk; every pointer is 16-byte
// aligned and every tensor contiguous; D is 64 or 128.
// --------------------------------------------------------------------------

namespace {

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// items of a [B, L, N, D] tensor, D / 16 a row
unsigned long long items_of(int B, int L, int N, int D) {
  return (unsigned long long)B * L * N * (D / 16);
}

// at least one item, and few enough for the kernels' 32-bit indices
bool launchable(unsigned long long items) {
  return items > 0 && items <= 0xFFFFFFFFull - sa::rope::kThreads;
}

}  // namespace

// qr, kr [B, Lq / Lk, N, D] bf16 = q, k rotated by table rows [0, Lq) / [0, Lk)
extern "C" int sa_rope_rotate(const void* q, const void* k, const void* table, void* qr,
                              void* kr, int B, int Lq, int Lk, int N, int D, void* stream) {
  const unsigned long long nq = items_of(B, Lq, N, D), n = nq + items_of(B, Lk, N, D);
  if ((D != 64 && D != 128) || !launchable(n) || !aligned16(q) || !aligned16(k) ||
      !aligned16(table) || !aligned16(qr) || !aligned16(kr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + sa::rope::kThreads - 1) / sa::rope::kThreads);
  auto q_ = static_cast<const __nv_bfloat16*>(q);
  auto k_ = static_cast<const __nv_bfloat16*>(k);
  auto t_ = static_cast<const float*>(table);
  auto qr_ = static_cast<__nv_bfloat16*>(qr);
  auto kr_ = static_cast<__nv_bfloat16*>(kr);
  if (D == 128) {
    sa::rope::rope_rotate_kernel<128><<<blocks, sa::rope::kThreads, 0, st>>>(
        q_, k_, t_, qr_, kr_, Lq, Lk, N, (unsigned)nq, (unsigned)n);
  } else {
    sa::rope::rope_rotate_kernel<64><<<blocks, sa::rope::kThreads, 0, st>>>(
        q_, k_, t_, qr_, kr_, Lq, Lk, N, (unsigned)nq, (unsigned)n);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq [B, Lq, N, D], dk, dv [B, Lk, N, D] bf16 from the fp32 sums dq32, dk32,
// dv32 of the same shapes: dQ and dK inverse-rotated by table rows [0, Lq) /
// [0, Lk), dV as it is
extern "C" int sa_rope_finalize_bwd(const void* dq32, const void* dk32, const void* dv32,
                                    const void* table, void* dq, void* dk, void* dv, int B,
                                    int Lq, int Lk, int N, int D, void* stream) {
  const unsigned long long nq = items_of(B, Lq, N, D), nk = items_of(B, Lk, N, D);
  const unsigned long long n = nq + 2 * nk;
  if ((D != 64 && D != 128) || !launchable(n) || !aligned16(dq32) || !aligned16(dk32) ||
      !aligned16(dv32) || !aligned16(table) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + sa::rope::kThreads - 1) / sa::rope::kThreads);
  auto g_q = static_cast<const float*>(dq32);
  auto g_k = static_cast<const float*>(dk32);
  auto g_v = static_cast<const float*>(dv32);
  auto t_ = static_cast<const float*>(table);
  auto dq_ = static_cast<__nv_bfloat16*>(dq);
  auto dk_ = static_cast<__nv_bfloat16*>(dk);
  auto dv_ = static_cast<__nv_bfloat16*>(dv);
  if (D == 128) {
    sa::rope::rope_finalize_bwd_kernel<128><<<blocks, sa::rope::kThreads, 0, st>>>(
        g_q, g_k, g_v, t_, dq_, dk_, dv_, Lq, Lk, N, (unsigned)nq, (unsigned)(nq + nk),
        (unsigned)n);
  } else {
    sa::rope::rope_finalize_bwd_kernel<64><<<blocks, sa::rope::kThreads, 0, st>>>(
        g_q, g_k, g_v, t_, dq_, dk_, dv_, Lq, Lk, N, (unsigned)nq, (unsigned)(nq + nk),
        (unsigned)n);
  }
  return static_cast<int>(cudaGetLastError());
}

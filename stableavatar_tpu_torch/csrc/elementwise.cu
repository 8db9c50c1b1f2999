// Elementwise passes of the DiT for Hopper (sm_90a).
//
// `gelu_tanh_kernel` (entry `sa_gelu_tanh`): out = gelu_tanh(x) over a
// contiguous bf16 or fp32 x, equal bit for bit to the composition PyTorch
// runs in `ops/activations.py` (`_gelu_tanh_plain`): the JAX package's
// `jax.nn.gelu(approximate=True)` op for op, each op computed in fp32 and
// rounded to x's dtype in this order:
//
//   u = r(x * x), u = r(x * u)            x^3 = x * (x * x)
//   u = r(c1 * u), u = r(x + u)           c1 = 0.044715 in x's dtype
//   u = r(c0 * u)                         c0 = sqrt(2 / pi) in x's dtype
//   u = r(tanhf(u)), u = r(1 + u), u = r(0.5 * u)
//   out = r(x * u)
//
// In bf16 every op but tanh is a product or a sum of two bf16 values, and
// such an op rounded once to bf16 equals it computed in fp32 and then
// rounded: the product of two 8-bit significands is exact in fp32, and a
// sum's fp32 rounding can never land on a bf16 midpoint the exact sum is not
// on.  (A product deep in the subnormals, below 2^-149, can round otherwise,
// but only where x is so small that x + c1 x^3 is x either way.)  So those
// ops run on pairs in bf16 (`mul.rn.bf16x2`, `add.rn.bf16x2`: one
// instruction for two elements, and the explicit rounding keeps ptxas from
// contracting a product and a sum into one fma), and only tanh goes through
// fp32: the precise `tanhf` (no --use_fast_math), the function PyTorch's
// `tanh` calls, rounded with `__floats2bfloat162_rn`.  Rounding each op in
// fp32 instead costs a conversion an op, and the card converts at a
// fraction of its fp32 rate: that form took 1.49 ms at [64512, 8960] on an
// H100, twice the byte bound.  In fp32 each op is one `__fmul_rn` /
// `__fadd_rn`, which no contraction changes.
//
// `gelu_tanh_bwd_kernel` (entry `sa_gelu_tanh_bwd`): dx from x and the
// output's gradient g, equal bit for bit to what autograd computes through
// that composition on the card: the forward's intermediates recomputed as
// it rounds them, then each op's backward rounded to x's dtype as PyTorch's
// kernels round it, and x's five gradients summed in the order the
// autograd engine adds them (from `x * u`, `x + u`, `x * (x * x)`, then
// both factors of `x * x`).  The one fused op is tanh's backward, PyTorch's
// `a * (1 - b * b)` in x's own type: three roundings in bf16; in fp32 nvcc
// contracts `1 - b * b` into one fma.  It runs only in training, so it
// keeps the plain form, each op through fp32: 3.6 ms at [64512, 8960] on an
// H100, 3.5x its byte bound.
//
// What bounds the forward on the H100: bytes.  The composition is nine
// PyTorch passes, each reading and writing the whole tensor in device
// memory -- fc1's product [64512, 8960] is 1.16 GB at 1.3B, [64512, 13824]
// 1.78 GB at 14B.  One pass reads x once and writes out once (out may be
// x): 2.31 / 3.57 GB, 0.69 / 1.06 ms at 3.35 TB/s.  A thread moves 16 bytes
// a load and keeps kVecs of them in flight; the tensors are read and
// written with the streaming hints (far larger than L2, touched once).  The
// elements after the last whole vector go one a thread.  No shared memory,
// no tensor cores.  It replaces no TPU kernel: XLA fuses the same chain on
// the TPU.  The constants come from the caller, rounded as the composition
// rounds them.
#include <initializer_list>
#include <type_traits>

#include "hopper_common.cuh"

namespace sa {
namespace act {

constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 16-byte vectors a thread, all loaded before any is computed
constexpr unsigned kPerBlock = kThreads * kVecs;

// two bf16 lanes of a 32-bit word, each op rounded to nearest even once
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the chain's constants: both lanes of a bf16 pair, and the fp32 values
struct Consts {
  uint32_t c0_2, c1_2, one_2, half_2;
  float c0, c1;
};

// the forward on two bf16 lanes of x
__device__ __forceinline__ uint32_t gelu_tanh2(uint32_t x, const Consts& k) {
  uint32_t u = mul2(x, x);
  u = mul2(x, u);
  u = mul2(k.c1_2, u);
  u = add2(x, u);
  u = mul2(k.c0_2, u);
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  u = pack_bf16(tanhf(f.x), tanhf(f.y));
  u = add2(k.one_2, u);
  u = mul2(k.half_2, u);
  return mul2(x, u);
}

// the forward on one fp32 x
__device__ __forceinline__ float gelu_tanh1(float x, const Consts& k) {
  float u = __fmul_rn(x, x);
  u = __fmul_rn(x, u);
  u = __fmul_rn(k.c1, u);
  u = __fadd_rn(x, u);
  u = __fmul_rn(k.c0, u);
  u = tanhf(u);
  u = __fadd_rn(1.0f, u);
  u = __fmul_rn(0.5f, u);
  return __fmul_rn(x, u);
}

// a 16-byte vector of T: 8 bf16 in four pairs, or 4 fp32
template <typename T>
__device__ __forceinline__ uint4 gelu_tanh_vec(uint4 v, const Consts& k) {
  if constexpr (std::is_same_v<T, float>) {
    return make_uint4(__float_as_uint(gelu_tanh1(__uint_as_float(v.x), k)),
                      __float_as_uint(gelu_tanh1(__uint_as_float(v.y), k)),
                      __float_as_uint(gelu_tanh1(__uint_as_float(v.z), k)),
                      __float_as_uint(gelu_tanh1(__uint_as_float(v.w), k)));
  } else {
    return make_uint4(gelu_tanh2(v.x, k), gelu_tanh2(v.y, k), gelu_tanh2(v.z, k),
                      gelu_tanh2(v.w, k));
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// an fp32 value rounded to T, as one of PyTorch's kernels stores it
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// the forward on one element of T (the tail after the whole vectors)
template <typename T>
__device__ __forceinline__ T gelu_tanh_elem(T x, const Consts& k) {
  if constexpr (std::is_same_v<T, float>) {
    return gelu_tanh1(x, k);
  } else {
    const uint32_t u = gelu_tanh2(__bfloat16_as_ushort(x), k);
    return __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xFFFFu));
  }
}

// PyTorch's tanh backward a * (1 - b * b) on T (b = tanh's output)
template <typename T>
__device__ __forceinline__ float tanh_grad(float a, float b) {
  if constexpr (std::is_same_v<T, float>) {
    return __fmul_rn(a, __fmaf_rn(-b, b, 1.0f));
  } else {
    return rnd<T>(__fmul_rn(a, rnd<T>(__fsub_rn(1.0f, rnd<T>(__fmul_rn(b, b))))));
  }
}

// dx of one element from x and g, the gradient of gelu_tanh(x)
template <typename T>
__device__ __forceinline__ float gelu_tanh_grad1(float x, float g, const Consts& k) {
  // the forward's intermediates: a = x x, c = x a, d = c1 c, e = x + d,
  // f = c0 e, t = tanh f, h = 1 + t, i = 0.5 h (out = x i)
  const float a = rnd<T>(__fmul_rn(x, x));
  const float c = rnd<T>(__fmul_rn(x, a));
  const float d = rnd<T>(__fmul_rn(k.c1, c));
  const float e = rnd<T>(__fadd_rn(x, d));
  const float f = rnd<T>(__fmul_rn(k.c0, e));
  const float t = rnd<T>(tanhf(f));
  const float h = rnd<T>(__fadd_rn(1.0f, t));
  const float i = rnd<T>(__fmul_rn(0.5f, h));
  // each op's backward, from out back to x
  const float gi = rnd<T>(__fmul_rn(g, x));
  const float gx_out = rnd<T>(__fmul_rn(g, i));
  const float gh = rnd<T>(__fmul_rn(gi, 0.5f));
  const float ge = rnd<T>(__fmul_rn(tanh_grad<T>(gh, t), k.c0));  // also x's from e = x + d
  const float gc = rnd<T>(__fmul_rn(ge, k.c1));
  const float gx_c = rnd<T>(__fmul_rn(gc, a));
  const float ga = rnd<T>(__fmul_rn(gc, x));
  const float gx_a = rnd<T>(__fmul_rn(ga, x));  // each factor of a = x x
  float dx = rnd<T>(__fadd_rn(gx_out, ge));
  dx = rnd<T>(__fadd_rn(dx, gx_c));
  dx = rnd<T>(__fadd_rn(dx, gx_a));
  return rnd<T>(__fadd_rn(dx, gx_a));
}

template <typename T>
__device__ __forceinline__ uint4 gelu_tanh_grad_vec(uint4 xv, uint4 gv, const Consts& k) {
  constexpr int kN = 16 / sizeof(T);
  const T* x = reinterpret_cast<const T*>(&xv);
  const T* g = reinterpret_cast<const T*>(&gv);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < kN; ++j) o[j] = from_f<T>(gelu_tanh_grad1<T>(to_f(x[j]), to_f(g[j]), k));
  return out;
}

__device__ __forceinline__ Consts make_consts(float c0, float c1) {
  return Consts{pack_bf16(c0, c0), pack_bf16(c1, c1), pack_bf16(1.0f, 1.0f),
                pack_bf16(0.5f, 0.5f), c0, c1};
}

// vectors [blockIdx.x * kPerBlock, + kPerBlock) of x, thread t taking t,
// t + kThreads, ...; block 0 also takes the n % (16 / sizeof(T)) elements
// after the last whole vector.  x and out may be the same buffer: each
// element is read and written by one thread, the read first.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_tanh_kernel(const T* x, T* out, unsigned long long n, float c0, float c1) {
  constexpr unsigned kN = 16 / sizeof(T);
  const unsigned long long vecs = n / kN;
  const unsigned long long first = (unsigned long long)blockIdx.x * kPerBlock + threadIdx.x;
  const Consts k = make_consts(c0, c1);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  uint4 v[kVecs];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned long long i = first + j * kThreads;
    if (i < vecs) v[j] = __ldcs(xv + i);
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned long long i = first + j * kThreads;
    if (i >= vecs) break;
    __stcs(ov + i, gelu_tanh_vec<T>(v[j], k));
  }
  if (blockIdx.x == 0 && threadIdx.x < n - vecs * kN) {
    const unsigned long long i = vecs * kN + threadIdx.x;
    out[i] = gelu_tanh_elem<T>(x[i], k);
  }
}

// dx = the gradient of gelu_tanh at x given the output's gradient g, laid
// out as the forward's vectors; dx may be g.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_tanh_bwd_kernel(const T* x, const T* g, T* dx, unsigned long long n, float c0, float c1) {
  constexpr unsigned kN = 16 / sizeof(T);
  const unsigned long long vecs = n / kN;
  const unsigned long long first = (unsigned long long)blockIdx.x * kPerBlock + threadIdx.x;
  const Consts k = make_consts(c0, c1);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* ov = reinterpret_cast<uint4*>(dx);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const unsigned long long i = first + j * kThreads;
    if (i >= vecs) break;
    __stcs(ov + i, gelu_tanh_grad_vec<T>(__ldcs(xv + i), __ldcs(gv + i), k));
  }
  if (blockIdx.x == 0 && threadIdx.x < n - vecs * kN) {
    const unsigned long long i = vecs * kN + threadIdx.x;
    dx[i] = from_f<T>(gelu_tanh_grad1<T>(to_f(x[i]), to_f(g[i]), k));
  }
}

}  // namespace act
}  // namespace sa

// --------------------------------------------------------------------------
// plain C entry points (loaded with ctypes).  Each launches on `stream`,
// allocates nothing and returns the first CUDA error (0 on success).
// --------------------------------------------------------------------------

namespace {

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// blocks for n elements of `bytes` each (one where there are only tail
// elements), 0 where n or a pointer is unfit
unsigned blocks_for(long long n, int bytes, std::initializer_list<const void*> ptrs) {
  if (n < 1) return 0;
  for (const void* p : ptrs)
    if (!aligned16(p)) return 0;
  const unsigned long long vecs = (unsigned long long)n / (16 / bytes);
  const unsigned long long blocks = (vecs + sa::act::kPerBlock - 1) / sa::act::kPerBlock;
  return blocks > 0x7FFFFFFFull ? 0 : blocks == 0 ? 1 : (unsigned)blocks;
}

}  // namespace

// out = gelu_tanh(x) over n contiguous elements, bf16 (fp32 = 0) or fp32
// (fp32 = 1); out may be x.  Both 16-byte aligned; c0 and c1 are sqrt(2 /
// pi) and 0.044715 rounded to the elements' type.
extern "C" int sa_gelu_tanh(const void* x, void* out, long long n, int fp32, float c0, float c1,
                            void* stream) {
  const unsigned blocks = blocks_for(n, fp32 ? 4 : 2, {x, out});
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) {
    sa::act::gelu_tanh_kernel<float><<<blocks, sa::act::kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, c0, c1);
  } else {
    sa::act::gelu_tanh_kernel<__nv_bfloat16><<<blocks, sa::act::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, c0, c1);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx = the gradient of gelu_tanh at x given the output's gradient g, over n
// contiguous elements of the same type and layout as `sa_gelu_tanh`'s; dx
// may be g.
extern "C" int sa_gelu_tanh_bwd(const void* x, const void* g, void* dx, long long n, int fp32,
                                float c0, float c1, void* stream) {
  const unsigned blocks = blocks_for(n, fp32 ? 4 : 2, {x, g, dx});
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) {
    sa::act::gelu_tanh_bwd_kernel<float><<<blocks, sa::act::kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dx), n,
        c0, c1);
  } else {
    sa::act::gelu_tanh_bwd_kernel<__nv_bfloat16><<<blocks, sa::act::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), n, c0, c1);
  }
  return static_cast<int>(cudaGetLastError());
}

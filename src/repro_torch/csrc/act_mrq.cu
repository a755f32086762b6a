// Fused activation -> MRQ signed two-region quant-dequant for Hopper
// (sm_90a): kernel B13.
//
// Replaces the Pallas kernel repro/kernels/act_mrq.py::act_mrq. Per
// element x (f32 or bf16, widened to f32):
//
//   gelu: h = x * (0.5 * (1 + tanhf(c * (x + 0.044715 * ((x * x) * x)))))
//         with c = f32(sqrt(2/pi)), jax.nn.gelu(approximate=True)'s order
//   silu: h = x * (1 / (1 + expf(-x)))
//   out  = h < 0 ? clip(rint(h / s_neg), -half, 0) * s_neg
//                : clip(rint(h / s_pos), 0, half-1) * s_pos
//   in f32 or bf16, same shape as x; a NaN h (from a NaN x, or the GELU's
//   and SiLU's -inf * 0 at x = -inf) gives NaN. A zero takes jnp.clip's
//   sign: with positive steps the sign bit is set exactly where h < 0
//   (h = -0 gives +0).
//
// What bounds it on the card: bytes, once the instructions fit under them.
// At the DiT-XL/2 MLP's hidden activation (2048 x 4608 bf16) it reads
// 18.9 MB and writes 18.9 MB (11.3 us at 3.35 TB/s); the accurate tanhf
// and the quantize are some 36 SASS instructions an element, about as
// long to issue. The quantize was where they went: an IEEE divide on each
// side of a branch on h's sign, which GELU's output mixes in almost every
// warp, made each warp issue two divides (with their slow-path checks) an
// element.
//
// Design: one quotient an element and no branch on h. The sign of h
// selects the step and its reciprocal: the negative branch codes against
// -s_neg, so both branches' codes are >= 0, rint(h / -s_neg) * -s_neg
// being the reference's rint(h / s_neg) * s_neg bit for bit. h is clipped
// at (half - 1) * s_pos before the quotient (the positive branch's top
// code, see qdq_fast), so one clip at half tops both branches. The
// quotient is common.cuh's div_rn (reciprocal, Newton and Markstein
// steps), rounded by rintf (one FRND), and every zero code is +0: +0 *
// -s_neg is the -0 the reference gives there, at no cost. Each
// thread takes both reciprocals once (__frcp_rn) from the steps it reads
// from device memory (no host read). A warp takes 32 x 16 elements, its
// lanes on consecutive 16-byte groups of the wider type (8 bytes of the
// narrower), every load issued before the arithmetic, where both pointers
// are 16-byte aligned; element by element on the tail and otherwise. A
// grid of resident CTAs strides over the tensor.
//
// The quotient's range: div_rn is correctly rounded for a finite normal
// step where no step of it over- or underflows. Both steps in [2^-100,
// 2^100] (fast_step) keep it so wherever a code can turn: a quotient of at
// least 1/4 has a dividend of at least 2^-102, whose residual is exactly
// representable; the reciprocal stays normal (>= 2^-100); and below half
// + 1 no product passes 2^108. A larger quotient (finite once h is
// clipped) has only to round above half. Any other step (0, negative,
// subnormal, huge, inf, NaN) takes the general path in the same launch:
// the IEEE divide (__fdiv_rn), rintf, both clips with the reference's
// zero signs, as the plain version defines them. The test of the steps
// is uniform over the grid, so no warp runs both paths.
//
// Exactness: each step its own __fmul_rn / __fadd_rn (and -fmad=false;
// GELU's 0.5 * (1 + t) one FMA that rounds as the two steps do, see act),
// tanhf and expf (not the fast intrinsics: torch.tanh and torch.exp on the
// card), __frcp_rn for SiLU's 1 / (1 + e) (the same correctly rounded
// value as the divide), rint half to even, in the plain version's order
// (repro_torch/kernels/ref.py:: gelu_tanh_ref, silu_ref, act_mrq_ref):
// each output equals its bit for bit.
#include "common.cuh"

namespace {

constexpr int VEC = 16;                   // elements a thread per tile (8k)
constexpr int THREADS = 256;
// f32(sqrt(2/pi)) and f32(0.044715), as jax.nn.gelu (and torch, casting a
// Python scalar) round them
constexpr float SQRT_2_OVER_PI = 0x1.988454p-1f;
constexpr float GELU_C = 0x1.6e4e26p-5f;

// GELU's 0.5 * (1 + t) is one FMA, 0.5 * t + 0.5, bit for bit: 1 + t is
// 0 or at least 2^-24 (t, a tanh, lies in [-1, 1]), so halving it commutes
// with the rounding.
template <int KIND>                       // 0 gelu (tanh), 1 silu
__device__ __forceinline__ float act(float x) {
  if (KIND == 0) {
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float u = __fmul_rn(SQRT_2_OVER_PI, __fadd_rn(x, __fmul_rn(GELU_C, x3)));
    return __fmul_rn(x, __fmaf_rn(0.5f, tanhf(u), 0.5f));
  }
  return __fmul_rn(x, __frcp_rn(__fadd_rn(1.0f, expf(-x))));
}

// A step inside the fast quotient's range (see the head of the file);
// false for NaN.
__device__ __forceinline__ bool fast_step(float s) {
  return s >= 0x1p-100f && s <= 0x1p100f;
}

// The fast path's constants: the negative branch codes against -s_neg.
struct Steps {
  float mn, yn;                           // -s_neg and 1 / -s_neg
  float sp, yp;                           // s_pos and 1 / s_pos
  float tp;                               // (half - 1) * s_pos, rounded
  float fhalf;
};

// Both steps in range: one quotient, one clip of h, one of the code and
// one multiply. h is clipped at tp first: that makes the positive
// branch's code min(rint(h / s_pos), half - 1) (tp / s_pos is within
// 2^-17 of half - 1) and leaves a negative h as it is; so one top clip at
// half serves both branches, and every quotient is finite (a finite x's
// GELU or SiLU is at least -0.28). The codes are >= 0, and a zero code is
// +0: div_rn of a = -0 (h = -0 takes the positive branch) gives +0. The
// clips keep a NaN.
__device__ __forceinline__ float qdq_fast(float h, const Steps& k) {
  const bool neg = h < 0.f;
  const float s = neg ? k.mn : k.sp;
  const float a = fmin_nan(h, k.tp);
  const float y = neg ? k.yn : k.yp;
  const float q = rintf(div_rn(a, s, y, __fmul_rn(a, y)));
  return __fmul_rn(fmin_nan(q, k.fhalf), s);
}

// Any steps: the IEEE quotient and jnp.clip's zero signs (its max and min
// order -0 below +0): the negative branch keeps a zero rint's sign and
// makes a positive rint +0; the positive branch's zeros are +0 (+ 0.f).
// The clips keep a NaN, as the reference's do (fmaxf would drop it).
__device__ __forceinline__ float qdq_any(float h, float sn, float sp, float fhalf) {
  if (h < 0.f) {
    const float v = rintf(__fdiv_rn(h, sn));
    return __fmul_rn(v > 0.f ? 0.f : fmax_nan(v, -fhalf), sn);
  }
  const float v = rintf(__fdiv_rn(h, sp));
  return __fmul_rn(__fadd_rn(fmin_nan(fmax_nan(v, 0.f), fhalf - 1.f), 0.f), sp);
}

// G elements at p: one 16-byte access of the wider of x and out, 8 bytes
// of the narrower where they differ (G = 16 / the wider element's size)
template <int G>
__device__ __forceinline__ void load_group(const float* p, float* v) {
  static_assert(G == 4, "an f32 group is one 16-byte access");
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
template <int G>
__device__ __forceinline__ void load_group(const __nv_bfloat16* p, float* v) {
  unsigned w[G / 2];
  if constexpr (G == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  }
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {       // a bf16 is an f32's high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <int G>
__device__ __forceinline__ void store_group(float* p, const float* v) {
  static_assert(G == 4, "an f32 group is one 16-byte access");
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <int G>
__device__ __forceinline__ void store_group(__nv_bfloat16* p, const float* v) {
  unsigned w[G / 2];
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {       // round to nearest even, two a cvt
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&b);
  }
  if constexpr (G == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A warp takes a tile of 32 x VEC elements, lane l the groups g * 32 + l
// of it: each load and store instruction of the warp covers consecutive
// groups. The grid's CTAs stride over the tiles.
template <typename TX, typename TO, int KIND>
__global__ void __launch_bounds__(THREADS) act_mrq_kernel(
    const TX* __restrict__ x, TO* __restrict__ out, long n,
    const float* __restrict__ s_neg, const float* __restrict__ s_pos,
    int half, int aligned) {
  constexpr int G = 16 / (sizeof(TX) > sizeof(TO) ? sizeof(TX) : sizeof(TO));
  const float sn = *s_neg, sp = *s_pos, fhalf = (float)half;
  const int lane = threadIdx.x & 31;
  const long stride = (long)gridDim.x * THREADS * VEC;
  long w0 = ((long)blockIdx.x * THREADS + (threadIdx.x & ~31)) * VEC;
  if (fast_step(sn) && fast_step(sp)) {
    const Steps k = {-sn, __frcp_rn(-sn), sp, __frcp_rn(sp),
                     __fmul_rn(fhalf - 1.f, sp), fhalf};
    for (; w0 < n; w0 += stride) {
      if (aligned && w0 + 32 * VEC <= n) {
        float v[VEC];
#pragma unroll
        for (int g = 0; g < VEC / G; ++g)
          load_group<G>(x + w0 + (g * 32 + lane) * G, v + g * G);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = qdq_fast(act<KIND>(v[j]), k);
#pragma unroll
        for (int g = 0; g < VEC / G; ++g)
          store_group<G>(out + w0 + (g * 32 + lane) * G, v + g * G);
        continue;
      }
#pragma unroll 1
      for (int j = 0; j < VEC; ++j) {     // the tail; all of an unaligned call
        const long e = w0 + j * 32 + lane;
        if (e < n) st(out + e, qdq_fast(act<KIND>(ldx(x, e)), k));
      }
    }
    return;
  }
  for (; w0 < n; w0 += stride)
#pragma unroll 1
    for (int j = 0; j < VEC; ++j) {
      const long e = w0 + j * 32 + lane;
      if (e < n) st(out + e, qdq_any(act<KIND>(ldx(x, e)), sn, sp, fhalf));
    }
}

// A grid of resident CTAs (the occupancy on this card, found once per
// instantiation), or fewer where the tensor has fewer tiles.
template <typename TX, typename TO, int KIND>
cudaError_t launch(const void* x, void* out, long n, const float* sn,
                   const float* sp, int half, int aligned, cudaStream_t s) {
  static long resident = 0;
  if (!resident) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, act_mrq_kernel<TX, TO, KIND>, THREADS, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    resident = (long)(per_sm > 0 ? per_sm : 1) * sms;
  }
  const long tiles = (n + (long)THREADS * VEC - 1) / ((long)THREADS * VEC);
  const long blocks = tiles < resident ? tiles : resident;
  act_mrq_kernel<TX, TO, KIND><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<TO*>(out), n, sn, sp, half, aligned);
  return cudaGetLastError();
}

template <typename TX, typename TO>
cudaError_t launch_kind(int kind, const void* x, void* out, long n,
                        const float* sn, const float* sp, int half,
                        int aligned, cudaStream_t s) {
  return kind ? launch<TX, TO, 1>(x, out, n, sn, sp, half, aligned, s)
              : launch<TX, TO, 0>(x, out, n, sn, sp, half, aligned, s);
}

}  // namespace

// x: n contiguous f32 (x_bf16 = 0) or bf16 elements; out: n f32
// (out_bf16 = 0) or bf16; s_neg, s_pos: one device f32 each; kind: 0
// gelu (tanh), 1 silu.
extern "C" int act_mrq_launch(const void* x, const void* s_neg,
                              const void* s_pos, void* out, long n, int half,
                              int kind, int x_bf16, int out_bf16,
                              void* stream) {
  if (n <= 0 || (kind != 0 && kind != 1)
      || (n + VEC - 1) / VEC / THREADS >= 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const int aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const float* sn = static_cast<const float*>(s_neg);
  const float* sp = static_cast<const float*>(s_pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16)
    e = out_bf16 ? launch_kind<__nv_bfloat16, __nv_bfloat16>(kind, x, out, n, sn, sp, half, aligned, s)
                 : launch_kind<__nv_bfloat16, float>(kind, x, out, n, sn, sp, half, aligned, s);
  else
    e = out_bf16 ? launch_kind<float, __nv_bfloat16>(kind, x, out, n, sn, sp, half, aligned, s)
                 : launch_kind<float, float>(kind, x, out, n, sn, sp, half, aligned, s);
  return (int)e;
}

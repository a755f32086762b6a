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
//   and SiLU's -inf * 0 at x = -inf) gives NaN.
//
// What bounds it on the card: bytes. It is elementwise, a handful of fp32
// operations and one tanhf or expf per element: at the DiT-XL/2 MLP's
// hidden activation (2048 x 4608 bf16) it reads 18.9 MB and writes 18.9
// MB, while the arithmetic is about a tenth of that time at the CUDA
// cores' rate. Design: a flat pass over the contiguous tensor, eight
// elements per thread as 16-byte loads and stores (one uint4 of bf16, two
// float4 of f32) where both pointers are 16-byte aligned, element by
// element on the tail and otherwise; the two steps are read once per
// thread from device memory (no host read of them).
//
// Exactness: each step its own __fmul_rn / __fadd_rn / __fdiv_rn (and
// -fmad=false), tanhf and expf (not the fast intrinsics), rintf (half to
// even), in the plain version's order (repro_torch/kernels/ref.py::
// gelu_tanh_ref, silu_ref, act_mrq_ref): each output equals its bit for
// bit.
#include "common.cuh"

namespace {

constexpr int VEC = 8;                    // elements per thread
// f32(sqrt(2/pi)) and f32(0.044715), as jax.nn.gelu (and torch, casting a
// Python scalar) round them
constexpr float SQRT_2_OVER_PI = 0x1.988454p-1f;
constexpr float GELU_C = 0x1.6e4e26p-5f;

template <int KIND>                       // 0 gelu (tanh), 1 silu
__device__ __forceinline__ float act(float x) {
  if (KIND == 0) {
    const float x3 = __fmul_rn(__fmul_rn(x, x), x);
    const float u = __fmul_rn(SQRT_2_OVER_PI, __fadd_rn(x, __fmul_rn(GELU_C, x3)));
    return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
  }
  return __fmul_rn(x, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))));
}

// The clips keep a NaN h, as the reference's do (fmaxf would drop it).
__device__ __forceinline__ float qdq(float h, float sn, float sp, float fhalf) {
  if (h < 0.f)
    return __fmul_rn(fmin_nan(fmax_nan(rintf(__fdiv_rn(h, sn)), -fhalf), 0.f), sn);
  return __fmul_rn(fmin_nan(fmax_nan(rintf(__fdiv_rn(h, sp)), 0.f), fhalf - 1.f),
                   sp);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(h[j]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) h[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, typename TO, int KIND>
__global__ void __launch_bounds__(256) act_mrq_kernel(
    const TX* __restrict__ x, TO* __restrict__ out, long n,
    const float* __restrict__ s_neg, const float* __restrict__ s_pos,
    int half, int aligned) {
  const long i0 = ((long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (i0 >= n) return;
  const float sn = *s_neg, sp = *s_pos, fhalf = (float)half;
  float v[VEC];
  if (aligned && i0 + VEC <= n) {
    load8(x + i0, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = qdq(act<KIND>(v[j]), sn, sp, fhalf);
    store8(out + i0, v);
    return;
  }
  for (int j = 0; j < VEC && i0 + j < n; ++j)
    st(out + i0 + j, qdq(act<KIND>(ldx(x, i0 + j)), sn, sp, fhalf));
}

template <typename TX, typename TO, int KIND>
cudaError_t launch(const void* x, void* out, long n, const float* sn,
                   const float* sp, int half, int aligned, cudaStream_t s) {
  const long threads = (n + VEC - 1) / VEC;
  act_mrq_kernel<TX, TO, KIND><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
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
      || (n + VEC - 1) / VEC / 256 >= 0x7fffffffL)
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

// Shared by the port's CUDA sources: the group lookup and element loads
// of every kernel; the correctly rounded quotient (div_rn), rint by the
// 1.5 x 2^23 add and the byte packing of the prologue pass
// (csrc/prologue.cuh) and of the attention kernels (csrc/attn.cuh:
// flash attention and the composed chain's matmuls, which code their
// operands in shared memory); the MRQ probability codes of flash and the
// softmax-codes pass (mrq_code); B13's quotient and NaN-keeping clips
// (csrc/act_mrq.cu); and the cp.async helpers.
//
// Groups: g points at device int32 group indices read with a row stride
// gs: gs = 0 reads g[0] for every row (one TGQ group per call), gs = 1
// reads g[row] (a per-row group vector: the _vec kernels of the
// continuous-batching slot pool). Every read goes through group_at, which
// clamps the index into [0, G): an entry of a caller's vector outside the
// stacks' G groups reads the nearest group, never memory past the stacks.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAGIC = 0x4B400000;   // the bits of 1.5 x 2^23
constexpr float FMAGIC = 12582912.0f;

// The group of row i: g[i * gs], clamped into [0, G).
__device__ __forceinline__ int group_at(const int* g, long i, int gs, int G) {
  return min(max(g[i * gs], 0), G - 1);
}

__device__ __forceinline__ float ldx(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldx(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// a / b rounded to nearest even (= __fdiv_rn(a, b)) from y = __frcp_rn(b)
// and q0 = a * y: a Newton step makes the quotient faithful, Markstein's
// step rounds it. Holds for finite normal b where no step over- or
// underflows; the callers use it for quotients below 2^17 (B13 also
// above, where it clips the code) and read codes that round a smaller
// quotient than 2^-100 to 0 either way.
__device__ __forceinline__ float div_rn(float a, float b, float y, float q0) {
  const float q1 = __fmaf_rn(__fmaf_rn(-b, q0, a), y, q0);
  return __fmaf_rn(__fmaf_rn(-b, q1, a), y, q1);
}

// rint(q) for |q| < 2^22: adding 1.5 x 2^23 rounds q to an integer (half
// to even) in the low mantissa bits.
__device__ __forceinline__ int rint_small(float q) {
  return __float_as_int(__fadd_rn(q, FMAGIC)) - MAGIC;
}

// rint(a / b) as a float (y = 1 / b) where |a * y| < 2^16; else a * y
// itself, which is at least 2^16 in magnitude, or inf or NaN where a / b
// is: a code clipped to a range far below 2^16 saturates the same way as
// from rint(a / b), and NaN stays NaN.
__device__ __forceinline__ float rint_div(float a, float b, float y) {
  const float q0 = __fmul_rn(a, y);
  if (!(fabsf(q0) < 65536.f)) return q0;
  return __fsub_rn(__fadd_rn(div_rn(a, b, y, q0), FMAGIC), FMAGIC);
}

// The MRQ code of score e of a row with denominator l (yl = 1/l): p =
// e / l; region 1 (r1: p < thr = half * s1): clip(rint(p / s1), 0,
// half-1) with y1 = 1/s1; region 2: clip(rint(p * half), 0, half), p *
// half being p / s2 exactly (s2 = 1/half). p >= 0, so only the top clips.
// Both quotients are correctly rounded (div_rn) where a code can turn on
// them: e in [0, l], l in [1, 2^16], s1 at least 2^-100. Shared by flash
// attention (csrc/flash_attn_mrq.cu) and the softmax-codes pass
// (csrc/softmax_mrq.cu: B10a, B10b, B12).
__device__ __forceinline__ int mrq_code(float e, float l, float yl, float s1,
                                        float y1, float thr, float fhalf,
                                        int half, bool& r1) {
  const float p = div_rn(e, l, yl, __fmul_rn(e, yl));
  r1 = p < thr;
  const float q = r1 ? div_rn(p, s1, y1, __fmul_rn(p, y1)) : __fmul_rn(p, fhalf);
  return min(rint_small(q), r1 ? half - 1 : half);
}

// mrq_code split by region into low bytes; the other region's is 0.
__device__ __forceinline__ void mrq_codes(float e, float l, float yl,
                                          float s1, float y1, float thr,
                                          float fhalf, int half, int& c1,
                                          int& c2) {
  bool r1;
  const int c = mrq_code(e, l, yl, s1, y1, thr, fhalf, half, r1);
  c1 = r1 ? c : 0;
  c2 = r1 ? 0 : c;
}

// max and min that return NaN where an operand is NaN (fmaxf and fminf
// return the other operand): a clip that keeps a NaN, as the reference's.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fmin_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The low bytes of a, b, c, d as one word (a in the lowest byte).
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

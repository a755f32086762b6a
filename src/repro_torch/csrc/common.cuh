// Shared by the port's CUDA sources: the group lookup and element loads
// of every kernel; the correctly rounded quotient (div_rn), rint by the
// 1.5 x 2^23 add and the byte packing of the prologue pass
// (csrc/prologue.cuh) and of flash attention (csrc/flash_attn_mrq.cu); the
// once-per-element SymQ codes pass of the composed chain's operands
// (codes_kernel: q, k and v of csrc/int8_bmm.cu, B9a-d); and the cp.async
// and mma.sync helpers.
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
// underflows; the callers use it for quotients below 2^17 and read codes
// that round a smaller quotient than 2^-100 to 0 either way.
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- SymQ codes, once per element ------------------------------------------
// codes_kernel writes clip(rint(x / s[g]), -(h-1), h-1) of a (batch, rows,
// cols) f32/bf16 tensor into a zero-padded int8 buffer, optionally
// transposed (the P.V B operand wants v kv-contiguous) and optionally two
// 4-bit codes per byte (B3b). Batch b reads its step through group_at(g,
// b, gs, G).
struct CodesArgs {
  const void* src; int8_t* dst;
  const float* s; const int* g;       // batch b's step: s[g[b * gs]]
  int gs;                             // group stride: 0 or 1 (B8)
  int G;                              // groups in s
  int batch, rows, cols;              // src: (batch, rows, cols)
  int rows_p, cols_p;                 // dst: (batch, rows_p, cols_p), or
  int transpose;                      //      (batch, cols_p, rows_p) if transpose
  int half;
  int packed;                         // two 4-bit codes per byte along the
};                                    // dst's inner axis (halved)

// SymQ code of src element (b, r, c); 0 in the padding.
template <typename TX>
__device__ __forceinline__ int sym_code(const CodesArgs& a, int b, int r, int c) {
  if (r >= a.rows || c >= a.cols) return 0;
  const float hi = (float)(a.half - 1);
  const float x = ldx(static_cast<const TX*>(a.src),
                      ((long)b * a.rows + r) * a.cols + c);
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, a.s[group_at(a.g, b, a.gs, a.G)])), -hi), hi);
}

// dst byte (b, i, j) of the padded (transposed, packed) code buffer.
template <typename TX>
__global__ void codes_kernel(CodesArgs a) {
  const int per = a.packed ? 2 : 1;   // codes per byte
  const int inner = (a.transpose ? a.rows_p : a.cols_p) / per;
  const int outer = a.transpose ? a.cols_p : a.rows_p;
  const long n = (long)a.batch * outer * inner;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = (int)(i / ((long)inner * outer));
  const int o = (int)((i / inner) % outer), in = (int)(i % inner) * per;
  int byte = 0;
  for (int j = 0; j < per; ++j) {
    const int code = a.transpose ? sym_code<TX>(a, b, in + j, o)
                                 : sym_code<TX>(a, b, o, in + j);
    byte |= (code & (a.packed ? 0xF : 0xFF)) << (4 * j);
  }
  a.dst[i] = (int8_t)byte;
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <typename TX>
cudaError_t codes(const void* src, int8_t* dst, const float* s, const int* g,
                  int gs, int G, int batch, int rows, int cols, int rows_p,
                  int cols_p, int transpose, int half, int packed,
                  cudaStream_t st) {
  CodesArgs c{src, dst, s, g, gs, G, batch, rows, cols, rows_p, cols_p,
              transpose, half, packed};
  const long n = (long)batch * rows_p * cols_p / (packed ? 2 : 1);
  codes_kernel<TX><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(c);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

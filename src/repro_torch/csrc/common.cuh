// Shared by the port's CUDA sources: the once-per-element quantize pass
// of the fused linears (csrc/int8_fused.cu: B1, B2; csrc/int4_packed.cu:
// B4, B5), which runs the prologue fusions; the once-per-element SymQ
// codes pass of the composed chain's operands (codes_kernel: q, k and v of
// csrc/int8_bmm.cu, B9a-d); and the cp.async and mma.sync helpers.
//
// quantize_kernel writes the activation codes as (M, Kq) int8, four per
// thread. Code column c holds x column k = (c / gkp) * gk + c % gkp: K is
// cut into groups of gk columns and each group is zero-padded to gkp code
// columns, so a GEMM k tile never straddles two groups (the int4 family's
// per-K-group scales). The int8 family passes gk = gkp = Kq: one group,
// c = k. Columns past K, and the padding of each group, get code 0.
//
// Groups: g points at device int32 group indices read with a row stride
// gs: gs = 0 reads g[0] for every row (one TGQ group per call: B1, B2,
// B4, B5), gs = 1 reads g[row] (a per-row group vector: the _vec kernels
// B6a, B6b, B7a, B7b of the continuous-batching slot pool). Every read
// goes through group_at, which clamps the index into [0, G): an entry of
// a caller's vector outside the stacks' G groups reads the nearest group,
// never memory past the stacks.
//
// Exactness: rintf (round half to even, as torch.round / jnp.round),
// __fdiv_rn (IEEE divide), __fmul_rn/__fadd_rn (each step rounds; built
// with -fmad=false as well), in the reference's op order.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct QArgs {
  const void* x; const float* s_a; const float* s_b; const int* g;
  const float* ps; const int* bv; const float* mu; const float* rsig;
  const float* sh; const float* sc;
  int8_t* qa; int8_t* qb;                      // (M, Kq) codes
  int M, K, Kq, half;
  int gk, gkp;                                 // see the header comment
  int gs;                                      // group stride: 0 or 1
  int G;                                       // groups in s_a, s_b
};

// The group of row i: g[i * gs], clamped into [0, G).
__device__ __forceinline__ int group_at(const int* g, long i, int gs, int G) {
  return min(max(g[i * gs], 0), G - 1);
}

__device__ __forceinline__ float ldx(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ldx(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// Prologue (optional): x' = ((x - mu) * rsig) * (1 + sc[b]) + sh[b], / ps.
// Affine:  c = clip(rint(x'/s_a[g]) + s_b[g] - half, -half, half-1).
// MRQ:     region a (x' < 0): clip(rint(x'/s_a[g]), -half, 0);
//          region b (x' >= 0): clip(rint(x'/s_b[g]), 0, half-1).
// with g = group_at(g, row, gs, G).
template <bool MRQ, typename TX>
__global__ void quantize_kernel(QArgs a) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int words = a.Kq / 4;
  if (i >= (long)a.M * words) return;
  const int row = (int)(i / words), c4 = (int)(i % words) * 4;
  const int grp = group_at(a.g, row, a.gs, a.G);
  const float qa = a.s_a[grp], qb = a.s_b[grp];
  const float fhalf = (float)a.half;
  const TX* x = static_cast<const TX*>(a.x);
  float mu = 0.f, rs = 0.f;
  int b = 0;
  if (a.mu) { mu = a.mu[row]; rs = a.rsig[row]; b = a.bv[row]; }
  unsigned wa = 0, wb = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c4 + j, cg = c % a.gkp;
    const int kk = (c / a.gkp) * a.gk + cg;
    int ca = 0, cb = 0;
    if (cg < a.gk && kk < a.K) {
      float v = ldx(x, (long)row * a.K + kk);
      if (a.mu) {
        v = __fmul_rn(__fsub_rn(v, mu), rs);
        const long o = (long)b * a.K + kk;
        v = __fadd_rn(__fmul_rn(v, __fadd_rn(1.0f, a.sc[o])), a.sh[o]);
      }
      if (a.ps) v = __fdiv_rn(v, a.ps[kk]);
      if (!MRQ) {
        float q = __fsub_rn(__fadd_rn(rintf(__fdiv_rn(v, qa)), qb), fhalf);
        ca = (int)fminf(fmaxf(q, -fhalf), fhalf - 1.f);
      } else if (v < 0.f) {
        ca = (int)fminf(fmaxf(rintf(__fdiv_rn(v, qa)), -fhalf), 0.f);
      } else {
        cb = (int)fminf(fmaxf(rintf(__fdiv_rn(v, qb)), 0.f), fhalf - 1.f);
      }
    }
    wa |= (unsigned)(ca & 0xFF) << (8 * j);
    wb |= (unsigned)(cb & 0xFF) << (8 * j);
  }
  const long o = (long)row * a.Kq + c4;
  *reinterpret_cast<unsigned*>(a.qa + o) = wa;
  if (MRQ) *reinterpret_cast<unsigned*>(a.qb + o) = wb;
}

template <bool MRQ, typename TX>
cudaError_t launch_quantize(const QArgs& q, cudaStream_t s) {
  const long words = (long)q.M * (q.Kq / 4);
  quantize_kernel<MRQ, TX><<<(unsigned)((words + 255) / 256), 256, 0, s>>>(q);
  return cudaGetLastError();
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

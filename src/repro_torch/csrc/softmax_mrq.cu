// Row softmax straight to region-signed MRQ probability codes for Hopper
// (sm_90a): kernel B10a, its per-row-group sibling B10b, and B12, the same
// row pass with a dequantising epilogue.
//
// Replaces the Pallas kernels repro/kernels/softmax_mrq.py::
// softmax_mrq_codes (B10a), ::softmax_mrq_codes_vec (B10b) and
// ::softmax_mrq (B12). Per row x of C scores (f32 or bf16, widened to f32):
//
//   m = max(x);  e = expf(x - m);  l = rowsum(e);  p = e / l
//   code = p < half * s1[g] ? clip(rint(p / s1[g]), 0, half-1)     region 1
//                           : -clip(rint(p / s2), 0, half)         region 2
//   with s2 = 1/half; int8 out, same shape as the scores.
//   B12 writes the dequantised value instead, in f32 or bf16:
//   p < half * s1 ? clip(rint(p / s1), 0, half-1) * s1
//                 : clip(rint(p / s2), 0, half) * s2     (s1 one scalar)
//
// B10b: row r reads its group at g[(r / rpg) * gs] (gs = 1; B10a passes
// gs = 0 and reads g[0]): one entry per rpg consecutive rows, so the
// composed attention hands the (B*H,) slot vector over the Sq rows of
// each batch*head row and no per-row vector is built on the host. Every
// entry is clamped into [0, G) on the device (group_at).
//
// What bounds it on the card: bytes. At DiT-XL/2 (32,768 rows of C = 256)
// it reads 33.5 MB of f32 scores and writes 8.4 MB of codes (B12: 33.5 MB
// of f32 or 16.8 MB of bf16 values); the
// exp and two IEEE divides per score are far below the CUDA cores' rate.
// Design: one warp per row (8 rows per 256-thread block), three passes
// over the row (max, sum, codes; the second and third reads hit L1), lane
// t owning columns t, t + 32, ...: coalesced loads and byte stores, no
// shared memory.
//
// The row sum's order is fixed, and the plain version replays it
// (repro_torch/kernels/ref.py::warp_rowsum): lane t adds its columns in
// ascending order starting from 0, then five butterfly shuffles (xor 16,
// 8, 4, 2, 1) add the lanes' partials; float addition commutes, so every
// lane ends with the same sum. Exactness: expf (not __expf), __fsub_rn,
// __fdiv_rn, __fmul_rn, rintf (half to even), -fmad=false: each code
// equals the plain version's bit for bit.
#include "common.cuh"

namespace {

constexpr int ROWS = 8;               // warps (rows) per block

// OUT: 0 region-signed int8 codes (B10a, B10b); 1 dequantised f32, 2
// dequantised bf16 (B12).
template <typename TX, int OUT>
__global__ void __launch_bounds__(ROWS * 32) softmax_codes_kernel(
    const TX* __restrict__ x, const float* __restrict__ s1, const int* g,
    void* __restrict__ out, long R, int C, int rpg, int gs, int G, int half) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= R) return;
  const TX* xr = x + row * C;
  const float s1g = s1[group_at(g, row / rpg, gs, G)];
  const float fhalf = (float)half, hi = fhalf - 1.f;
  const float s2 = 1.0f / fhalf;                  // exact: half is 2^k
  const float thr = __fmul_rn(fhalf, s1g);

  float m = __int_as_float((int)0xff800000);   // -inf
  for (int j = lane; j < C; j += 32) m = fmaxf(m, ldx(xr, j));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  float l = 0.f;
  for (int j = lane; j < C; j += 32) l = __fadd_rn(l, expf(__fsub_rn(ldx(xr, j), m)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));

  for (int j = lane; j < C; j += 32) {
    const float p = __fdiv_rn(expf(__fsub_rn(ldx(xr, j), m)), l);
    if (OUT == 0) {
      int c;
      if (p < thr) c = (int)fminf(fmaxf(rintf(__fdiv_rn(p, s1g)), 0.f), hi);
      else c = -(int)fminf(fmaxf(rintf(__fdiv_rn(p, s2)), 0.f), fhalf);
      static_cast<int8_t*>(out)[row * C + j] = (int8_t)c;
    } else {
      const float y = p < thr
          ? __fmul_rn(fminf(fmaxf(rintf(__fdiv_rn(p, s1g)), 0.f), hi), s1g)
          : __fmul_rn(fminf(fmaxf(rintf(__fdiv_rn(p, s2)), 0.f), fhalf), s2);
      if (OUT == 1) static_cast<float*>(out)[row * C + j] = y;
      else static_cast<__nv_bfloat16*>(out)[row * C + j] = __float2bfloat16_rn(y);
    }
  }
}

template <typename TX, int OUT>
cudaError_t launch(const void* x, const float* s1, const int* g, void* out,
                   long R, int C, int rpg, int gs, int G, int half,
                   cudaStream_t s) {
  const long blocks = (R + ROWS - 1) / ROWS;
  softmax_codes_kernel<TX, OUT><<<(unsigned)blocks, ROWS * 32, 0, s>>>(
      static_cast<const TX*>(x), s1, g, out, R, C, rpg, gs, G, half);
  return cudaGetLastError();
}

template <int OUT>
cudaError_t launch_x(const void* x, int x_bf16, const float* s1, const int* g,
                     void* out, long R, int C, int rpg, int gs, int G,
                     int half, cudaStream_t s) {
  return x_bf16
      ? launch<__nv_bfloat16, OUT>(x, s1, g, out, R, C, rpg, gs, G, half, s)
      : launch<float, OUT>(x, s1, g, out, R, C, rpg, gs, G, half, s);
}

bool bad_rows(long R, int C) {
  return R <= 0 || C <= 0 || (R + ROWS - 1) / ROWS > 0x7fffffffL;
}

}  // namespace

// scores: (R, C) f32 (x_bf16 = 0) or bf16; out: (R, C) int8. g: device
// int32 group (gs = 0) or vector of R / rpg entries (gs = 1).
extern "C" int softmax_mrq_codes_launch(
    const void* scores, const void* s1, const void* g, void* out, long R,
    int C, int rpg, int half, int x_bf16, int gs, int G, void* stream) {
  if (bad_rows(R, C) || rpg <= 0 || (gs != 0 && gs != 1) || G <= 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_x<0>(scores, x_bf16, static_cast<const float*>(s1),
                          static_cast<const int*>(g), out, R, C, rpg, gs, G,
                          half, static_cast<cudaStream_t>(stream));
}

// B12: scores (R, C) f32 or bf16; s1: one device f32; g: a device int32
// 0; out: (R, C) f32 (out_bf16 = 0) or bf16.
extern "C" int softmax_mrq_launch(
    const void* scores, const void* s1, const void* g, void* out, long R,
    int C, int half, int x_bf16, int out_bf16, void* stream) {
  if (bad_rows(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s1p = static_cast<const float*>(s1);
  const int* gp = static_cast<const int*>(g);
  return (int)(out_bf16
      ? launch_x<2>(scores, x_bf16, s1p, gp, out, R, C, 1, 0, 1, half, s)
      : launch_x<1>(scores, x_bf16, s1p, gp, out, R, C, 1, 0, 1, half, s));
}

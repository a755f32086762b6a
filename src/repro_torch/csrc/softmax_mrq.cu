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
// A row holding a NaN or a +inf, or only -inf, has a NaN row sum, as in
// the reference (whose max keeps the NaN) and the plain version: every p
// of the row is NaN there, so its codes are 0 (clip keeps the NaN, the
// int8 cast makes it 0) and B12's values NaN. The kernel codes such a row
// as e = 0 over l = 1 (code 0) and multiplies B12's codes by a NaN step.
//
// B10b: row r reads its group at g[(r / rpg) * gs] (gs = 1; B10a passes
// gs = 0 and reads g[0]): one entry per rpg consecutive rows, so the
// composed attention hands the (B*H,) slot vector over the Sq rows of
// each batch*head row and no per-row vector is built on the host (r / rpg
// a shift where rpg is a power of two, as Sq = 256 at serving). Every
// entry is clamped into [0, G) on the device (group_at).
//
// What bounds it on the card: bytes. At DiT-XL/2 (32,768 rows of C = 256)
// it reads 33.5 MB of f32 scores and writes 8.4 MB of codes (B12: 33.5 MB
// of f32 or 16.8 MB of bf16 values): 12.5 us at 3.35 TB/s. The
// instructions come next (an accurate expf, two corrected quotients and
// the row's reductions, about 30 a score): with the score loads switched
// off the pass takes 8.6 us on an H100, and loads and arithmetic overlap
// only in part, 16.2 us a call (launch/attn_times.py --composed
// [--ablate]).
//
// Design:
// - One warp per row, 8 rows (warps) per 256-thread block; lane t owns
//   columns t, t + 32, ...: a warp's load instruction reads 128 contiguous
//   bytes of f32 scores.
// - Rows of C = 32 * CPL (CPL = 1, 2, 4, 8, 16, 32; serving: C = 256, 8 a
//   lane) are read once into CPL registers a lane, and e = expf(x - m) is
//   computed once and kept there from the row sum to the codes. Every
//   other C (ragged rows, C below 32), or an output not 16-byte aligned,
//   runs the general instantiation (CPL = 0): three passes over the row
//   (max, sum, codes; the later reads hit L1), one element stored per
//   column. The register instantiations hold none of its code.
// - Quotients as in flash attention (common.cuh::mrq_code): p = e / l and
//   p / s1 from one reciprocal a row each and two FMA corrections, p / s2
//   as p * half (exact); then rint by the 1.5 x 2^23 add and the top clip.
// - Stores (register instantiations): each warp stages its row's codes
//   (B12: values) in shared memory at their columns, then writes the row
//   16 bytes a lane at a time (8 bytes at C = 256 codes): one store
//   instruction a lane where there was one a column.
//
// The row sum's order is fixed, and the plain version replays it
// (repro_torch/kernels/ref.py::warp_rowsum): lane t adds its columns in
// ascending order starting from 0, then five butterfly shuffles (xor 16,
// 8, 4, 2, 1) add the lanes' partials; float addition commutes, so every
// lane ends with the same sum. Exactness: expf (not __expf), __fsub_rn,
// __fadd_rn, __fmul_rn, div_rn's correctly rounded quotients, rint half to
// even, -fmad=false: each code equals the plain version's bit for bit, for
// every s1 of at least 2^-100 and for s1 <= 0 or NaN (region 1 then never
// holds). The quotient by s1 reads s1 clamped into [2^-100, 2^100]: above
// 2^100 every region-1 code is 0 either way (p <= 1); a step below 2^-100
// (a calibrated one is at least 1/(8 half^2)) codes against 2^-100.
#include "common.cuh"

namespace {

constexpr int ROWS = 8;               // warps (rows) per block
constexpr float S1_MIN = 0x1p-100f, S1_MAX = 0x1p100f;

struct Args {
  const void* x;                      // (R, C) f32 or bf16 scores
  const float* s1;                    // (G,) region-1 steps
  const int* g;                       // group of row r: g[(r / rpg) * gs]
  void* out;                          // (R, C) int8 codes, f32 or bf16 values
  long R;
  int C, rpg, gs, G, half;
  int rpg_shift;                      // log2(rpg) where rpg is 2^k, else -1
};

// OUT: 0 region-signed int8 codes (B10a, B10b); 1 dequantised f32, 2
// dequantised bf16 (B12).
template <int OUT> struct Out;
template <> struct Out<0> { using T = int8_t; };
template <> struct Out<1> { using T = float; };
template <> struct Out<2> { using T = __nv_bfloat16; };

template <int W> struct Bytes;        // W bytes as one load or store
template <> struct Bytes<1> { using T = uint8_t; };
template <> struct Bytes<2> { using T = uint16_t; };
template <> struct Bytes<4> { using T = unsigned; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<16> { using T = uint4; };

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ float warp_sum(float l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));
  return l;
}

// A row's constants once its sum l is known. bad: a NaN row sum.
struct Row {
  float l, yl, s1q, y1, thr, fhalf, d1, d2;
  int half;
  bool bad;
};

__device__ __forceinline__ Row row_consts(const Args& a, long row, float l) {
  Row r;
  const long gi = a.gs == 0 ? 0
                  : a.rpg_shift >= 0 ? row >> a.rpg_shift : row / a.rpg;
  const float s1 = a.s1[group_at(a.g, gi, a.gs, a.G)];
  const float qnan = __int_as_float(0x7fffffff);
  r.bad = !(l == l);
  r.l = r.bad ? 1.f : l;
  r.yl = __frcp_rn(r.l);
  r.half = a.half;
  r.fhalf = (float)a.half;
  r.thr = __fmul_rn(r.fhalf, s1);
  r.s1q = fminf(fmaxf(s1, S1_MIN), S1_MAX);
  r.y1 = __frcp_rn(r.s1q);
  r.d1 = r.bad ? qnan : s1;
  r.d2 = r.bad ? qnan : 1.0f / r.fhalf;          // exact: half is 2^k
  return r;
}

// The output element of score e = expf(x - m) (0 in a bad row): its
// region-signed code, or its dequantised value.
template <int OUT>
__device__ __forceinline__ typename Out<OUT>::T element(float e, const Row& r) {
  bool r1;
  const int c = mrq_code(r.bad ? 0.f : e, r.l, r.yl, r.s1q, r.y1, r.thr,
                         r.fhalf, r.half, r1);
  if constexpr (OUT == 0) {
    return (int8_t)(r1 ? c : -c);
  } else {
    const float y = __fmul_rn((float)c, r1 ? r.d1 : r.d2);
    if constexpr (OUT == 1) return y;
    else return __float2bfloat16_rn(y);
  }
}

// CPL: columns per lane of a register instantiation (C = 32 * CPL), 0 the
// general one (any C).
template <typename TX, int OUT, int CPL>
__global__ void __launch_bounds__(ROWS * 32) softmax_codes_kernel(const Args a) {
  using TO = typename Out<OUT>::T;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long row = (long)blockIdx.x * ROWS + w;
  const float neg_inf = __int_as_float((int)0xff800000);
  if constexpr (CPL == 0) {
    if (row >= a.R) return;
    const int C = a.C;
    const TX* xr = static_cast<const TX*>(a.x) + row * C;
    float m = neg_inf;
    for (int j = lane; j < C; j += 32) m = fmaxf(m, ldx(xr, j));
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < C; j += 32) l = __fadd_rn(l, expf(__fsub_rn(ldx(xr, j), m)));
    const Row r = row_consts(a, row, warp_sum(l));
    TO* o = static_cast<TO*>(a.out) + row * C;
    for (int j = lane; j < C; j += 32)
      o[j] = element<OUT>(expf(__fsub_rn(ldx(xr, j), m)), r);
  } else {
    constexpr int C = 32 * CPL;
    constexpr int LB = CPL * (int)sizeof(TO);     // output bytes a lane
    constexpr int W = LB < 16 ? LB : 16;          // bytes a store
    __shared__ __align__(16) uint8_t stage_bytes[ROWS][C * sizeof(TO)];
    TO* stage = reinterpret_cast<TO*>(stage_bytes[w]);
    if (row >= a.R) return;
    const TX* xr = static_cast<const TX*>(a.x) + row * C;
    float e[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) e[j] = ldx(xr, lane + 32 * j);
    float m = neg_inf;
#pragma unroll
    for (int j = 0; j < CPL; ++j) m = fmaxf(m, e[j]);
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      e[j] = expf(__fsub_rn(e[j], m));
      l = __fadd_rn(l, e[j]);
    }
    const Row r = row_consts(a, row, warp_sum(l));
#pragma unroll
    for (int j = 0; j < CPL; ++j) stage[lane + 32 * j] = element<OUT>(e[j], r);
    __syncwarp();
    using V = typename Bytes<W>::T;
    const V* src = reinterpret_cast<const V*>(stage);
    V* dst = reinterpret_cast<V*>(static_cast<TO*>(a.out) + row * C);
#pragma unroll
    for (int i = 0; i < LB / W; ++i) dst[lane + 32 * i] = src[lane + 32 * i];
  }
}

template <typename TX, int OUT, int CPL>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const long blocks = (a.R + ROWS - 1) / ROWS;
  softmax_codes_kernel<TX, OUT, CPL><<<(unsigned)blocks, ROWS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// The register instantiation for C = 32 * CPL and a 16-byte aligned
// output, else the general one.
template <typename TX, int OUT>
cudaError_t launch_c(const Args& a, cudaStream_t s) {
  if ((uintptr_t)a.out % 16 == 0) {
    switch (a.C) {
      case 32: return launch<TX, OUT, 1>(a, s);
      case 64: return launch<TX, OUT, 2>(a, s);
      case 128: return launch<TX, OUT, 4>(a, s);
      case 256: return launch<TX, OUT, 8>(a, s);
      case 512: return launch<TX, OUT, 16>(a, s);
      case 1024: return launch<TX, OUT, 32>(a, s);
    }
  }
  return launch<TX, OUT, 0>(a, s);
}

template <int OUT>
cudaError_t launch_x(const Args& a, int x_bf16, cudaStream_t s) {
  return x_bf16 ? launch_c<__nv_bfloat16, OUT>(a, s) : launch_c<float, OUT>(a, s);
}

bool bad_rows(long R, int C) {
  return R <= 0 || C <= 0 || (R + ROWS - 1) / ROWS > 0x7fffffffL;
}

int log2_or_neg(int n) {                // k where n == 2^k, else -1
  return n > 0 && (n & (n - 1)) == 0 ? __builtin_ctz(n) : -1;
}

}  // namespace

// scores: (R, C) f32 (x_bf16 = 0) or bf16; out: (R, C) int8. g: device
// int32 group (gs = 0) or vector of R / rpg entries (gs = 1).
extern "C" int softmax_mrq_codes_launch(
    const void* scores, const void* s1, const void* g, void* out, long R,
    int C, int rpg, int half, int x_bf16, int gs, int G, void* stream) {
  if (bad_rows(R, C) || rpg <= 0 || (gs != 0 && gs != 1) || G <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{scores, static_cast<const float*>(s1),
               static_cast<const int*>(g), out, R, C, rpg, gs, G, half,
               log2_or_neg(rpg)};
  return (int)launch_x<0>(a, x_bf16, static_cast<cudaStream_t>(stream));
}

// B12: scores (R, C) f32 or bf16; s1: one device f32; g: a device int32
// 0; out: (R, C) f32 (out_bf16 = 0) or bf16.
extern "C" int softmax_mrq_launch(
    const void* scores, const void* s1, const void* g, void* out, long R,
    int C, int half, int x_bf16, int out_bf16, void* stream) {
  if (bad_rows(R, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{scores, static_cast<const float*>(s1),
               static_cast<const int*>(g), out, R, C, 1, 0, 1, half, 0};
  return (int)(out_bf16 ? launch_x<2>(a, x_bf16, s) : launch_x<1>(a, x_bf16, s));
}

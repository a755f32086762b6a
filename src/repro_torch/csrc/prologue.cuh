// The activation prologue pass of the fused linears: one launch before
// each GEMM of csrc/int8_fused.cu (B1, B2, B6a, B6b) and
// csrc/int4_packed.cu (B4, B5, B7a, B7b) that runs the layernorm row
// statistics (with norm_mod), normalise -> adaLN modulate -> channel-
// balance divide, and the affine or MRQ activation codes.
//
// Replaces the prologue of the Pallas kernels repro/kernels/int8_fused.py::
// int8_matmul_fq (and their MRQ, packed-int4 and _vec siblings), and the
// layernorm statistics that ::_prep_fusions computes in jnp beside their
// pallas_call.
//
// Output: (M, Kq) int8 code planes, the layout both GEMMs' tensor maps
// read (MRQ: two, one per sign region). Code column c holds x column
// kk = (c / gkp) * gk + c % gkp: K is cut into groups of gk columns and
// each group is zero-padded to gkp code columns, so a GEMM k tile never
// straddles two groups (the int4 family's per-K-group scales). The int8
// family passes gk = gkp = Kq: one group, c = kk. Columns past K and the
// padding of each group get code 0.
//
// Prologue (optional):  x' = ((x - mu) * rsig) * (1 + sc[b]) + sh[b], / ps
//   mu = sum(x) / K, rsig = 1 / sqrt(sum((x - mu)^2) / K + 1e-6), b = bv[row]
// Affine:  c = clip(rint(x'/s_a[g]) + s_b[g] - half, -half, half-1).
// MRQ:     region a (x' < 0): clip(rint(x'/s_a[g]), -half, 0);
//          region b (x' >= 0): clip(rint(x'/s_b[g]), 0, half-1).
// with g = group_at(g, row, gs, G).
//
// What bounds it on the card: bytes. x is read once and the code planes
// written once: qkv, fc1 and final (2048 x 1152, bf16 x, with the
// statistics) 7.1 MB, 2.1 us at 3.35 TB/s; fc2 (2048 x 4608, two planes)
// 37.7 MB, 11.3 us; the 8-row calls are launch-bound.
//
// Design:
// - Chunks of 16 code columns, one 16-byte store per code plane. gkp is a
//   multiple of 16 (the int8 family pads K to 16 bytes for TMA, the int4
//   family each group to its 128-deep k tile), so a chunk lies in one K
//   group: its group and first x column are computed once per chunk
//   (chunk_src), and its x columns are read by two 16-byte loads where
//   the chunk is whole and aligned (an element path at ragged edges).
// - Without norm_mod (prologue_chunks_kernel): one thread per chunk.
// - With norm_mod (prologue_rows_kernel): one warp per row. Lane l reads
//   the x chunks l, l + 32, ... (16 columns each; up to RC of them in
//   registers, K <= 1536 where the code map is the identity, gk == gkp)
//   and sums them in that order from 0, each chunk's columns in order;
//   five butterfly shuffles p + p[lane ^ o], o = 16 .. 1, add the lanes'
//   partials (ref.chunk_rowsum replays this order). The squared
//   deviations are summed the same way; the divides by K and 1 / sqrt
//   are correctly rounded (not rsqrtf). Normalise, modulate and quantize
//   then run from the same registers. A row that does not fit (or
//   another map) reads x again for each of its three passes (L1/L2).
//   (Lane steps of 4 columns, 36 values a lane at d = 1152 and no idle
//   lanes, measured slower: 10.8 against 7.9 us at qkv.)
// - The modulation rows are read in their own dtype (bf16 or f32) at
//   their row stride: the chunk views of the adaLN output, no copy.
// - Quotients x' / s by rint_div (csrc/common.cuh): a * (1/s) with a
//   Newton and a Markstein FMA step, correctly rounded below 2^17, and
//   rint by the 1.5 x 2^23 add; a quotient of 2^16 or more saturates the
//   code either way. The ps divide keeps __fdiv_rn: its unbounded result
//   feeds further arithmetic.
//
// Exactness: each step rounds once (__f*_rn; built with -fmad=false, the
// only FMAs are div_rn's explicit ones), in the reference's op order:
// bit for bit against the plain version (kernels/ref.py::
// fused_prologue_ref with layernorm_stats, which replays the statistics'
// order), non-finite inputs included.
#pragma once

#include "hopper.cuh"

namespace {

constexpr int QC = 16;              // code columns per chunk
constexpr int RC = 3;               // x chunks per lane held in registers
constexpr int ROWS_PER_CTA = 4;     // rows kernel: one warp per row
constexpr int CHUNK_THREADS = 256;  // chunks kernel: one thread per chunk
constexpr float LN_EPS = 1e-6f;

struct PArgs {
  const void* x;                    // (M, K) f32 or bf16, contiguous
  const float* s_a; const float* s_b;  // (G,) steps: affine s and zero
                                       // point, MRQ s_neg and s_pos
  const int* g;                     // the group: g[row * gs]
  const float* ps;                  // (K,) channel-balance divisors, or null
  const int* bv;                    // (M,) row -> batch (norm_mod)
  const void* sh; const void* sc;   // (B, K) modulation rows, or null
  long sh_rs, sc_rs;                // ... their row strides (elements)
  int8_t* qa; int8_t* qb;           // (M, Kq) code planes (qb: MRQ)
  int M, K, Kq, half;
  int gk, gkp;                      // see the header comment
  int gs;                           // group stride: 0 or 1
  int G;                            // groups in s_a, s_b
  int xvec;                         // x rows 16-byte aligned
  int mvec;                         // modulation rows 16-byte aligned
  int pvec;                         // ps 16-byte aligned
};

// Code chunk j of a row: its first x column k0 and how many of its QC
// code columns are real, n (n <= 0: all padding).
__device__ __forceinline__ void chunk_src(const PArgs& a, int j, int& k0,
                                          int& n) {
  const int c = j * QC, grp = c / a.gkp, cg = c - grp * a.gkp;
  k0 = grp * a.gk + cg;
  n = min(min(QC, a.gk - cg), a.K - k0);
}

// QC elements from p as f32, 0 from the n-th on: two 16-byte loads where
// all QC are real and vec (p 16-byte aligned), else one at a time.
template <typename T>
__device__ __forceinline__ void load16(const T* p, int n, bool vec,
                                       float (&v)[QC]) {
  if (vec && n == QC) {
    load8(p, *reinterpret_cast<float(*)[8]>(&v[0]));
    load8(p + 8, *reinterpret_cast<float(*)[8]>(&v[8]));
    return;
  }
#pragma unroll
  for (int i = 0; i < QC; ++i) v[i] = i < n ? ldx(p, i) : 0.f;
}

// The warp's sum of one value per lane, in ref.warp_rowsum's order.
__device__ __forceinline__ float warp_sum(float p) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, o));
  return p;
}

// rsig from the warp's sum of squared deviations.
__device__ __forceinline__ float rsig_of(float s2, int K) {
  return __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(s2, (float)K),
                                             LN_EPS)));
}

// v <- ((v - mu) * rs) * (1 + sc[b]) + sh[b] over the chunk at x column k0.
template <typename TM>
__device__ __forceinline__ void modulate(const PArgs& a, int b, int k0,
                                         int n, float mu, float rs,
                                         float (&v)[QC]) {
  float sh[QC], sc[QC];
  const bool vec = a.mvec && (k0 * (int)sizeof(TM)) % 16 == 0;
  load16(static_cast<const TM*>(a.sh) + b * a.sh_rs + k0, n, vec, sh);
  load16(static_cast<const TM*>(a.sc) + b * a.sc_rs + k0, n, vec, sc);
#pragma unroll
  for (int i = 0; i < QC; ++i)
    v[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mu), rs),
                               __fadd_rn(1.0f, sc[i])), sh[i]);
}

// v <- v / ps over the chunk at x column k0 (IEEE divides).
__device__ __forceinline__ void divide_ps(const PArgs& a, int k0, int n,
                                          float (&v)[QC]) {
  float p[QC];
  load16(a.ps + k0, n, a.pvec && k0 % 4 == 0, p);
#pragma unroll
  for (int i = 0; i < QC; ++i) v[i] = __fdiv_rn(v[i], p[i]);
}

// The codes of one chunk of prologue values v (its first n columns real,
// the rest code 0) into the code planes at byte offset o. sa, sb: the
// row's group's steps (affine: sb is the zero point); ya, yb: 1/sa, 1/sb.
template <bool MRQ>
__device__ __forceinline__ void store_codes(const PArgs& a, long o,
                                            const float (&v)[QC], int n,
                                            float sa, float ya, float sb,
                                            float yb) {
  const float fhalf = (float)a.half;
  int ca[QC], cb[QC];
#pragma unroll
  for (int i = 0; i < QC; ++i) {
    ca[i] = cb[i] = 0;
    if (!MRQ) {
      // a NaN codes to 0: the clip keeps it, as the reference's does, and
      // the int conversion makes it 0, as the reference's int8 cast
      const float q = __fsub_rn(__fadd_rn(rint_div(v[i], sa, ya), sb), fhalf);
      if (i < n) ca[i] = (int)fmin_nan(fmax_nan(q, -fhalf), fhalf - 1.f);
    } else {
      // a NaN takes region b's branch and codes to (0, 0) there
      const bool neg = v[i] < 0.f;
      const float r = rint_div(v[i], neg ? sa : sb, neg ? ya : yb);
      if (i < n && neg) ca[i] = (int)fminf(fmaxf(r, -fhalf), 0.f);
      if (i < n && !neg) cb[i] = (int)fminf(fmaxf(r, 0.f), fhalf - 1.f);
    }
  }
  *reinterpret_cast<uint4*>(a.qa + o) = make_uint4(
      pack4(ca[0], ca[1], ca[2], ca[3]), pack4(ca[4], ca[5], ca[6], ca[7]),
      pack4(ca[8], ca[9], ca[10], ca[11]),
      pack4(ca[12], ca[13], ca[14], ca[15]));
  if (MRQ)
    *reinterpret_cast<uint4*>(a.qb + o) = make_uint4(
        pack4(cb[0], cb[1], cb[2], cb[3]), pack4(cb[4], cb[5], cb[6], cb[7]),
        pack4(cb[8], cb[9], cb[10], cb[11]),
        pack4(cb[12], cb[13], cb[14], cb[15]));
}

// Without norm_mod: one thread per code chunk.
template <bool MRQ, typename TX>
__global__ void __launch_bounds__(CHUNK_THREADS)
prologue_chunks_kernel(const PArgs a) {
  const int nq = a.Kq / QC;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)a.M * nq) return;
  const int row = (int)(i / nq), j = (int)(i - (long)row * nq);
  const int grp = group_at(a.g, row, a.gs, a.G);
  const float sa = a.s_a[grp], sb = a.s_b[grp];
  int k0, n;
  chunk_src(a, j, k0, n);
  float v[QC];
  load16(static_cast<const TX*>(a.x) + (long)row * a.K + k0, n,
         a.xvec && (k0 * (int)sizeof(TX)) % 16 == 0, v);
  if (a.ps) divide_ps(a, k0, n, v);
  store_codes<MRQ>(a, (long)row * a.Kq + j * QC, v, n, sa, __frcp_rn(sa),
                   sb, MRQ ? __frcp_rn(sb) : 0.f);
}

// With norm_mod: one warp per row (see the header comment).
template <bool MRQ, typename TX, typename TM>
__global__ void __launch_bounds__(32 * ROWS_PER_CTA)
prologue_rows_kernel(const PArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_CTA + (threadIdx.x >> 5);
  if (row >= a.M) return;                 // the whole warp: one row
  const TX* xr = static_cast<const TX*>(a.x) + (long)row * a.K;
  const int nq = a.Kq / QC, ns = (a.K + QC - 1) / QC, K = a.K;
  const int grp = group_at(a.g, row, a.gs, a.G), b = a.bv[row];
  const float sa = a.s_a[grp], sb = a.s_b[grp];
  const float ya = __frcp_rn(sa), yb = MRQ ? __frcp_rn(sb) : 0.f;
  const bool vx = a.xvec;                 // chunk starts are 16 columns apart
  if (a.gk == a.gkp && nq <= 32 * RC) {   // -- the row in registers
    float v[RC][QC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int c = lane + 32 * r;
      load16(xr + c * QC, min(QC, K - c * QC), vx, v[r]);
    }
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int i = 0; i < QC; ++i) s = __fadd_rn(s, v[r][i]);
    const float mu = __fdiv_rn(warp_sum(s), (float)K);
    float s2 = 0.f;
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int i = 0; i < QC; ++i) {
        const float d = (lane + 32 * r) * QC + i < K ? __fsub_rn(v[r][i], mu)
                                                     : 0.f;
        s2 = __fadd_rn(s2, __fmul_rn(d, d));
      }
    const float rs = rsig_of(warp_sum(s2), K);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int c = lane + 32 * r, n = min(QC, K - c * QC);
      if (c >= nq) break;
      modulate<TM>(a, b, c * QC, n, mu, rs, v[r]);
      if (a.ps) divide_ps(a, c * QC, n, v[r]);
      store_codes<MRQ>(a, (long)row * a.Kq + c * QC, v[r], n, sa, ya, sb, yb);
    }
    return;
  }
  // -- any width and map: x read once per pass, the same summation order
  float v[QC], s = 0.f;
  for (int c = lane; c < ns; c += 32) {
    load16(xr + c * QC, min(QC, K - c * QC), vx, v);
#pragma unroll
    for (int i = 0; i < QC; ++i) s = __fadd_rn(s, v[i]);
  }
  const float mu = __fdiv_rn(warp_sum(s), (float)K);
  float s2 = 0.f;
  for (int c = lane; c < ns; c += 32) {
    load16(xr + c * QC, min(QC, K - c * QC), vx, v);
#pragma unroll
    for (int i = 0; i < QC; ++i) {
      const float d = c * QC + i < K ? __fsub_rn(v[i], mu) : 0.f;
      s2 = __fadd_rn(s2, __fmul_rn(d, d));
    }
  }
  const float rs = rsig_of(warp_sum(s2), K);
  for (int j = lane; j < nq; j += 32) {
    int k0, n;
    chunk_src(a, j, k0, n);
    load16(xr + k0, n, vx && (k0 * (int)sizeof(TX)) % 16 == 0, v);
    modulate<TM>(a, b, k0, n, mu, rs, v);
    if (a.ps) divide_ps(a, k0, n, v);
    store_codes<MRQ>(a, (long)row * a.Kq + j * QC, v, n, sa, ya, sb, yb);
  }
}

// The pass's arguments; sh/sc null: no norm_mod (bv unused unless set).
PArgs prologue_args(const void* x, const void* s_a, const void* s_b,
                    const void* g, const void* ps, const void* bv,
                    const void* sh, const void* sc, long sh_rs, long sc_rs,
                    void* codes_a, void* codes_b, int M, int K, int Kq,
                    int half, int gk, int gkp, int gs, int G) {
  PArgs p;
  p.x = x; p.s_a = static_cast<const float*>(s_a);
  p.s_b = static_cast<const float*>(s_b); p.g = static_cast<const int*>(g);
  p.ps = static_cast<const float*>(ps); p.bv = static_cast<const int*>(bv);
  p.sh = sh; p.sc = sc; p.sh_rs = sh_rs; p.sc_rs = sc_rs;
  p.qa = static_cast<int8_t*>(codes_a); p.qb = static_cast<int8_t*>(codes_b);
  p.M = M; p.K = K; p.Kq = Kq; p.half = half; p.gk = gk; p.gkp = gkp;
  p.gs = gs; p.G = G; p.xvec = p.mvec = p.pvec = 0;
  return p;
}

template <bool MRQ, typename TX>
cudaError_t launch_rows(const PArgs& p, int nm_bf16, cudaStream_t s) {
  const unsigned grid = (unsigned)((p.M + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
  if (nm_bf16)
    prologue_rows_kernel<MRQ, TX, __nv_bfloat16>
        <<<grid, 32 * ROWS_PER_CTA, 0, s>>>(p);
  else
    prologue_rows_kernel<MRQ, TX, float><<<grid, 32 * ROWS_PER_CTA, 0, s>>>(p);
  return cudaGetLastError();
}

template <bool MRQ, typename TX>
cudaError_t launch_chunks(const PArgs& p, cudaStream_t s) {
  const long n = (long)p.M * (p.Kq / QC);
  prologue_chunks_kernel<MRQ, TX>
      <<<(unsigned)((n + CHUNK_THREADS - 1) / CHUNK_THREADS), CHUNK_THREADS,
         0, s>>>(p);
  return cudaGetLastError();
}

// One launch of the pass: prologue_rows_kernel with norm_mod (p.sh set),
// else prologue_chunks_kernel. Sets the alignment flags from the pointers.
template <bool MRQ>
cudaError_t launch_prologue(PArgs p, int x_bf16, int nm_bf16, cudaStream_t s) {
  if (p.M <= 0 || p.K <= 0 || p.Kq % QC || p.gkp % QC || p.gk <= 0
      || p.gk > p.gkp || (long)p.M * (p.Kq / QC) > 0x7fffffffL * CHUNK_THREADS
      || (p.sh && (!p.sc || !p.bv)))
    return cudaErrorInvalidValue;
  const long esz = x_bf16 ? 2 : 4, msz = nm_bf16 ? 2 : 4;
  p.xvec = aligned16(p.x) && p.K * esz % 16 == 0;
  p.mvec = p.sh && aligned16(p.sh) && aligned16(p.sc)
           && p.sh_rs * msz % 16 == 0 && p.sc_rs * msz % 16 == 0;
  p.pvec = p.ps && aligned16(p.ps);
  if (p.sh)
    return x_bf16 ? launch_rows<MRQ, __nv_bfloat16>(p, nm_bf16, s)
                  : launch_rows<MRQ, float>(p, nm_bf16, s);
  return x_bf16 ? launch_chunks<MRQ, __nv_bfloat16>(p, s)
                : launch_chunks<MRQ, float>(p, s);
}

}  // namespace

// Packed-int4 fused linears for Hopper (sm_90a): kernels B4 and B5, and
// their per-row-group siblings B7a and B7b.
//
// Replaces the Pallas kernels repro/kernels/int4_packed.py::int4_matmul_fq
// (B4), ::int4_matmul_mrq_fq (B5), ::int4_matmul_fq_vec (B7a) and
// ::int4_matmul_mrq_fq_vec (B7b). Weights are signed 4-bit codes, two
// per byte along K, with one scale per (K group of group_k rows, output
// channel); activations are 4-bit codes (half = 8):
//
//   B4: xq = clip(rint(x'/sx[g]) + zx[g] - 8, -8, 7)
//       acc = sum over K groups kg, ascending, in f32:
//             acc + (float)(xq[kg] . w[kg] - corr[g,kg]) * scale[g,kg]
//   B5: qn/qp = B2's sign split at 4 bits;
//       acc + ((float)(qn[kg] . w[kg]) * scale_neg[g,kg]
//              + (float)(qp[kg] . w[kg]) * scale_pos[g,kg])
//   y = acc + bias, then the optional epilogue res + gate[b] * y;
//   prologue (optional) as B1: x' = ((x - mu) * rsig) * (1 + sc[b]) + sh[b],
//   / ps.
//   B7a/B7b (VEC): g = gv[row], a per-row (M,) int32 group vector: the
//   quantize pass reads each row's steps (csrc/common.cuh, gs = 1) and
//   each K-group rescale reads scale[gv[row], kg, col] (and corr) per
//   accumulator element, where B4/B5 read one value per column. Each
//   thread's four rows look their groups up once, before the K loop.
//
// What bounds it on the card: at the DiT-XL/2 serving shapes the s8
// products are compute-bound on the tensor cores (1979 TOP/s int8 dense);
// the nibble weights halve the weight stream of the byte-code family.
//
// Design: B1/B2's two launches (csrc/int8_fused.cu), with two changes.
// 1. quantize_kernel (csrc/common.cuh) writes the activation codes with
//    each K group zero-padded to gkp = group_k rounded up to the 64-deep
//    k tile, so no k tile straddles two scale groups (group_k is any
//    multiple of 8 up to 256: 16 for DiT-XL/2's x_proj, 256 for the
//    rest). A zero code adds nothing, and corr counts only real rows.
// 2. gemm4_kernel streams the weights nibble-packed from device memory:
//    (N, Kq/2) bytes, k-contiguous, each group padded to gkp/2 bytes, and
//    within each 16-byte chunk (32 k codes) the bytes reordered so that
//    thread t's 4-byte word holds k 4t..4t+3 and 16+4t..19+4t: the two
//    B fragments of its s8 mma.sync.m16n8k32 (a byte permutation of the
//    pack's (Kp/2, N), built once per weight by the wrapper; every byte,
//    so the nibble encoding, is the pack's). One 32-bit shared load, two
//    masks and two byte permutes (prmt) widen it to both fragments as
//    16 x code in s8 (the nibble moved to the byte's high half: sign
//    included, no extension step); Hopper's wgmma has no s4 operand.
//    After the last k tile of a group the s32 partials, 16 x the exact
//    products, are shifted back (>> 4, exact), corrected, scaled and
//    added into an f32 accumulator kept in registers, and zeroed for
//    the next group. The k tiles past K in the last group hold only
//    zero codes and are skipped. 8 warps of 32 x 32 (64 x 128 tile):
//    with the f32 accumulator beside the s32 one, 128-row tiles took
//    168 registers and one CTA per SM, and ran 15 % slower at the
//    serving shapes (measured on the H100, PERF.md).
//
// Exactness: the f32 steps are __fsub/__fmul_rn/__fadd_rn in the plain
// version's order, groups ascending, no split-K, built with -fmad=false:
// bit-exact against the plain version (repro_torch/kernels/ref.py).
#include "common.cuh"

namespace {

constexpr int BN = 128, BK = 64, THREADS = 256, STAGES = 3;
constexpr int SROW = BK + 16;       // bytes per code row in smem
constexpr int WROW = BK / 2 + 16;   // bytes per packed weight row in smem

constexpr int MT = 2, BM = 32 * MT;  // 2 warp rows of MT m16 tiles

struct G4Args {
  const int8_t* qa; const int8_t* qb;          // (M, Kq) codes
  const int8_t* wt;                            // (N, Kq/2) packed
  const float* scale_a; const float* scale_b;  // (G, nk, N)
  const int* corr; const float* bias; const int* g;
  const int* bv; const float* gate; const void* res; void* out;
  int M, N, Kq, nk, tpg, ntiles, res_bf16, out_bf16;
  int G;                                       // groups in the stacks
  // tpg: k tiles per group; ntiles: k tiles holding any code of x
};

// A thread's word of packed weights -> its two B fragments (k 4t..4t+3,
// 16+4t..19+4t), each code as 16 x code in one s8 byte.
__device__ __forceinline__ void widen_b(unsigned w, unsigned& b0, unsigned& b1) {
  const unsigned lo = (w << 4) & 0xF0F0F0F0u, hi = w & 0xF0F0F0F0u;
  b0 = __byte_perm(lo, hi, 0x5140);
  b1 = __byte_perm(lo, hi, 0x7362);
}

template <bool MRQ, bool VEC>
__global__ void __launch_bounds__(THREADS) gemm4_kernel(G4Args a) {
  constexpr int R = MRQ ? 2 : 1;
  constexpr int ATILE = BM * SROW, BTILE = BN * WROW;
  constexpr int STAGE = R * ATILE + BTILE;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps, 32 x 32 each
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, Kq = a.Kq, nkt = a.ntiles;
  const int8_t* qsrc[2] = {a.qa, a.qb};

  auto load = [&](int stage, int k0) {
    uint8_t* base = smem + stage * STAGE;
    for (int idx = tid; idx < BM * 4; idx += THREADS) {
      const int r = idx >> 2, ch = (idx & 3) * 16;
      const bool ok = m0 + r < M;
#pragma unroll
      for (int rg = 0; rg < R; ++rg)
        cp_async16(base + rg * ATILE + r * SROW + ch,
                   qsrc[rg] + (long)(ok ? m0 + r : 0) * Kq + k0 + ch, ok);
    }
    {
      const int r = tid >> 1, ch = (tid & 1) * 16;   // 128 rows x 32 bytes
      const bool ok = n0 + r < N;
      cp_async16(base + R * ATILE + r * WROW + ch,
                 a.wt + (long)(ok ? n0 + r : 0) * (Kq / 2) + k0 / 2 + ch, ok);
    }
  };

  int acc[R][MT][4][4];
  float facc[MT][4][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][j][e] = 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[i][j][e] = 0.f;

  // the group of each of this thread's accumulator rows (VEC), or the
  // call's one group
  const int grp = VEC ? 0 : group_at(a.g, 0, 0, a.G);
  int grow[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * MT * 16 + mt * 16 + gid + h * 8;
      grow[mt][h] = VEC ? group_at(a.g, row < M ? row : M - 1, 1, a.G) : grp;
    }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const uint8_t* base = smem + (kt % STAGES) * STAGE;
    const uint8_t* sB = base + R * ATILE;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 32) {
      unsigned bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* p = sB + (wn * 32 + nt * 8 + gid) * WROW + kc / 2 + tig * 4;
        widen_b(*reinterpret_cast<const unsigned*>(p), bf[nt][0], bf[nt][1]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* p = base + r * ATILE
                             + (wm * MT * 16 + mt * 16 + gid) * SROW + kc + tig * 4;
          unsigned af[4];
          af[0] = *reinterpret_cast<const unsigned*>(p);
          af[1] = *reinterpret_cast<const unsigned*>(p + 8 * SROW);
          af[2] = *reinterpret_cast<const unsigned*>(p + 16);
          af[3] = *reinterpret_cast<const unsigned*>(p + 8 * SROW + 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[r][mt][nt], af, bf[nt][0], bf[nt][1]);
        }
      }
    }
    const int nxt = kt + STAGES - 1;
    if (nxt < nkt) load(nxt % STAGES, nxt * BK);
    cp_async_commit();

    if ((kt + 1) % a.tpg == 0 || kt + 1 == nkt) {  // group kg complete
      const int kg = kt / a.tpg;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + wn * 32 + nt * 8 + tig * 2 + c;
          if (col >= N) continue;
          long gc = ((long)grp * a.nk + kg) * N + col;
          float sa = a.scale_a[gc];
          float sb = MRQ ? a.scale_b[gc] : 0.f;
          int cr = MRQ ? 0 : a.corr[gc];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = h * 2 + c;
              if (VEC) {              // this row's group: scale[gv[row], kg, col]
                gc = ((long)grow[mt][h] * a.nk + kg) * N + col;
                sa = a.scale_a[gc];
                sb = MRQ ? a.scale_b[gc] : 0.f;
                cr = MRQ ? 0 : a.corr[gc];
              }
              float t;
              if (!MRQ) {
                t = __fmul_rn((float)((acc[0][mt][nt][e] >> 4) - cr), sa);
              } else {
                t = __fadd_rn(__fmul_rn((float)(acc[0][mt][nt][e] >> 4), sa),
                              __fmul_rn((float)(acc[R - 1][mt][nt][e] >> 4), sb));
              }
              facc[mt][nt][e] = __fadd_rn(facc[mt][nt][e], t);
            }
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][i][j][e] = 0;
    }
  }

  // -- epilogue: + bias (+ gate * y + residual), one write ------------------
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * MT * 16 + mt * 16 + gid + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        float y = __fadd_rn(facc[mt][nt][e], a.bias[col]);
        const long o = (long)row * N + col;
        if (a.gate) {
          const float r = a.res_bf16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.res)[o])
              : static_cast<const float*>(a.res)[o];
          y = __fadd_rn(r, __fmul_rn(a.gate[(long)a.bv[row] * N + col], y));
        }
        if (a.out_bf16) static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y);
        else static_cast<float*>(a.out)[o] = y;
      }
}

template <bool MRQ, bool VEC, typename TX>
cudaError_t run(const QArgs& q, G4Args g, cudaStream_t s) {
  cudaError_t e = launch_quantize<MRQ, TX>(q, s);
  if (e != cudaSuccess) return e;
  constexpr int R = MRQ ? 2 : 1;
  const size_t smem = (size_t)STAGES * (R * BM * SROW + BN * WROW);
  e = cudaFuncSetAttribute(gemm4_kernel<MRQ, VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm4_kernel<MRQ, VEC><<<grid, THREADS, smem, s>>>(g);
  return cudaGetLastError();
}

template <bool MRQ, bool VEC>
cudaError_t run_x(const QArgs& q, const G4Args& g, int x_bf16, cudaStream_t s) {
  return x_bf16 ? run<MRQ, VEC, __nv_bfloat16>(q, g, s) : run<MRQ, VEC, float>(q, g, s);
}

}  // namespace

// wt: the packed weights re-laid out to (N, Kq/2), k-contiguous, each K
// group of gk rows zero-padded to gkp/2 bytes, each 16-byte chunk in the
// fragment order above; Kq = nk * gkp, gkp % 64 == 0.
// codes_a/codes_b: (M, Kq) int8 scratch allocated by the caller.
// g: device int32 group index (gs = 0) or per-row (M,) vector (gs = 1),
// each clamped into [0, G) on the device.
extern "C" int int4_matmul_launch(
    const void* x, const void* wt, const void* s_a, const void* s_b,
    const void* scale_a, const void* scale_b, const void* corr,
    const void* bias, const void* g, const void* ps, const void* bv,
    const void* mu, const void* rsig, const void* sh, const void* sc,
    const void* gate, const void* res, void* out, void* codes_a,
    void* codes_b, int M, int K, int Kq, int N, int gk, int gkp, int nk,
    int x_bf16, int res_bf16, int out_bf16, int mrq, int gs, int G,
    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || gk <= 0 || gk % 2 || gkp < gk
      || gkp % BK || Kq != nk * gkp || nk * gk < K || (nk - 1) * gk >= K
      || (gs != 0 && gs != 1) || G <= 0)
    return (int)cudaErrorInvalidValue;
  QArgs q;
  q.x = x; q.s_a = static_cast<const float*>(s_a); q.s_b = static_cast<const float*>(s_b);
  q.g = static_cast<const int*>(g); q.ps = static_cast<const float*>(ps);
  q.bv = static_cast<const int*>(bv); q.mu = static_cast<const float*>(mu);
  q.rsig = static_cast<const float*>(rsig); q.sh = static_cast<const float*>(sh);
  q.sc = static_cast<const float*>(sc);
  q.qa = static_cast<int8_t*>(codes_a); q.qb = static_cast<int8_t*>(codes_b);
  q.M = M; q.K = K; q.Kq = Kq; q.half = 8; q.gk = gk; q.gkp = gkp; q.gs = gs; q.G = G;
  G4Args a;
  a.qa = q.qa; a.qb = q.qb; a.wt = static_cast<const int8_t*>(wt);
  a.scale_a = static_cast<const float*>(scale_a);
  a.scale_b = static_cast<const float*>(scale_b);
  a.corr = static_cast<const int*>(corr); a.bias = static_cast<const float*>(bias);
  a.g = q.g; a.bv = q.bv; a.gate = static_cast<const float*>(gate);
  a.res = res; a.out = out;
  a.M = M; a.N = N; a.Kq = Kq; a.nk = nk; a.tpg = gkp / BK;
  // code columns up to the last real row of the last group
  a.ntiles = ((nk - 1) * gkp + (K - (nk - 1) * gk) + BK - 1) / BK;
  a.res_bf16 = res_bf16; a.out_bf16 = out_bf16; a.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mrq) e = gs ? run_x<true, true>(q, a, x_bf16, s) : run_x<true, false>(q, a, x_bf16, s);
  else e = gs ? run_x<false, true>(q, a, x_bf16, s) : run_x<false, false>(q, a, x_bf16, s);
  return (int)e;
}

// Fused int8 linears for Hopper (sm_90a): kernels B1 and B2, their
// per-row-group siblings B6a and B6b, and B11 (the GEMM alone, on codes
// quantized by the caller; see int8_gemm_codes_launch at the end).
//
// Replaces the Pallas kernels repro/kernels/int8_fused.py::int8_matmul_fq
// (B1), ::int8_matmul_mrq_fq (B2), ::int8_matmul_fq_vec (B6a) and
// ::int8_matmul_mrq_fq_vec (B6b):
//
//   B1: y = ((clip(rint(x'/sx[g]) + zx[g] - half, -half, half-1) @ wq)
//            - corr[g]) * scale[g] + bias
//   B2: qn = clip(rint(x'/s_neg[g]), -half, 0) where x' < 0, else 0
//       qp = clip(rint(x'/s_pos[g]), 0, half-1) where x' >= 0, else 0
//       y = (qn @ wq) * scale_neg[g] + (qp @ wq) * scale_pos[g] + bias
//   prologue (optional): x' = ((x - mu) * rsig) * (1 + sc[b]) + sh[b], / ps
//   epilogue (optional): y = res + gate[b] * y
//   B6a/B6b: the same with g = gv[row], a per-row (M,) int32 group vector
//   (gs = 1; B1/B2 pass gs = 0 and read gv[0]): each row quantizes with
//   its group's steps and dequantizes with its group's scale (and corr)
//   row, gathered from the full (G, .) stacks. One launch serves a batch
//   whose rows sit at different TGQ groups, and the weights stream once;
//   the per-row read adds one L1-resident int32 load per output element
//   to the epilogue and one per quantized word.
//
// What bounds it on the card: at the DiT-XL/2 serving shapes (M = 2048,
// K, N = 1152..6912) the s8 products are compute-bound on the tensor cores
// (1979 TOP/s int8 dense); the fp prologue (an IEEE divide per activation
// element) and the weight stream are the next costs.
//
// Design: two launches per call.
// 1. quantize_kernel runs the prologue and the quantize ONCE per
//    activation element and writes the codes, K padded to a multiple of
//    64 with zero codes (B2 writes the two disjoint region-code tensors).
//    On the TPU the quantize lived in the matmul's prologue to keep the
//    codes out of HBM; here an M x K byte tensor costs microseconds of
//    bandwidth, whereas redoing the divide once per 128-wide N tile (the
//    fused form, this kernel's first version) cost more than the products.
// 2. gemm_kernel: one CTA per 128 x 128 output tile, 8 warps of 64 x 32,
//    mma.sync.m16n8k32 s8 x s8 -> s32 (exact), fed by a 3-stage cp.async
//    ring of 64-deep k tiles. The weights arrive pre-transposed to (N, Kp)
//    (k-contiguous, the layout the mma's B operand wants; built once per
//    weight by the wrapper). B2 feeds each weight fragment to two
//    accumulators, so the weights stream once. The K loop that the Pallas
//    grid ran in sequence is the loop inside the CTA; the epilogue
//    dequantizes, adds bias, applies gate + residual and writes once.
//
// Exactness: see csrc/common.cuh (quantize_kernel); the epilogue rounds
// each step (__fmul_rn/__fadd_rn) in the reference's op order. The group
// index is read on the device from an int32 pointer (capturable in a CUDA
// graph later). Ragged
// M/N are masked in-kernel (zero-filled loads, guarded stores); padded K
// columns carry zero codes against zero weights, so they add nothing.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256, STAGES = 3;
constexpr int SROW = BK + 16;   // bytes per smem row: conflict-free fragment loads

struct GArgs {          // gemm_kernel
  const int8_t* qa; const int8_t* qb; const int8_t* wt;   // wt: (N, Kp)
  const float* scale_a; const float* scale_b;  // B1: scale     B2: scale_neg, scale_pos
  const int* corr; const float* bias; const int* g;
  const int* bv; const float* gate; const void* res; void* out;
  int M, N, Kp, res_bf16, out_bf16;
  int gs;               // group stride: 0 (B1, B2) or 1 per row (B6a, B6b)
  int G;                // groups in the scale (and corr) stacks
};

template <bool MRQ>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GArgs a) {
  constexpr int R = MRQ ? 2 : 1;
  constexpr int TILE = BM * SROW;               // bytes of one operand tile
  extern __shared__ __align__(16) uint8_t smem[];
  // stage s: A region r at smem + (s*(R+1) + r)*TILE, B at + (s*(R+1) + R)*TILE

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;       // 2 x 4 warps, 64 x 32 each
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, Kp = a.Kp, nk = Kp / BK;
  const int8_t* qsrc[2] = {a.qa, a.qb};

  auto load = [&](int stage, int k0) {
    uint8_t* base = smem + stage * (R + 1) * TILE;
    // 128 rows x 4 chunks of 16 B per operand: 2 chunks per thread
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = tid + c * THREADS, r = idx >> 2, ch = (idx & 3) * 16;
#pragma unroll
      for (int rg = 0; rg < R; ++rg) {
        const bool ok = m0 + r < M;
        const int8_t* src = qsrc[rg] + (long)(ok ? m0 + r : 0) * Kp + k0 + ch;
        cp_async16(base + rg * TILE + r * SROW + ch, src, ok);
      }
      const bool okb = n0 + r < N;
      const int8_t* srcb = a.wt + (long)(okb ? n0 + r : 0) * Kp + k0 + ch;
      cp_async16(base + R * TILE + r * SROW + ch, srcb, okb);
    }
  };

  int acc[R][4][4][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const uint8_t* base = smem + (kt % STAGES) * (R + 1) * TILE;
    const uint8_t* sB = base + R * TILE;
#pragma unroll
    for (int kc = 0; kc < BK; kc += 32) {
      unsigned bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* p = sB + (wn * 32 + nt * 8 + gid) * SROW + kc + tig * 4;
        bf[nt][0] = *reinterpret_cast<const unsigned*>(p);
        bf[nt][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint8_t* p = base + r * TILE + (wm * 64 + mt * 16 + gid) * SROW
                             + kc + tig * 4;
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
    if (nxt < nk) load(nxt % STAGES, nxt * BK);
    cp_async_commit();
  }

  // -- epilogue: dequant (+ bias) (+ gate * y + residual), one write ------
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + mt * 16 + gid + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + tig * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        const long gc = (long)group_at(a.g, row, a.gs, a.G) * N + col;
        float y;
        if (!MRQ) {
          const int v = acc[0][mt][nt][e] - a.corr[gc];
          y = __fadd_rn(__fmul_rn((float)v, a.scale_a[gc]), a.bias[col]);
        } else {
          y = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[0][mt][nt][e], a.scale_a[gc]),
                                  __fmul_rn((float)acc[R - 1][mt][nt][e], a.scale_b[gc])),
                        a.bias[col]);
        }
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

template <bool MRQ>
cudaError_t launch_gemm(const GArgs& g, cudaStream_t s) {
  constexpr int R = MRQ ? 2 : 1;
  const size_t smem = (size_t)STAGES * (R + 1) * BM * SROW;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<MRQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  gemm_kernel<MRQ><<<grid, THREADS, smem, s>>>(g);
  return cudaGetLastError();
}

template <bool MRQ, typename TX>
cudaError_t run(const QArgs& q, const GArgs& g, cudaStream_t s) {
  cudaError_t e = launch_quantize<MRQ, TX>(q, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<MRQ>(g, s);
}

}  // namespace

// codes_a/codes_b: (M, Kp) int8 scratch allocated by the caller; wt: the
// weights transposed to (N, Kp), zero-padded along K; Kp % 64 == 0.
// g: device int32 group index (gs = 0) or per-row (M,) vector (gs = 1),
// each clamped into [0, G) on the device.
extern "C" int int8_matmul_launch(
    const void* x, const void* wt, const void* s_a, const void* s_b,
    const void* scale_a, const void* scale_b, const void* corr,
    const void* bias, const void* g, const void* ps, const void* bv,
    const void* mu, const void* rsig, const void* sh, const void* sc,
    const void* gate, const void* res, void* out, void* codes_a,
    void* codes_b, int M, int K, int Kp, int N, int half, int x_bf16,
    int res_bf16, int out_bf16, int mrq, int gs, int G, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % BK || (gs != 0 && gs != 1)
      || G <= 0)
    return (int)cudaErrorInvalidValue;
  QArgs q;
  q.x = x; q.s_a = static_cast<const float*>(s_a); q.s_b = static_cast<const float*>(s_b);
  q.g = static_cast<const int*>(g); q.ps = static_cast<const float*>(ps);
  q.bv = static_cast<const int*>(bv); q.mu = static_cast<const float*>(mu);
  q.rsig = static_cast<const float*>(rsig); q.sh = static_cast<const float*>(sh);
  q.sc = static_cast<const float*>(sc);
  q.qa = static_cast<int8_t*>(codes_a); q.qb = static_cast<int8_t*>(codes_b);
  q.M = M; q.K = K; q.Kq = Kp; q.half = half; q.gk = Kp; q.gkp = Kp; q.gs = gs; q.G = G;
  GArgs a;
  a.qa = q.qa; a.qb = q.qb; a.wt = static_cast<const int8_t*>(wt);
  a.scale_a = static_cast<const float*>(scale_a);
  a.scale_b = static_cast<const float*>(scale_b);
  a.corr = static_cast<const int*>(corr); a.bias = static_cast<const float*>(bias);
  a.g = q.g; a.bv = q.bv; a.gate = static_cast<const float*>(gate);
  a.res = res; a.out = out;
  a.M = M; a.N = N; a.Kp = Kp; a.res_bf16 = res_bf16; a.out_bf16 = out_bf16;
  a.gs = gs; a.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mrq) e = x_bf16 ? run<true, __nv_bfloat16>(q, a, s) : run<true, float>(q, a, s);
  else e = x_bf16 ? run<false, __nv_bfloat16>(q, a, s) : run<false, float>(q, a, s);
  return (int)e;
}

// B11 (repro/kernels/int8_matmul.py::int8_matmul): the caller's codes,
// quantized beforehand, through gemm_kernel<false> with one group and no
// quantize pass: y = (xq @ wq - corr) * scale + bias, B1's epilogue.
// xq: (M, Kp) int8, zero-padded along K; wt: the weights as (N, Kp);
// scale, bias: (N,) f32; corr: (N,) int32; g: a device int32 0.
extern "C" int int8_gemm_codes_launch(
    const void* xq, const void* wt, const void* scale, const void* corr,
    const void* bias, const void* g, void* out, int M, int Kp, int N,
    int out_bf16, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % BK) return (int)cudaErrorInvalidValue;
  GArgs a = {};
  a.qa = a.qb = static_cast<const int8_t*>(xq);
  a.wt = static_cast<const int8_t*>(wt);
  a.scale_a = a.scale_b = static_cast<const float*>(scale);
  a.corr = static_cast<const int*>(corr); a.bias = static_cast<const float*>(bias);
  a.g = static_cast<const int*>(g); a.out = out;
  a.M = M; a.N = N; a.Kp = Kp; a.out_bf16 = out_bf16; a.gs = 0; a.G = 1;
  return (int)launch_gemm<false>(a, static_cast<cudaStream_t>(stream));
}

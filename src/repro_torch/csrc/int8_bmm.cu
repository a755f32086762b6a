// Batched int8 matmuls of the composed attention chain for Hopper
// (sm_90a): kernels B9a (QK^T) and B9b (dual-region P.V), and their
// per-batch-row-group siblings B9c and B9d.
//
// Replaces the Pallas kernels repro/kernels/int8_bmm.py::int8_bmm_qk
// (B9a), ::int8_bmm_pv (B9b), ::int8_bmm_qk_vec (B9c) and
// ::int8_bmm_pv_vec (B9d):
//
//   B9a: scores[b] = (q8[b] . k8[b/rep]^T) * scale[g]       f32 (or bf16)
//        q8, k8 = clip(rint(x / s_{q,k}[g]), -(h-1), h-1)   SymQ codes
//   B9b: c1 = max(c, 0), c2 = max(-c, 0)       region-signed prob codes c
//        out[b] = (c1 . v8) * scale1[g] + (c2 . v8) * scale2[g]
//        v8 = clip(rint(v / s_v[g]), -(h-1), h-1)
//   B9c/B9d: the same with g = g[b], a per-batch-row (B,) int32 vector
//        (gs = 1; B9a/B9b pass gs = 0 and read g[0]). As in B8, the kv
//        codes then depend on the q row's group, so the caller passes
//        rep = 1 (the wrapper repeats k or v over a GQA group first).
//
// What bounds them on the card: at DiT-XL/2 (B*H = 128, S = 256, hd 72)
// the products are small (2 * 128 * 256^2 * 72 int8 ops each, ~0.6 us at
// the tensor cores' peak); the bytes are not: B9a writes 33.5 MB of f32
// scores and B9b reads 8.4 MB of codes, which is why the composed chain
// is the exactness oracle and flash (B3) the default.
//
// Design: q, k and v are coded once per element by codes_kernel
// (csrc/common.cuh: padded to the 32-deep s8 mma along the head dim,
// hd 72 -> 96, v transposed to (DN, Np) so the P.V B operand is
// kv-contiguous); then
// - qk_kernel: one CTA of 4 warps per 64 query rows x 128 kv columns of
//   one batch row, the q and k code tiles in shared memory, each warp
//   16 x 128 scores from mma.sync m16n8k32 s8 x s8 -> s32 (exact),
//   dequantised with one __fmul_rn and written once;
// - pv_kernel: one CTA of 4 warps per 64 query rows of one batch row,
//   looping over 128-wide kv tiles. Each code word is split by sign as it
//   is staged into shared memory (__vmaxs4 for region 1, the bytewise
//   negated __vmins4 for region 2: region-2 magnitudes reach half = 128,
//   so both tiles are u8 and the product is mma .u8.s8); each v tile is
//   read once and feeds both s32 accumulators, which stay exact across
//   the whole kv loop; the epilogue rounds each step in the reference's
//   order, __fadd_rn(__fmul_rn(acc1, scale1), __fmul_rn(acc2, scale2)),
//   and writes once.
//
// Exactness: rintf (half to even), __fdiv_rn, __fmul_rn/__fadd_rn,
// -fmad=false; integer products are exact, so each kernel equals its plain
// version bit for bit.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 128, WARPS = 4;
constexpr int PROW = BN + 16;         // bytes per kv-major code row

struct QKArgs {
  const int8_t *q8, *k8;              // (B, Mp, DQ), (Bk, Np, DQ)
  const float* scale; const int* g;   // batch b's scale: scale[g[b * gs]]
  int gs, G;
  void* out;                          // (B, M, N) f32 or bf16
  int M, N, Mp, Np, rep, out_bf16;
};

// NKC: 32-deep chunks of the padded head dim.
template <int NKC>
__global__ void __launch_bounds__(WARPS * 32) qk_kernel(QKArgs a) {
  constexpr int DQ = NKC * 32, QROW = DQ + 16;
  __shared__ __align__(16) uint8_t sQ[BM * QROW];
  __shared__ __align__(16) uint8_t sK[BN * QROW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, b = blockIdx.z;
  const int8_t* q8 = a.q8 + ((long)b * a.Mp + m0) * DQ;
  const int8_t* k8 = a.k8 + ((long)(b / a.rep) * a.Np + n0) * DQ;
  for (int i = tid; i < BM * (DQ / 16); i += WARPS * 32) {
    const int r = i / (DQ / 16), c = (i % (DQ / 16)) * 16;
    cp_async16(sQ + r * QROW + c, q8 + (long)r * DQ + c, true);
  }
  for (int i = tid; i < BN * (DQ / 16); i += WARPS * 32) {
    const int r = i / (DQ / 16), c = (i % (DQ / 16)) * 16;
    cp_async16(sK + r * QROW + c, k8 + (long)r * DQ + c, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  unsigned af[NKC][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
    const uint8_t* p = sQ + (warp * 16 + gid) * QROW + kc * 32 + tig * 4;
    af[kc][0] = ld32(p);
    af[kc][1] = ld32(p + 8 * QROW);
    af[kc][2] = ld32(p + 16);
    af[kc][3] = ld32(p + 8 * QROW + 16);
  }
  const float sc = a.scale[group_at(a.g, b, a.gs, a.G)];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    int d4[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      const uint8_t* p = sK + (nt * 8 + gid) * QROW + kc * 32 + tig * 4;
      mma_s8(d4, af[kc], ld32(p), ld32(p + 16));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + warp * 16 + gid + (e >> 1) * 8;
      const int col = n0 + nt * 8 + tig * 2 + (e & 1);
      if (row >= a.M || col >= a.N) continue;
      const float y = __fmul_rn((float)d4[e], sc);
      const long o = ((long)b * a.M + row) * a.N + col;
      if (a.out_bf16) static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y);
      else static_cast<float*>(a.out)[o] = y;
    }
  }
}

struct PVArgs {
  const int8_t* codes;                // (B, M, N) region-signed prob codes
  const int8_t* v8t;                  // (Bv, DN, Np) v codes, transposed
  const float *scale1, *scale2; const int* g;
  int gs, G;
  void* out;                          // (B, M, D) f32 or bf16
  int M, N, D, DN, Np, rep, words, out_bf16;   // words: codes rows as u32
};

// The code word (4 codes) at row r, columns c..c+3 of batch row b; zero
// past the edges.
__device__ __forceinline__ unsigned code_word(const PVArgs& a, int b, int r, int c) {
  if (r >= a.M || c >= a.N) return 0u;
  const int8_t* row = a.codes + ((long)b * a.M + r) * a.N;
  if (a.words && c + 4 <= a.N) return *reinterpret_cast<const unsigned*>(row + c);
  unsigned w = 0;
  for (int j = 0; j < 4 && c + j < a.N; ++j) w |= (unsigned)(uint8_t)row[c + j] << (8 * j);
  return w;
}

// NDT: max 8-wide head-dim tiles of the output (multiple of 4).
template <int NDT>
__global__ void __launch_bounds__(WARPS * 32) pv_kernel(PVArgs a) {
  __shared__ __align__(16) uint8_t sP1[BM * PROW];
  __shared__ __align__(16) uint8_t sP2[BM * PROW];
  __shared__ __align__(16) uint8_t sV[NDT * 8 * PROW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM, b = blockIdx.y;
  const int ndt = a.DN / 8, nkv = a.Np / BN;
  const int8_t* v8t = a.v8t + (long)(b / a.rep) * a.DN * a.Np;

  int acc1[NDT][4], acc2[NDT][4];
#pragma unroll
  for (int t = 0; t < NDT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) { acc1[t][e] = 0; acc2[t][e] = 0; }

  for (int t = 0; t < nkv; ++t) {
    const int n0 = t * BN;
    for (int i = tid; i < a.DN * (BN / 16); i += WARPS * 32) {
      const int d = i / (BN / 16), c = (i % (BN / 16)) * 16;
      cp_async16(sV + d * PROW + c, v8t + (long)d * a.Np + n0 + c, true);
    }
    cp_async_commit();
    // the codes tile, split by sign: region 1 = max(c, 0), region 2 =
    // -min(c, 0) (bytewise, mod 256: -(-128) is the u8 128)
    for (int i = tid; i < BM * (BN / 4); i += WARPS * 32) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      const unsigned w = code_word(a, b, m0 + r, n0 + c);
      *reinterpret_cast<unsigned*>(sP1 + r * PROW + c) = __vmaxs4(w, 0u);
      *reinterpret_cast<unsigned*>(sP2 + r * PROW + c) = __vsub4(0u, __vmins4(w, 0u));
    }
    cp_async_wait<0>();
    __syncthreads();

    unsigned p1[4][4], p2[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int o = (warp * 16 + gid) * PROW + kc * 32 + tig * 4;
      p1[kc][0] = ld32(sP1 + o);            p2[kc][0] = ld32(sP2 + o);
      p1[kc][1] = ld32(sP1 + o + 8 * PROW); p2[kc][1] = ld32(sP2 + o + 8 * PROW);
      p1[kc][2] = ld32(sP1 + o + 16);       p2[kc][2] = ld32(sP2 + o + 16);
      p1[kc][3] = ld32(sP1 + o + 8 * PROW + 16);
      p2[kc][3] = ld32(sP2 + o + 8 * PROW + 16);
    }
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      if (dt >= ndt) break;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint8_t* p = sV + (dt * 8 + gid) * PROW + kc * 32 + tig * 4;
        const unsigned b0 = ld32(p), b1 = ld32(p + 16);   // one v read,
        mma_u8s8(acc1[dt], p1[kc], b0, b1);                // two regions
        mma_u8s8(acc2[dt], p2[kc], b0, b1);
      }
    }
    __syncthreads();                    // the tiles are free for t + 1
  }

  const int grp = group_at(a.g, b, a.gs, a.G);
  const float sc1 = a.scale1[grp], sc2 = a.scale2[grp];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    if (dt >= ndt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + warp * 16 + gid + (e >> 1) * 8;
      const int d = dt * 8 + tig * 2 + (e & 1);
      if (row >= a.M || d >= a.D) continue;
      const float y = __fadd_rn(__fmul_rn((float)acc1[dt][e], sc1),
                                __fmul_rn((float)acc2[dt][e], sc2));
      const long o = ((long)b * a.M + row) * a.D + d;
      if (a.out_bf16) static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y);
      else static_cast<float*>(a.out)[o] = y;
    }
  }
}

template <int NKC>
cudaError_t launch_qk(const QKArgs& a, int B, cudaStream_t s) {
  dim3 grid(a.Np / BN, a.Mp / BM, B);
  qk_kernel<NKC><<<grid, WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <int NDT>
cudaError_t launch_pv(const PVArgs& a, int B, int Mp, cudaStream_t s) {
  dim3 grid(Mp / BM, B);
  pv_kernel<NDT><<<grid, WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// B9a / B9c. q8, k8: int8 scratch of (B, Mp, DQ) and (Bk, Np, DQ) bytes
// allocated by the caller, Mp = 64 * ceil(M/64), Np = 128 * ceil(N/128),
// DQ = 32 * ceil(D/32). g: device int32 group (gs = 0) or (B,) vector
// (gs = 1, rep = 1), each entry clamped into [0, G) on the device.
extern "C" int int8_bmm_qk_launch(
    const void* q, const void* k, const void* s_q, const void* s_k,
    const void* scale, const void* g, void* out, void* q8, void* k8, int B,
    int M, int N, int D, int rep, int half, int x_bf16, int out_bf16, int gs,
    int G, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || D <= 0 || D > 128 || rep <= 0 || B % rep
      || (gs != 0 && gs != 1) || (gs && rep != 1) || G <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int nkc = (D + 31) / 32, DQ = nkc * 32;
  const int Mp = (M + BM - 1) / BM * BM, Np = (N + BN - 1) / BN * BN;
  const int* gp = static_cast<const int*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto cq = x_bf16 ? codes<__nv_bfloat16> : codes<float>;
  cudaError_t e;
  if ((e = cq(q, static_cast<int8_t*>(q8), static_cast<const float*>(s_q), gp,
              gs, G, B, M, D, Mp, DQ, 0, half, 0, s)) != cudaSuccess) return (int)e;
  if ((e = cq(k, static_cast<int8_t*>(k8), static_cast<const float*>(s_k), gp,
              gs, G, B / rep, N, D, Np, DQ, 0, half, 0, s)) != cudaSuccess)
    return (int)e;
  QKArgs a{static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
           static_cast<const float*>(scale), gp, gs, G, out, M, N, Mp, Np,
           rep, out_bf16};
  switch (nkc) {
    case 1: e = launch_qk<1>(a, B, s); break;
    case 2: e = launch_qk<2>(a, B, s); break;
    case 3: e = launch_qk<3>(a, B, s); break;
    default: e = launch_qk<4>(a, B, s); break;
  }
  return (int)e;
}

// B9b / B9d. codes: (B, M, N) int8; v8t: int8 scratch of (Bv, DN, Np)
// bytes allocated by the caller, DN = 8 * ceil(D/8), Np = 128 *
// ceil(N/128). g as for int8_bmm_qk_launch.
extern "C" int int8_bmm_pv_launch(
    const void* codes_p, const void* v, const void* s_v, const void* scale1,
    const void* scale2, const void* g, void* out, void* v8t, int B, int M,
    int N, int D, int rep, int half, int x_bf16, int out_bf16, int gs, int G,
    void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || D <= 0 || D > 128 || rep <= 0 || B % rep
      || (gs != 0 && gs != 1) || (gs && rep != 1) || G <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int DN = (D + 7) / 8 * 8, Np = (N + BN - 1) / BN * BN;
  const int Mp = (M + BM - 1) / BM * BM;
  const int* gp = static_cast<const int*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto cq = x_bf16 ? codes<__nv_bfloat16> : codes<float>;
  cudaError_t e;
  if ((e = cq(v, static_cast<int8_t*>(v8t), static_cast<const float*>(s_v), gp,
              gs, G, B / rep, N, D, Np, DN, 1, half, 0, s)) != cudaSuccess)
    return (int)e;
  const int words = (N % 4 == 0)
      && (reinterpret_cast<uintptr_t>(codes_p) % 4 == 0);
  PVArgs a{static_cast<const int8_t*>(codes_p),
           static_cast<const int8_t*>(v8t),
           static_cast<const float*>(scale1), static_cast<const float*>(scale2),
           gp, gs, G, out, M, N, D, DN, Np, rep, words, out_bf16};
  switch ((DN + 31) / 32) {
    case 1: e = launch_pv<4>(a, B, Mp, s); break;
    case 2: e = launch_pv<8>(a, B, Mp, s); break;
    case 3: e = launch_pv<12>(a, B, Mp, s); break;
    default: e = launch_pv<16>(a, B, Mp, s); break;
  }
  return (int)e;
}

// Batched int8 matmuls of the composed attention chain for Hopper
// (sm_90a): kernels B9a (QK^T) and B9b (dual-region P.V), and their
// per-batch-row-group siblings B9c and B9d, one launch each per call.
//
// Replaces the Pallas kernels repro/kernels/int8_bmm.py::int8_bmm_qk
// (B9a), ::int8_bmm_pv (B9b), ::int8_bmm_qk_vec (B9c) and
// ::int8_bmm_pv_vec (B9d):
//
//   B9a: scores[b] = (q8[b] . k8[b/rep]^T) * (scale[g] * alpha)  f32 or bf16
//        q8, k8 = clip(rint(x / s_{q,k}[g]), -(h-1), h-1)        SymQ codes
//   B9b: c1 = max(c, 0), c2 = max(-c, 0)       region-signed prob codes c
//        out[b] = (c1 . v8) * scale1[g] + (c2 . v8) * scale2[g]
//        v8 = clip(rint(v / s_v[g]), -(h-1), h-1)
//   B9c/B9d: the same with g = g[b], a per-batch-row (Bq,) int32 vector
//        (gs = 1; B9a/B9b pass gs = 0 and read g[0]). The kv codes then
//        depend on the q row's group: each CTA codes the kv rows it reads
//        with its own row's group, so GQA (rep > 1) needs no kv copy.
//
// What bounds them on the card: at DiT-XL/2 (Bq = B * H = 128, S = 256,
// hd 72, bf16) the products are small (2 * 128 * 256^2 * 72 int8 ops, 0.3
// us at the tensor cores' peak; P.V twice that); the bytes are not. B9a
// reads q and k (4.7 MB) and writes 33.5 MB of f32 scores: 12.8 us at
// 3.35 TB/s, 78 % of it the scores. B9b reads 8.4 MB of codes and v, and
// writes the output: 5.3 us. The scores and codes cross device memory
// because B10 (csrc/softmax_mrq.cu) sits between the two, as in the
// reference; the mask is applied there too.
//
// Design:
// - Operands from the qkv projection's layout: q and k (B9a) and v (B9b)
//   are read at their strides ((batch, head, group, row) element strides
//   for q and the output, (batch, head, row) for k and v; the public
//   (B, M, D) calls pass trivial ones), coded on their way into shared
//   memory by the flash kernel's quotient (csrc/attn.cuh: sym_code,
//   code8: a * (1/s) with two FMA corrections, equal to the IEEE divide's
//   rint, saturation and +-inf included; NaN codes to 0, as the
//   reference's int8 cast makes it), and never reach device
//   memory as codes. The head dim is zero-padded to the 32-deep wgmma k
//   step in shared memory only. B9b writes (B, Sq, Hk, G, hd), the order
//   the proj linear reads, so no permute or copy follows.
// - qk_kernel: a CTA owns one q batch row and one 128-wide kv strip, and
//   all M query rows. Its 256 threads stage the k strip's raw rows by
//   16-byte cp.async and code them once into a 128-byte-swizzled tile;
//   then each of its two warpgroups takes every other 64-row q tile:
//   codes it from its raw rows (staged by cp.async while the previous
//   tile was multiplied and written), starts the next tile's copies,
//   runs wgmma.m64n128k32.s32.s8.s8 over the padded head dim (exact s32),
//   dequantises (s32 -> f32 by the 1.5 x 2^23 add, exact below 2^22; one
//   __fmul_rn) and writes. The write stream is what bounds it: each warp
//   stages its rows 8 at a time in shared memory and stores each row 16
//   bytes a lane (one 512-byte row per store instruction in f32); the
//   stores are fire-and-forget, so a warp goes on to the next tile while
//   its scores drain, and two CTAs an SM (four warpgroups) keep the stream
//   fed.
// - pv_kernel: a CTA owns 256 query rows of one batch row (four
//   warpgroups of 64; two above a head dim of 80) and loops over 128-wide
//   kv tiles in a ring of two stages, both filled from the start: the
//   probability codes (16-byte cp.async, rows padded to 144 bytes so the
//   fragment loads are conflict-free) and the raw v rows (16-byte
//   cp.async) of the next tile land while this tile is coded and
//   multiplied. All threads code the v tile once for the CTA's rows,
//   transposed in natural kv order, into a swizzled tile (a warp writes
//   one whole 128-byte row per store; one item of 4 kv rows x 8 head dims
//   a thread, 288 items at hd 72). Each thread then reads its A fragment
//   words of the codes straight from shared memory (kv positions 4t..4t+3
//   and 16+4t.. of its two rows per k32 step) and splits them by sign in
//   registers (__vmaxs4 for region 1, __vsub4 for region 2: region-2
//   magnitudes reach half = 128, so both are u8); wgmma.m64nNk32.s32.u8.s8
//   multiplies each into its own s32 accumulator from the one v tile (N =
//   80 for hd 72; two N <= 64 halves above 80), one commit group per k32
//   step on two register sets, so the A fragments take 16 registers beside
//   the accumulators' 80. The sums stay exact over all tiles; the epilogue
//   converts them (cvt.rn) and rounds in the reference's order,
//   __fadd_rn(__fmul_rn(acc1, scale1), __fmul_rn(acc2, scale2)), staged 8
//   rows a warp and written 16 bytes a lane at the output's strides.
// - FAST instantiations (bf16, 16-byte rows in and out, the serving
//   shapes) hold no code of the other paths: with the scalar store path
//   beside it, the cold epilogue missed the SM's instruction cache
//   (PERF.md).
//
// Exactness: rint half to even, correctly rounded quotients,
// __fmul_rn/__fadd_rn, -fmad=false; integer products are exact, so each
// kernel equals its plain version bit for bit.
#include "attn.cuh"

namespace {

constexpr int BN = 128;             // kv lanes per strip (B9a) or tile (B9b)
constexpr int QM = 64;              // q rows per warpgroup tile
constexpr int THREADS = 256;        // two warpgroups
constexpr int PP = BN + 16;         // bytes per staged codes row (B9b)

struct QKArgs {
  const void *q, *k;
  const float *s_q, *s_k, *scale; const int* g;
  void* out;                        // (Bq, M, N) f32 or bf16, contiguous
  long qs[4], ks[3];                // element strides: (batch, head, group,
                                    // row), (batch, head, row)
  float alpha;                      // folded into scale[g]
  int gs, G, M, N, D, rep, Hk, half, out_bf16, vec_ok, ovec;
};

// Shared memory of qk_kernel<TX, NKC>: the k strip's codes, one q tile's
// codes per warpgroup, each warp's staging of 8 score rows (YP bytes each:
// 136 words in f32, 68 in bf16, so a warp's fragment stores are
// conflict-free), and the raw rows as read (the k strip's 128, then each
// warpgroup's next 64 q rows; rows of RB = 8 ceil(D / 8) elements, 16-byte
// aligned, so a warp's 16-byte reads of one chunk of 32 rows are
// conflict-free in bf16).
constexpr int QK_YP = 4 * BN + 32;
template <typename TX, int NKC>
struct QKSmem {
  static constexpr int RB_MAX = (int)sizeof(TX) * 32 * NKC;
  static constexpr int Y = BN * ROW + 2 * QM * ROW;
  static constexpr int RAW = Y + 8 * 8 * QK_YP;
  static constexpr int BYTES = RAW + BN * RB_MAX;
  static_assert(BYTES <= 232448, "fits in an SM's shared memory");
};

// Rows 0 .. nr - 1 of base (row stride rs elements) into raw (pitch rb
// bytes) by 16-byte cp.async, cpc chunks a row, thread i of n, as one
// commit group; rows from nvalid on are zero-filled.
template <typename TX>
__device__ __forceinline__ void stage_rows(uint8_t* raw, const TX* base,
                                           long rs, int nr, int nvalid,
                                           int cpc, int rb, int i, int n) {
  for (int j = i; j < nr * cpc; j += n) {
    const int r = j / cpc, c = j % cpc;
    cp_async16(raw + r * rb + 16 * c,
               reinterpret_cast<const uint8_t*>(base + (long)min(r, nvalid - 1) * rs)
                   + 16 * c,
               r < nvalid);
  }
  cp_async_commit();
}

// The codes of chunks h + 2 i of row r of a code tile (two threads a row;
// chunks past the head dim, up to the padded 32 NKC, are zero), from the
// raw row staged in shared memory (vec) or from device memory.
template <typename TX, int NKC>
__device__ __forceinline__ void code_row(uint8_t* tile, int r, int h, int cpr,
                                         int D, bool vec, const uint8_t* raw,
                                         const TX* p, float s, float y,
                                         int hi) {
#pragma unroll
  for (int i = 0; i < 2 * NKC; ++i) {
    const int c = h + 2 * i;
    uint2 w = make_uint2(0u, 0u);
    if (c < cpr) {
      float x[8];
      if (vec) raw_chunk<TX>(raw, 8 * c, D, x);
      else load_chunk(p, 8 * c, D, false, x);
      w = code8(x, s, y, hi);
    }
    *reinterpret_cast<uint2*>(tile + swz(r, 8 * c)) = w;
  }
}

// NKC: 32-deep k steps (the padded head dim / 32). FAST: 16-byte rows in
// and out (the serving shapes); the kernel then holds none of the other
// paths' code, which the SM's instruction cache need not hold.
template <typename TX, int NKC, bool FAST>
__global__ void __launch_bounds__(THREADS, 2) qk_kernel(const QKArgs a) {
  using L = QKSmem<TX, NKC>;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* sK = smem;                         // [BN][ROW]
  uint8_t* sQ = sK + BN * ROW;                // [2][QM][ROW]
  uint8_t* sY = smem + L::Y;                  // [8 warps][8][QK_YP]
  uint8_t* sR = smem + L::RAW;                // [BN][rb]: k, then [2][QM][rb]
  const int b = blockIdx.y, n0 = blockIdx.x * BN;
  const int M = a.M, N = a.N, D = a.D, cpr = (D + 7) / 8;
  const int g = group_at(a.g, b, a.gs, a.G);
  const int hi = a.half - 1;
  const bool vec = FAST || a.vec_ok;
  const int tid = threadIdx.x;
  const int rb = (int)sizeof(TX) * 8 * cpr;   // raw row pitch, bytes
  const int cpc = D * (int)sizeof(TX) / 16;   // 16-byte chunks a row (vec)

  {  // the k strip: thread t codes row t % 128, chunks t / 128 + 2 i
    const float sk = a.s_k[g], yk = __frcp_rn(sk);
    const TX* kb = static_cast<const TX*>(a.k) + kv_base(a.ks, b, a.rep, a.Hk)
                   + (long)n0 * a.ks[2];
    if (vec) {
      stage_rows(sR, kb, a.ks[2], BN, N - n0, cpc, rb, tid, THREADS);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int r = tid & 127;
    code_row<TX, NKC>(sK, r, tid >> 7, cpr, D, vec, sR + r * rb,
                      kb + (long)min(r, N - n0 - 1) * a.ks[2], sk, yk, hi);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();                      // sK is coded, sR free

  const int wg = tid >> 7, lt = tid & 127;
  const int warp = lt >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const float sq = a.s_q[g], yq = __frcp_rn(sq);
  const float sc = __fmul_rn(a.scale[g], a.alpha);
  const TX* qb = static_cast<const TX*>(a.q) + q_base(a.qs, b, a.rep, a.Hk);
  uint8_t* tq = sQ + wg * QM * ROW;
  uint8_t* raw = sR + wg * QM * rb;
  uint8_t* ys = sY + (wg * 4 + warp) * 8 * QK_YP;
  const uint64_t dq = desc(su32(tq)), dk = desc(su32(sK));
  const int osz = a.out_bf16 ? 2 : 4, yp = a.out_bf16 ? QK_YP / 2 : QK_YP;
  const int ncol = min(BN, N - n0), n16 = ncol * osz / 16;
  const int r = lt & 63;
  const int ntiles = (M + QM - 1) / QM;
  auto stage_q = [&](int t) {           // tile t's raw rows, in flight
    if (vec) stage_rows(raw, qb + (long)t * QM * a.qs[3], a.qs[3], QM,
                        M - t * QM, cpc, rb, lt, 128);
  };

  if (wg < ntiles) stage_q(wg);
#pragma unroll 1
  for (int t = wg; t < ntiles; t += 2) {
    const int m0 = t * QM;
    if (vec) cp_async_wait<0>();
    bar_sync(1 + wg, 128);              // raw rows in; the last products done
    code_row<TX, NKC>(tq, r, lt >> 6, cpr, D, vec, raw + r * rb,
                      qb + (long)min(m0 + r, M - 1) * a.qs[3], sq, yq, hi);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + wg, 128);              // tq coded, raw free
    if (t + 2 < ntiles) stage_q(t + 2); // under this tile's products and stores

    int acc[64];
    wgmma_fence();
    wgmma_ss0(acc, dq, dk);
#pragma unroll
    for (int kk = 1; kk < NKC; ++kk) wgmma_ss(acc, dq + 2 * kk, dk + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // rows 16 warp + gid + 8 h, columns 8 j + 2 tig (+1): staged 8 rows at
    // a time, then written a whole row per store instruction
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int e = 4 * j + 2 * h;
        const float y0 = __fmul_rn(__fsub_rn(__int_as_float(acc[e] + MAGIC), FMAGIC), sc);
        const float y1 = __fmul_rn(__fsub_rn(__int_as_float(acc[e + 1] + MAGIC), FMAGIC), sc);
        uint8_t* p = ys + gid * yp + (8 * j + 2 * tig) * osz;
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
        else
          *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
      }
      __syncwarp();
      const int rbase = m0 + 16 * warp + 8 * h;
      if (FAST || a.ovec) {
        for (int i = lane; i < 8 * n16; i += 32) {
          const int rr = i / n16, c = i % n16, m = rbase + rr;
          if (m < M)
            *reinterpret_cast<uint4*>(static_cast<uint8_t*>(a.out)
                + (((long)b * M + m) * N + n0) * osz + 16 * c) =
                *reinterpret_cast<const uint4*>(ys + rr * yp + 16 * c);
        }
      } else {
        for (int i = lane; i < 8 * ncol; i += 32) {
          const int rr = i / ncol, c = i % ncol, m = rbase + rr;
          if (m >= M) continue;
          const long o = ((long)b * M + m) * N + n0 + c;
          if (a.out_bf16)
            static_cast<__nv_bfloat16*>(a.out)[o] =
                *reinterpret_cast<const __nv_bfloat16*>(ys + rr * yp + 2 * c);
          else
            static_cast<float*>(a.out)[o] =
                *reinterpret_cast<const float*>(ys + rr * yp + 4 * c);
        }
      }
      __syncwarp();
    }
  }
}

struct PVArgs {
  const int8_t* codes;              // (Bq, M, N) region-signed prob codes
  const void* v;
  const float *s_v, *scale1, *scale2; const int* g;
  void* out;
  long vs[3], os[4];                // element strides: v (batch, head, row),
                                    // out (batch, head, group, row)
  int gs, G, M, N, D, rep, Hk, half, out_bf16, vec_ok, ovec, cvec;
};

// pv_kernel<TX, NPV, NH>'s CTA: WG warpgroups of 64 q rows (four below a
// head dim of 80, two above, whose accumulators need more registers).
template <int NH>
struct PVShape {
  static constexpr int WG = NH == 1 ? 4 : 2;
  static constexpr int THREADS = 128 * WG;
  static constexpr int BM = 64 * WG;                 // q rows a CTA
};

// Shared memory of pv_kernel<TX, NPV, NH>: two stages of the codes tile
// (BM rows of PP bytes; after the kv loop each warp's output staging),
// two of the v^T code tile, and, where they fit, two of the raw v rows as
// read (rows of RB = 8 ceil(D / 8) elements; in bf16 the 16-byte chunks
// of row r are rotated by (r / 8) % 4 slots, so the 8 lanes of a quarter
// warp, which read rows 4q + j, hit 8 different bank groups: raw_slot).
template <typename TX, int NPV, int NH>
struct PVSmem {
  static constexpr int PT = PVShape<NH>::BM * PP;    // one codes stage
  static constexpr int VT = NPV * NH * ROW;          // one v^T code tile
  static constexpr int RB_MAX = (int)sizeof(TX) * NPV * NH;
  static constexpr int RT = BN * RB_MAX;             // one raw v stage
  static constexpr int V = 2 * PT;
  static constexpr int RAW = V + 2 * VT;
  static constexpr bool STAGE = RAW + 2 * RT <= 232448;
  static constexpr int BYTES = RAW + (STAGE ? 2 * RT : 0);
  static constexpr int YROW = 4 * NPV * NH;          // one staged output row
  static_assert(PVShape<NH>::WG * 4 * 8 * YROW <= 2 * PT,
                "the output staging (8 rows a warp) fits the codes stages");
  static_assert(BYTES <= 232448, "fits in an SM's shared memory");
};

// cp.async.wait_group with a run-time count (0 .. 3).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// The slot of 16-byte chunk c of raw v row r (cpc chunks a row; rows of
// fewer than 4 chunks are not rotated), without a division.
template <typename TX>
__device__ __forceinline__ int raw_slot(int c, int r, int cpc) {
  if constexpr (sizeof(TX) == 2) {
    const int sl = c + (cpc >= 4 ? (r >> 3) & 3 : 0);
    return sl >= cpc ? sl - cpc : sl;
  }
  return c;
}

// NPV: the P.V product's width (a valid wgmma N, NPV * NH >= D); NH: 1, or
// 2 halves of the head dims (the second at v^T row NPV). FAST: 16-byte
// rows of codes, v and out, v staged (the serving shapes): no other path's
// code, whose instruction-cache misses slowed the cold epilogue.
template <typename TX, int NPV, int NH, bool FAST>
__global__ void __launch_bounds__(PVShape<NH>::THREADS, 1) pv_kernel(const PVArgs a) {
  using L = PVSmem<TX, NPV, NH>;
  constexpr int NA = NPV / 2, NT = PVShape<NH>::THREADS, BM = PVShape<NH>::BM;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* sP = smem;                   // [2][BM][PP]
  uint8_t* sV = smem + L::V;            // [2][NPV * NH][ROW]
  uint8_t* sR = smem + L::RAW;          // [2][BN][rb] (L::STAGE)
  const int b = blockIdx.y, m0 = blockIdx.x * BM;
  const int M = a.M, N = a.N, D = a.D, cpr = (D + 7) / 8;
  const int nkv = (N + BN - 1) / BN;
  const int g = group_at(a.g, b, a.gs, a.G);
  const int hi = a.half - 1;
  const int tid = threadIdx.x;
  const bool stage = FAST || (L::STAGE && a.vec_ok);
  const bool cvec = FAST || a.cvec, ovec = FAST || a.ovec;
  const float sv = a.s_v[g], yv = __frcp_rn(sv);
  const float sc1 = a.scale1[g], sc2 = a.scale2[g];   // read early: the
                                                      // epilogue's first load
  const TX* vb = static_cast<const TX*>(a.v) + kv_base(a.vs, b, a.rep, a.Hk);
  const int8_t* cb = a.codes + ((long)b * M) * N;
  const int rb = (int)sizeof(TX) * 8 * cpr;     // raw row pitch, bytes
  const int cpc = D * (int)sizeof(TX) / 16;     // 16-byte chunks per v row

  // tile t's raw v rows (stage) and its codes into stage t % 2, each as
  // one commit group, zero past M and N
  auto issue_v = [&](int t) {
    if (stage) {
      const int n0 = t * BN;
      uint8_t* raw = sR + (t & 1) * L::RT;
      for (int i = tid; i < BN * cpc; i += NT) {
        const int r = i / cpc, c = i % cpc, n = n0 + r;
        cp_async16(raw + r * rb + 16 * raw_slot<TX>(c, r, cpc),
                   reinterpret_cast<const uint8_t*>(vb + (long)min(n, N - 1) * a.vs[2]) + 16 * c,
                   n < N);
      }
    }
    cp_async_commit();
  };
  auto issue_codes = [&](int t) {
    const int n0 = t * BN;
    uint8_t* tp = sP + (t & 1) * L::PT;
    for (int i = tid; i < BM * (BN / 16); i += NT) {
      const int r = i >> 3, j = i & 7, m = m0 + r, n = n0 + 16 * j;
      if (cvec) {
        cp_async16(tp + r * PP + 16 * j,
                   cb + (long)min(m, M - 1) * N + min(n, N - 16),
                   m < M && n < N);
      } else {
        unsigned w[4] = {0u, 0u, 0u, 0u};
        for (int e = 0; e < 16; ++e)
          if (m < M && n + e < N)
            w[e >> 2] |= (unsigned)(uint8_t)cb[(long)m * N + n + e] << (8 * (e & 3));
        *reinterpret_cast<uint4*>(tp + r * PP + 16 * j) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    cp_async_commit();
  };

  const int wg = tid >> 7, lt = tid & 127;
  const int warp = lt >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  int acc1[NH][NA], acc2[NH][NA];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int e = 0; e < NA; ++e) { acc1[hh][e] = 0; acc2[hh][e] = 0; }

  // both stages are free: the first two tiles' copies start at once, v
  // first, so v's coding runs under the codes' copies (commit groups v0,
  // v1, c0, c1; later tiles' v(t + 1), c(t + 1) into the stage tile t - 1
  // freed)
  const bool two = nkv > 1;
  issue_v(0);
  if (two) issue_v(1);
  issue_codes(0);
  if (two) issue_codes(1);
#pragma unroll 1
  for (int t = 0; t < nkv; ++t) {
    const int s = t & 1, n0 = t * BN;
    const bool next = t >= 1 && t + 1 < nkv;
    cp_async_wait_n(t == 0 && two ? 3 : 1);   // v(t) landed
    __syncthreads();                    // ... for every thread; t - 1 done
    if (next) {
      issue_v(t + 1);
      issue_codes(t + 1);
    }

    // v^T codes, natural kv order: item i (lane q = i % 32 of a warp)
    // codes kv rows 4q .. 4q + 3 of chunk c = i / 32, one 4-code word per
    // head dim
    uint8_t* tv = sV + s * L::VT;
    const uint8_t* raw = sR + s * L::RT;
    for (int i = tid; i < 32 * cpr; i += NT) {
      const int q4 = i & 31, c = i >> 5;
      uint2 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * q4 + j, n = n0 + l;
        float x[8];
        if (stage)                      // chunk c (8 bf16: one slot) lies
          raw_chunk<TX>(raw + l * rb + 16 * (raw_slot<TX>(c, l, cpc) - c),
                        8 * c, D, x);   // at its slot
        else load_chunk(vb + (long)min(n, N - 1) * a.vs[2], 8 * c, D,
                        a.vec_ok, x);
        w[j] = n < N ? code8(x, sv, yv, hi) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int h4 = 0; h4 < 2; ++h4) {    // head dims 8c + 4 h4 + i
        const unsigned A = h4 ? w[0].y : w[0].x, B = h4 ? w[1].y : w[1].x;
        const unsigned C = h4 ? w[2].y : w[2].x, E = h4 ? w[3].y : w[3].x;
        const unsigned ab0 = __byte_perm(A, B, 0x5140), ab1 = __byte_perm(A, B, 0x7362);
        const unsigned ce0 = __byte_perm(C, E, 0x5140), ce1 = __byte_perm(C, E, 0x7362);
        const unsigned col[4] = {__byte_perm(ab0, ce0, 0x5410),
                                 __byte_perm(ab0, ce0, 0x7632),
                                 __byte_perm(ab1, ce1, 0x5410),
                                 __byte_perm(ab1, ce1, 0x7632)};
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4)
          *reinterpret_cast<unsigned*>(tv + swz(8 * c + 4 * h4 + i4, 4 * q4)) = col[i4];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cp_async_wait_n(next ? 2 : t == 0 && two ? 1 : 0);   // codes(t) landed
    __syncthreads();                    // the v^T tile is coded

    // A fragments: rows 64 wg + 16 warp + gid (+8), kv 32 kc + 4 tig (+16),
    // one commit group per k32 step on two register sets, so a set is
    // rewritten only after the step two back has completed
    const uint8_t* tp = sP + s * L::PT + (64 * wg + 16 * warp + gid) * PP + 4 * tig;
    const uint64_t dv = desc(su32(tv));
    unsigned pa[2][2][4];               // [set][region][register]
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      unsigned (&p)[2][4] = pa[kc & 1];
      if (kc >= 2) {
        wgmma_wait<1>();
        fence_regs(p);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned c = *reinterpret_cast<const unsigned*>(
            tp + 8 * (j & 1) * PP + 32 * kc + 16 * (j >> 1));
        p[0][j] = __vmaxs4(c, 0u);
        p[1][j] = __vsub4(p[0][j], c);     // max(-c, 0), -(-128) = u8 128
      }
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        const uint64_t d = dv + ((hh * NPV * ROW) >> 4) + 2 * kc;
        wgmma_rs(acc1[hh], p[0], d);
        wgmma_rs(acc2[hh], p[1], d);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc1);
    fence_regs(acc2);
    fence_regs(pa[0]);
    fence_regs(pa[1]);
  }

  // -- epilogue: y = acc1 * scale1 + acc2 * scale2 in the out dtype; each
  //    warp stages 8 rows at a time (in the codes stages, free now) and
  //    writes them 16 bytes a lane at the out strides (ovec), else one
  //    element at a time ------------------------------------------------
  __syncthreads();
  const long ob = q_base(a.os, b, a.rep, a.Hk);
  const int osz = a.out_bf16 ? 2 : 4;
  uint8_t* ys = smem + (wg * 4 + warp) * 8 * L::YROW;
  const int row0 = m0 + 64 * wg + 16 * warp + gid;
  const int n16 = D * osz / 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int j = 0; j < NPV / 8; ++j) {
        const int d = hh * NPV + 8 * j + 2 * tig, e = 4 * j + 2 * h;
        if (d >= D) continue;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          y[c] = __fadd_rn(__fmul_rn(__int2float_rn(acc1[hh][e + c]), sc1),
                           __fmul_rn(__int2float_rn(acc2[hh][e + c]), sc2));
        if (ovec) {                     // D is even: the pair is whole
          uint8_t* p = ys + gid * L::YROW + d * osz;
          if (a.out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y[0], y[1]);
          else
            *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
          continue;
        }
        if (row >= M) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (d + c >= D) continue;
          const long o = ob + row * a.os[3] + d + c;
          if (a.out_bf16)
            static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y[c]);
          else
            static_cast<float*>(a.out)[o] = y[c];
        }
      }
    if (!ovec) continue;
    __syncwarp();
    for (int i = lane; i < 8 * n16; i += 32) {
      const int r = i / n16, c = i % n16;
      const int grow = row0 - gid + r + 8 * h;
      if (grow < M)
        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(a.out)
                                  + (ob + grow * a.os[3]) * osz + 16 * c) =
            *reinterpret_cast<const uint4*>(ys + r * L::YROW + 16 * c);
    }
    __syncwarp();
  }
}

template <typename TX, int NKC, bool FAST>
cudaError_t launch_qk_k(const QKArgs& a, int Bq, cudaStream_t st) {
  constexpr int bytes = QKSmem<TX, NKC>::BYTES;
  int sms = 0;
  cudaError_t e = kernel_sms<qk_kernel<TX, NKC, FAST>>(bytes, &sms);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + BN - 1) / BN, Bq);
  qk_kernel<TX, NKC, FAST><<<grid, THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

// FAST where the call allows it, in bf16 (the serving dtype) only.
template <typename TX, int NKC>
cudaError_t launch_qk(const QKArgs& a, int Bq, cudaStream_t st) {
  if constexpr (sizeof(TX) == 2)
    if (a.vec_ok && a.ovec) return launch_qk_k<TX, NKC, true>(a, Bq, st);
  return launch_qk_k<TX, NKC, false>(a, Bq, st);
}

template <typename TX>
cudaError_t launch_qk_d(const QKArgs& a, int Bq, cudaStream_t st) {
  switch ((a.D + 31) / 32) {
    case 1: return launch_qk<TX, 1>(a, Bq, st);
    case 2: return launch_qk<TX, 2>(a, Bq, st);
    case 3: return launch_qk<TX, 3>(a, Bq, st);
    default: return launch_qk<TX, 4>(a, Bq, st);
  }
}

template <typename TX, int NPV, int NH, bool FAST>
cudaError_t launch_pv_k(const PVArgs& a, int Bq, cudaStream_t st) {
  using S = PVShape<NH>;
  constexpr int bytes = PVSmem<TX, NPV, NH>::BYTES;
  int sms = 0;
  cudaError_t e = kernel_sms<pv_kernel<TX, NPV, NH, FAST>>(bytes, &sms);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.M + S::BM - 1) / S::BM, Bq);
  pv_kernel<TX, NPV, NH, FAST><<<grid, S::THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

// FAST where the call allows it, in bf16 (the serving dtype) only.
template <typename TX, int NPV, int NH>
cudaError_t launch_pv(const PVArgs& a, int Bq, cudaStream_t st) {
  if constexpr (sizeof(TX) == 2)
    if (PVSmem<TX, NPV, NH>::STAGE && a.vec_ok && a.cvec && a.ovec)
      return launch_pv_k<TX, NPV, NH, true>(a, Bq, st);
  return launch_pv_k<TX, NPV, NH, false>(a, Bq, st);
}

// The instantiation for head dim D: P.V width NPV * NH >= D (a valid
// wgmma N: 80 for hd 72), as flash's.
template <typename TX>
cudaError_t launch_pv_d(const PVArgs& a, int Bq, cudaStream_t st) {
  if (a.D <= 32) return launch_pv<TX, 32, 1>(a, Bq, st);
  if (a.D <= 48) return launch_pv<TX, 48, 1>(a, Bq, st);
  if (a.D <= 64) return launch_pv<TX, 64, 1>(a, Bq, st);
  if (a.D <= 80) return launch_pv<TX, 80, 1>(a, Bq, st);
  if (a.D <= 96) return launch_pv<TX, 48, 2>(a, Bq, st);
  return launch_pv<TX, 64, 2>(a, Bq, st);
}

bool valid(int Bq, int M, int N, int D, int rep, int Hk, int half, int gs,
           int G) {
  return Bq > 0 && M > 0 && N > 0 && D > 0 && D <= 128 && rep > 0 && Hk > 0
         && Bq % ((long)rep * Hk) == 0 && half >= 2 && half <= 128
         && !(half & (half - 1)) && (gs == 0 || gs == 1) && G > 0
         && Bq <= 65535;
}

}  // namespace

// B9a / B9c. q (Bq = Bb * Hk * rep rows of M x D) and k (Bb * Hk rows of
// N x D) at element strides (the head dim contiguous; the flash
// launcher's layout): strides[0:4] q (batch, head, group, row), [4:7] k
// (batch, head, row); [7:14] are not read. q row b = (bb * Hk + hk) * rep
// + gg reads kv row b / rep. out: (Bq, M, N) contiguous. g: device int32
// group (gs = 0) or (Bq,) vector (gs = 1), each entry clamped into [0, G)
// on the device. alpha multiplies scale[g].
extern "C" int int8_bmm_qk_launch(
    const void* q, const void* k, const void* s_q, const void* s_k,
    const void* scale, const void* g, void* out, const long* strides, int Bq,
    int M, int N, int D, int rep, int Hk, float alpha, int half, int x_bf16,
    int out_bf16, int gs, int G, void* stream) {
  if (!valid(Bq, M, N, D, rep, Hk, half, gs, G))
    return (int)cudaErrorInvalidValue;
  QKArgs a;
  a.q = q; a.k = k;
  a.s_q = static_cast<const float*>(s_q);
  a.s_k = static_cast<const float*>(s_k);
  a.scale = static_cast<const float*>(scale);
  a.g = static_cast<const int*>(g);
  a.out = out;
  for (int i = 0; i < 4; ++i) a.qs[i] = strides[i];
  for (int i = 0; i < 3; ++i) a.ks[i] = strides[4 + i];
  a.alpha = alpha; a.gs = gs; a.G = G; a.M = M; a.N = N; a.D = D;
  a.rep = rep; a.Hk = Hk; a.half = half; a.out_bf16 = out_bf16;
  // 16-byte loads: every row of q and k starts 16-byte aligned and holds
  // whole 16-byte chunks
  const long esz = x_bf16 ? 2 : 4;
  bool ok = aligned16(q) && aligned16(k) && (D * esz) % 16 == 0;
  for (int i = 0; i < 7; ++i) ok = ok && (strides[i] * esz) % 16 == 0;
  a.vec_ok = ok;
  // 16-byte score rows
  a.ovec = aligned16(out) && (N * (out_bf16 ? 2 : 4)) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? launch_qk_d<__nv_bfloat16>(a, Bq, st)
                      : launch_qk_d<float>(a, Bq, st));
}

// B9b / B9d. codes: (Bq, M, N) int8 contiguous; v (Bb * Hk rows of N x D)
// and out (as q of int8_bmm_qk_launch) at element strides: strides[7:10] v
// (batch, head, row), [10:14] out (batch, head, group, row); [0:7] are
// not read. g as for int8_bmm_qk_launch.
extern "C" int int8_bmm_pv_launch(
    const void* codes, const void* v, const void* s_v, const void* scale1,
    const void* scale2, const void* g, void* out, const long* strides,
    int Bq, int M, int N, int D, int rep, int Hk, int half, int x_bf16,
    int out_bf16, int gs, int G, void* stream) {
  if (!valid(Bq, M, N, D, rep, Hk, half, gs, G))
    return (int)cudaErrorInvalidValue;
  PVArgs a;
  a.codes = static_cast<const int8_t*>(codes); a.v = v;
  a.s_v = static_cast<const float*>(s_v);
  a.scale1 = static_cast<const float*>(scale1);
  a.scale2 = static_cast<const float*>(scale2);
  a.g = static_cast<const int*>(g);
  a.out = out;
  for (int i = 0; i < 3; ++i) a.vs[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) a.os[i] = strides[10 + i];
  a.gs = gs; a.G = G; a.M = M; a.N = N; a.D = D; a.rep = rep; a.Hk = Hk;
  a.half = half; a.out_bf16 = out_bf16;
  const long esz = x_bf16 ? 2 : 4;
  bool ok = aligned16(v) && (D * esz) % 16 == 0;
  for (int i = 7; i < 10; ++i) ok = ok && (strides[i] * esz) % 16 == 0;
  a.vec_ok = ok;
  const long osz = out_bf16 ? 2 : 4;
  ok = aligned16(out) && (D * osz) % 16 == 0;
  for (int i = 10; i < 14; ++i) ok = ok && (strides[i] * osz) % 16 == 0;
  a.ovec = ok;
  a.cvec = aligned16(codes) && N % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? launch_pv_d<__nv_bfloat16>(a, Bq, st)
                      : launch_pv_d<float>(a, Bq, st));
}

// Fused int8 linears for Hopper (sm_90a): kernels B1 and B2, their
// per-row-group siblings B6a and B6b, and B11 (the GEMM alone, on codes
// quantized by the caller; see int8_gemm_codes_launch at the end).
//
// Replaces the Pallas kernels repro/kernels/int8_fused.py::int8_matmul_fq
// (B1), ::int8_matmul_mrq_fq (B2), ::int8_matmul_fq_vec (B6a) and
// ::int8_matmul_mrq_fq_vec (B6b), and repro/kernels/int8_matmul.py::
// int8_matmul (B11):
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
//   whose rows sit at different TGQ groups, and the weights stream once.
//
// Two launches per call: the prologue pass (csrc/prologue.cuh) runs the
// layernorm statistics, the prologue and the quantize once per activation
// element and writes the codes, (M, Kp) int8 with K zero-padded to 16
// bytes (B2: two disjoint region-code tensors); gemm_kernel multiplies
// them by the weights and runs the epilogue.
//
// What bounds gemm_kernel on the card, at the DiT-XL/2 serving shapes
// (2B = 8 rows of 256 tokens, M = 2048; d 1152, d_ff 4608):
// - qkv (2048 x 1152 x 3456), fc1 (x 4608) and fc2 (4608 -> 1152, two
//   region products) are bound by the int8 tensor-core rate (1979 TOP/s:
//   8.2, 11.0 and 22.0 us); proj (1152 -> 1152) by its bytes (4.6 us).
//   Only wgmma reaches that rate; it wants both operands K-major in
//   shared memory, fed fast enough that the tensor cores never wait.
// - At N = 1152 a 128 x 128 tile grid has 144 tiles for 132 SMs: two
//   waves, the second almost empty.
// - ada (8 x 1152 x 6912), t_mlp and final_ada (M = 8) are streams of
//   their weights (ada 8 MB: 2.4 us); one row tile of 128 leaves most of
//   the card idle unless the weight is spread over every SM.
// - The epilogue writes M x N outputs (qkv: 14 MB of bf16, 4.2 us of
//   bandwidth) and, with gate + residual, reads as many again.
//
// Design:
// - Tiles of 128 x 144 (BM x BN): N = 1152 is 8 column tiles, and
//   M = 2048 gives 128 tiles for 132 SMs (qkv 384, fc1 512).
// - Persistent: one CTA per SM (grid = min(units, SMs)) walks the work
//   units (a tile, or a tile's K split) in order, so the producer loads
//   the next unit while the consumers run this one's epilogue.
// - Warp specialisation, 3 warpgroups. Warpgroup 0 gives its registers
//   away (setmaxnreg 40; the consumers take 232). Its first thread loads
//   the codes' and the weights' k tiles (128 bytes deep) with TMA
//   (cp.async.bulk.tensor.2d, 128-byte swizzle) into a ring of 5 stages
//   (B2: 3), arming a full mbarrier with the stage's bytes; its warps
//   1-3 stage each unit's column rows (below) behind their own full and
//   empty mbarriers. Warpgroups 1 and 2 each own 64 rows and run
//   wgmma.mma_async m64n144k32 s8 x s8 -> s32 from shared-memory
//   descriptors, one commit group in flight, freeing a stage on its empty
//   mbarrier once its products are done. Both operands are K-major as
//   8-bit wgmma requires: the codes are (M, Kp) and the weights are
//   cached transposed to (N, Kp) with their tensor map (the wrapper's
//   layout cache). TMA's zero fill outside the tensor replaces predicated
//   loads for ragged M and N and for K below a tile (x_proj: K = 16).
// - B2 takes two A tiles (one per region) and one weight tile per stage
//   and feeds each weight tile to two accumulators, so the weights stream
//   once: 2 x 72 s32 registers per consumer thread.
// - Split K: s32 sums are exact in any order (|sum| <= 4608 * 128 * 128
//   < 2^31), so where the tile grid fills less than half the card (M = 8,
//   N = 32) the wrapper splits the k tiles (int8_fused.py::split_k). Each
//   split adds its partial sums into an s32 workspace with atomics; the
//   last split of a tile to finish (an atomic count) reads the sums back,
//   zeroing the workspace and the count for the next launch, and runs the
//   epilogue.
// - Epilogue: the unit's column rows (bias; scale and corr, or both
//   scales, of the call's group, or of the first 10 groups for gs = 1;
//   later groups read device memory) wait in shared memory. Each consumer
//   group dequantizes its accumulators in registers and stages y in its
//   own buffer, 72 columns at a time; then gate, residual and out move 16
//   bytes a thread (one column at a time at a ragged edge or an unaligned
//   pointer). The epilogue does not overlap the consumers' next products.
//
// Exactness: see csrc/prologue.cuh (the codes); the epilogue rounds
// each step (__fmul_rn/__fadd_rn) in the reference's op order, and the
// build passes -fmad=false. The group index is read on the device from
// an int32 pointer and clamped into [0, G) (group_at). A wait on an
// mbarrier that never completes traps, so a pipeline fault fails the
// launch instead of hanging the card.
#include "prologue.cuh"

namespace {

constexpr int BM = 128;         // rows per CTA: two consumer warpgroups of 64
constexpr int BN = 144;         // columns per CTA (wgmma m64n144k32)
constexpr int BK = TMA_BK;      // k tile: 128 bytes, one swizzle row
constexpr int KPAD = 16;        // codes and weights pad K to 16 bytes (TMA)
constexpr int THREADS = 384;    // warpgroup 0 loads, 1 and 2 multiply
constexpr int GST = 10;         // groups whose column rows are staged
constexpr int HALF = BN / 2;    // columns of y staged at a time
constexpr int YS = HALF + 4;    // floats per staged row (16-byte rows)
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;

template <bool MRQ>
struct Layout {                 // dynamic shared memory (1024-aligned)
  static constexpr int R = MRQ ? 2 : 1;          // A tiles per stage
  static constexpr int STAGES = MRQ ? 3 : 5;
  static constexpr int STAGE = R * A_BYTES + B_BYTES;
  static constexpr int Y = STAGES * STAGE;       // y: 2 groups x 64 x YS f32
  static constexpr int PARAMS = Y + 2 * 64 * YS * 4;  // bias, GST rows of a, of b
  // mbarriers: full[STAGES], empty[STAGES], the column rows' full, empty
  static constexpr int BARS = PARAMS + (1 + 2 * GST) * BN * 4;
  static constexpr int FLAG = BARS + (2 * STAGES + 2) * 8;  // split K's
  static constexpr int BYTES = FLAG + 16;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle atoms aligned");
  static_assert(BYTES <= 232448, "fits in an SM's shared memory");
};

struct GArgs {          // gemm_kernel
  const float* scale_a; const float* scale_b;  // B1: scale     B2: scale_neg, scale_pos
  const int* corr; const float* bias; const int* g;
  const int* bv; const float* gate; const void* res; void* out;
  int* ws;              // split K: R planes of M x N s32 sums, then one
                        // count per output tile; zero between launches
  int M, N, Kp, res_bf16, out_bf16;
  int gs;               // group stride: 0 (B1, B2) or 1 per row (B6a, B6b)
  int G;                // groups in the scale (and corr) stacks
  int ks;               // k splits per output tile
  int vec_ok;           // N % 8 == 0, out/gate/res 16-byte aligned
  int pairs_ok;         // N even, the scale (and corr) stacks 8-byte aligned
};

// d[64 x 144] += A[64 x 32] . B[144 x 32]^T, s8 x s8 -> s32, both from
// shared memory. d[4j + e]: row 16 * warp + lane / 4 + 8 * (e >> 1),
// column 8j + 2 * (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_n144(int (&d)[72], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

// One work unit of a CTA: an output tile and its split's k tiles [kb, ke).
struct Unit { int tile, m0, n0, kb, ke; };

__device__ __forceinline__ Unit unit_at(int u, int tn, int ks, int nk) {
  const int t = u / ks, z = u % ks;     // a tile's splits are neighbours
  return {t, (t / tn) * BM, (t % tn) * BN, (int)((long)z * nk / ks),
          (int)((long)(z + 1) * nk / ks)};
}

// The staging warps (1-3 of the producer group): for each unit, once the
// consumers are done with the last unit's rows, the unit's column rows
// (bias; the scale and corr, or both scales, of the call's group, or of
// the first GST groups for gs = 1; zero past N) into shared memory.
template <bool MRQ>
__device__ __forceinline__ void stage_rows(const GArgs& a, uint8_t* dst,
                                           uint32_t pfull, uint32_t pempty,
                                           int t, int units, int tn, int nk) {
  float* bias_s = reinterpret_cast<float*>(dst);
  float* pa = bias_s + BN;
  float* pb = pa + GST * BN;
  const int N = a.N, g0 = group_at(a.g, 0, 0, a.G);
  const int nst = a.gs ? min(a.G, GST) : 1;
  int n = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const int n0 = unit_at(u, tn, a.ks, nk).n0;
    if (n > 0) mbar_wait(pempty, (n - 1) & 1);
    for (int i = t; i < BN; i += 96)
      bias_s[i] = n0 + i < N ? a.bias[n0 + i] : 0.f;
    for (int i = t; i < nst * BN; i += 96) {
      const int c = n0 + i % BN;
      const long o = (long)(a.gs ? i / BN : g0) * N + c;
      pa[i] = c < N ? a.scale_a[o] : 0.f;
      pb[i] = c < N ? (MRQ ? a.scale_b[o] : __int_as_float(a.corr[o])) : 0.f;
    }
    mbar_arrive(pfull);           // release: the rows are visible
  }
}

template <bool MRQ>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b,
            const __grid_constant__ CUtensorMap map_w, const GArgs a) {
  using L = Layout<MRQ>;
  constexpr int R = L::R, S = L::STAGES;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = su32(smem);
  const uint32_t full = sbase + L::BARS, empty = full + 8 * S;
  const uint32_t pfull = empty + 8 * S, pempty = pfull + 8;
  const int tn = (a.N + BN - 1) / BN, nk = (a.Kp + BK - 1) / BK;
  const int units = tn * ((a.M + BM - 1) / BM) * a.ks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);               // one per consumer group
    }
    mbar_init(pfull, 96);         // the staging warps' threads
    mbar_init(pempty, 2);         // one per consumer group
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // warp-uniform by construction, so the register split below applies
  const int wg = __shfl_sync(0xffffffff, threadIdx.x / 128, 0);

  if (wg == 0) {  // -- producer: one thread keeps the ring full ---------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;                 // k tiles loaded so far, over all units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at(u, tn, a.ks, nk);
        for (int i = w.kb; i < w.ke; ++i, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
          const uint32_t st = sbase + s * L::STAGE, bar = full + 8 * s;
          mbar_expect_tx(bar, L::STAGE);
          tma_load(st, &map_a, i * BK, w.m0, bar);
          if (MRQ) tma_load(st + A_BYTES, &map_b, i * BK, w.m0, bar);
          tma_load(st + R * A_BYTES, &map_w, i * BK, w.n0, bar);
        }
      }
    } else if (threadIdx.x >= 32) {  // warps 1-3: each unit's column rows
      stage_rows<MRQ>(a, smem + L::PARAMS, pfull, pempty, threadIdx.x - 32,
                      units, tn, nk);
    }
  } else {  // -- consumers: warpgroups 1 and 2, 64 rows each ---------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128, cw = ct >> 7, lt = ct & 127;
    const int lane = threadIdx.x & 31, warp = lt >> 5;
    const int M = a.M, N = a.N;
    const int r0 = cw * 64 + warp * 16 + (lane >> 2);  // rows r0, r0 + 8
    const int cq = 2 * (lane & 3);                     // + 8j: column pair
    const int g0 = group_at(a.g, 0, 0, a.G);
    volatile int* flag = reinterpret_cast<volatile int*>(smem + L::FLAG);
    int it = 0;                   // k tiles consumed so far, over all units
    const float* bias_s = reinterpret_cast<const float*>(smem + L::PARAMS);
    const float* pa = bias_s + BN;  // scale (B2: scale_neg) rows
    const float* pb = pa + GST * BN;  // corr (as int bits) or scale_pos rows
    float* ys = reinterpret_cast<float*>(smem + L::Y) + cw * 64 * YS;
    const int nst = a.gs ? min(a.G, GST) : 1;      // staged groups
    int n = 0;                    // units done
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const Unit w = unit_at(u, tn, a.ks, nk);
      int acc[R][72];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int e = 0; e < 72; ++e) acc[r][e] = 0;
        fence_regs(acc[r]);
      }
      for (int i = w.kb; i < w.ke; ++i, ++it) {
        const int s = it % S;
        mbar_wait(full + 8 * s, (it / S) & 1);
        const uint32_t st = sbase + s * L::STAGE;
        const uint64_t da = desc(st + cw * 64 * BK);
        const uint64_t dw = desc(st + R * A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          wgmma_n144(acc[0], da + 2 * kk, dw + 2 * kk);
          if (MRQ) wgmma_n144(acc[R - 1], desc(st + A_BYTES + cw * 64 * BK)
                                              + 2 * kk, dw + 2 * kk);
        }
        wgmma_commit();
        wgmma_wait<1>();            // the previous k tile's products are done
        if (i > w.kb && lt == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < R; ++r) fence_regs(acc[r]);
      if (lt == 0) mbar_arrive(empty + 8 * ((it - 1) % S));  // the last one

      if (a.ks > 1) {  // -- split K: sum in the workspace; the last CTA goes on
        const long plane = (long)M * N;
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 72; ++e) {
            const int row = w.m0 + r0 + ((e >> 1) & 1) * 8;
            const int col = w.n0 + (e >> 2) * 8 + cq + (e & 1);
            if (row < M && col < N)
              atomicAdd(a.ws + r * plane + (long)row * N + col, acc[r][e]);
          }
        __threadfence();
        bar_sync(1, 256);
        if (ct == 0) {
          int* cnt = a.ws + R * plane + w.tile;
          const int last = atomicAdd(cnt, 1) == a.ks - 1;
          if (last) *cnt = 0;
          *flag = last;
        }
        bar_sync(1, 256);
        if (!*flag) {               // another CTA finishes this tile
          if (lt == 0) mbar_arrive(pempty);
          continue;
        }
        __threadfence();
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 72; ++e) {
            const int row = w.m0 + r0 + ((e >> 1) & 1) * 8;
            const int col = w.n0 + (e >> 2) * 8 + cq + (e & 1);
            if (row < M && col < N)
              acc[r][e] = atomicExch(a.ws + r * plane + (long)row * N + col, 0);
          }
      }

      // -- epilogue, while the producer fills the ring with the next
      //    unit's tiles: dequant (+ bias) from the staged column rows in
      //    registers, y staged 72 columns at a time, then 8 columns a
      //    thread (+ gate * y + residual) and one write
      mbar_wait(pfull, n & 1);      // the column rows are staged
      // each row's column rows: staged (its group's slot), or in device
      // memory for a group past the staged ones; indexed by column
      const float* sa_row[2]; const float* sb_row[2]; const int* cr_row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w.m0 + r0 + 8 * h;
        const int grp = !a.gs ? g0 : row < M ? group_at(a.g, row, 1, a.G) : 0;
        const bool st = !a.gs || grp < nst;
        const long off = st ? (long)(a.gs ? grp : 0) * BN - w.n0
                            : (long)grp * N;
        sa_row[h] = (st ? pa : a.scale_a) + off;
        sb_row[h] = MRQ ? (st ? pb : a.scale_b) + off : nullptr;
        cr_row[h] = MRQ ? nullptr
                        : (st ? reinterpret_cast<const int*>(pb) : a.corr) + off;
      }
      const bool pairs = a.pairs_ok;   // 8-byte aligned column pairs
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int jj = 0; jj < HALF / 8; ++jj) {
          const int j = p * (HALF / 8) + jj, cl = 8 * j + cq;
          // the pair's column (past N: the last pair, results unused)
          const int col = min(w.n0 + cl, N - (pairs ? 2 : 1));
          const float2 bias = *reinterpret_cast<const float2*>(bias_s + cl);
          float2 sa[2], sb[2];
          int2 cr[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (h == 1 && !a.gs) {      // one group: row 8's rows are row 0's
              sa[1] = sa[0]; sb[1] = sb[0]; cr[1] = cr[0];
            } else if (pairs) {
              sa[h] = *reinterpret_cast<const float2*>(sa_row[h] + col);
              if (MRQ) sb[h] = *reinterpret_cast<const float2*>(sb_row[h] + col);
              else cr[h] = *reinterpret_cast<const int2*>(cr_row[h] + col);
            } else {
              const int c1 = min(col + 1, N - 1);
              sa[h] = make_float2(sa_row[h][col], sa_row[h][c1]);
              if (MRQ) sb[h] = make_float2(sb_row[h][col], sb_row[h][c1]);
              else cr[h] = make_int2(cr_row[h][col], cr_row[h][c1]);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * j + 2 * h;
            float2 y;
            if (!MRQ) {
              y.x = __fadd_rn(__fmul_rn((float)(acc[0][e] - cr[h].x), sa[h].x), bias.x);
              y.y = __fadd_rn(__fmul_rn((float)(acc[0][e + 1] - cr[h].y), sa[h].y),
                              bias.y);
            } else {
              y.x = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[0][e], sa[h].x),
                                        __fmul_rn((float)acc[R - 1][e], sb[h].x)),
                              bias.x);
              y.y = __fadd_rn(__fadd_rn(__fmul_rn((float)acc[0][e + 1], sa[h].y),
                                        __fmul_rn((float)acc[R - 1][e + 1], sb[h].y)),
                              bias.y);
            }
            *reinterpret_cast<float2*>(ys + (r0 - cw * 64 + 8 * h) * YS
                                       + cl - p * HALF) = y;
          }
        }
        bar_sync(2 + cw, 128);      // this group's half tile is staged
        if (p == 1 && lt == 0) mbar_arrive(pempty);   // rows read
        for (int idx = lt; idx < 64 * (HALF / 8); idx += 128) {
          const int rl = idx / (HALF / 8), c8 = (idx % (HALF / 8)) * 8;
          const int row = w.m0 + cw * 64 + rl, col = w.n0 + p * HALF + c8;
          if (row < M && col < N)
            store_chunk(a, row, col, min(8, N - col), ys + rl * YS + c8);
        }
        bar_sync(2 + cw, 128);      // ... and written: the buffer is free
      }
    }
  }
}

template <bool MRQ>
cudaError_t launch_gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                        const CUtensorMap& mw, GArgs g, cudaStream_t s) {
  constexpr int bytes = Layout<MRQ>::BYTES;
  int sms = 1;
  const cudaError_t e = kernel_sms<gemm_kernel<MRQ>>(bytes, &sms);
  if (e != cudaSuccess) return e;
  const int nk = (g.Kp + BK - 1) / BK;
  if (g.ks < 1 || g.ks > nk || (g.ks > 1 && !g.ws))
    return cudaErrorInvalidValue;
  g.vec_ok = g.N % 8 == 0 && aligned16(g.out)
             && (!g.gate || (aligned16(g.gate) && aligned16(g.res)));
  g.pairs_ok = g.N % 2 == 0 && aligned8(g.scale_a)
               && aligned8(MRQ ? (const void*)g.scale_b : (const void*)g.corr);
  // persistent: one CTA per SM (or per unit) walks the units
  const long units = (long)((g.N + BN - 1) / BN) * ((g.M + BM - 1) / BM) * g.ks;
  if (units > INT_MAX) return cudaErrorInvalidValue;
  gemm_kernel<MRQ><<<(unsigned)(units < sms ? units : sms), THREADS,
                     bytes, s>>>(ma, mb, mw, g);
  return cudaGetLastError();
}

}  // namespace

// The weights' tensor map: wt (N, Kp) int8, Kp % 16 == 0, in boxes of
// BN rows; written to map (128 host bytes, kept by the caller with wt).
extern "C" int int8_weight_map(void* map, const void* wt, int N, int Kp) {
  if (N <= 0 || Kp <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap m;
  const cudaError_t e = make_map(&m, wt, N, Kp, BN);
  if (e == cudaSuccess) memcpy(map, &m, sizeof m);
  return (int)e;
}

// codes_a/codes_b: (M, Kp) int8 scratch allocated by the caller; wmap: the
// tensor map of the weights transposed to (N, Kp) (int8_weight_map); ws:
// the split-K workspace (zeroed; 0 when ks == 1). g: device int32 group
// index (gs = 0) or per-row (M,) vector (gs = 1), each clamped into
// [0, G) on the device. sh, sc: the (B, K) adaLN modulation rows (f32, or
// bf16 with nm_bf16) at row strides sh_rs, sc_rs, or null.
extern "C" int int8_matmul_launch(
    const void* x, const void* wmap, const void* s_a, const void* s_b,
    const void* scale_a, const void* scale_b, const void* corr,
    const void* bias, const void* g, const void* ps, const void* bv,
    const void* sh, const void* sc, const void* gate, const void* res,
    void* out, void* codes_a, void* codes_b, void* ws, int M, int K, int Kp,
    int N, int half, int x_bf16, int nm_bf16, int res_bf16, int out_bf16,
    int mrq, int gs, int G, int ks, long sh_rs, long sc_rs, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % KPAD || (gs != 0 && gs != 1)
      || G <= 0)
    return (int)cudaErrorInvalidValue;
  const PArgs q = prologue_args(x, s_a, s_b, g, ps, bv, sh, sc, sh_rs, sc_rs,
                                codes_a, codes_b, M, K, Kp, half, Kp, Kp, gs,
                                G);
  GArgs a;
  a.scale_a = static_cast<const float*>(scale_a);
  a.scale_b = static_cast<const float*>(scale_b);
  a.corr = static_cast<const int*>(corr); a.bias = static_cast<const float*>(bias);
  a.g = q.g; a.bv = q.bv; a.gate = static_cast<const float*>(gate);
  a.res = res; a.out = out; a.ws = static_cast<int*>(ws);
  a.M = M; a.N = N; a.Kp = Kp; a.res_bf16 = res_bf16; a.out_bf16 = out_bf16;
  a.gs = gs; a.G = G; a.ks = ks;
  CUtensorMap ma, mb, mw;
  memcpy(&mw, wmap, sizeof mw);
  cudaError_t e = make_map(&ma, codes_a, M, Kp, BM);
  if (e == cudaSuccess) e = make_map(&mb, codes_b, M, Kp, BM);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = mrq ? launch_prologue<true>(q, x_bf16, nm_bf16, s)
          : launch_prologue<false>(q, x_bf16, nm_bf16, s);
  if (e != cudaSuccess) return (int)e;
  return (int)(mrq ? launch_gemm<true>(ma, mb, mw, a, s)
                   : launch_gemm<false>(ma, mb, mw, a, s));
}

// The prologue pass alone (kernels/prologue.py::codes): the codes of x
// into codes_a (and codes_b for MRQ), (M, Kq) int8, in the layout of gk,
// gkp (the int8 family: gk = gkp = Kq). Arguments as above.
extern "C" int prologue_codes_launch(
    const void* x, const void* s_a, const void* s_b, const void* g,
    const void* ps, const void* bv, const void* sh, const void* sc,
    void* codes_a, void* codes_b, int M, int K, int Kq, int half, int gk,
    int gkp, int x_bf16, int nm_bf16, int mrq, int gs, int G, long sh_rs,
    long sc_rs, void* stream) {
  if ((gs != 0 && gs != 1) || G <= 0 || (long)(Kq / gkp) * gk < K)
    return (int)cudaErrorInvalidValue;
  const PArgs q = prologue_args(x, s_a, s_b, g, ps, bv, sh, sc, sh_rs, sc_rs,
                                codes_a, codes_b, M, K, Kq, half, gk, gkp,
                                gs, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mrq ? launch_prologue<true>(q, x_bf16, nm_bf16, s)
                   : launch_prologue<false>(q, x_bf16, nm_bf16, s));
}

namespace {
__global__ void div_probe_kernel(const float* a, const float* b, float* q,
                                 float* r, long n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float y = __frcp_rn(b[i]);
  q[i] = div_rn(a[i], b[i], y, __fmul_rn(a[i], y));
  r[i] = rint_div(a[i], b[i], y);
}
}  // namespace

// q[i] = a[i] / b[i] by the shared correctly rounded quotient (div_rn)
// and r[i] = rint_div(a[i], b[i]), the prologue pass's rounded quotient:
// for tests/test_torch_cuda.py, which holds them against torch's division.
extern "C" int prologue_div_probe(const void* a, const void* b, void* q,
                                  void* r, long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  div_probe_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(q), static_cast<float*>(r), n);
  return (int)cudaGetLastError();
}

// B11 (repro/kernels/int8_matmul.py::int8_matmul): the caller's codes,
// quantized beforehand, through gemm_kernel<false> with one group and no
// quantize pass: y = (xq @ wq - corr) * scale + bias, B1's epilogue.
// xq: (M, Kp) int8, zero-padded along K, 16-byte aligned; wmap: the
// weights' tensor map; scale, bias: (N,) f32; corr: (N,) int32; g: a
// device int32 0; ws as above.
extern "C" int int8_gemm_codes_launch(
    const void* xq, const void* wmap, const void* scale, const void* corr,
    const void* bias, const void* g, void* out, void* ws, int M, int Kp,
    int N, int out_bf16, int ks, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % KPAD) return (int)cudaErrorInvalidValue;
  GArgs a = {};
  a.scale_a = a.scale_b = static_cast<const float*>(scale);
  a.corr = static_cast<const int*>(corr); a.bias = static_cast<const float*>(bias);
  a.g = static_cast<const int*>(g); a.out = out; a.ws = static_cast<int*>(ws);
  a.M = M; a.N = N; a.Kp = Kp; a.out_bf16 = out_bf16; a.gs = 0; a.G = 1;
  a.ks = ks;
  CUtensorMap ma, mw;
  memcpy(&mw, wmap, sizeof mw);
  const cudaError_t e = make_map(&ma, xq, M, Kp, BM);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_gemm<false>(ma, ma, mw, a, static_cast<cudaStream_t>(stream));
}

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
//   prologue pass reads each row's steps (csrc/prologue.cuh, gs = 1) and
//   each K-group rescale reads scale[gv[row], kg, col] (and corr).
//
// Two launches per call: the prologue pass (csrc/prologue.cuh: layernorm
// statistics, prologue, codes) writes the activation codes, (M, Kq) int8
// with each K group zero-padded to gkp = group_k rounded up to the
// 128-deep k tile (a zero code adds nothing, and corr counts only real
// rows), so no k tile straddles two scale groups; gemm4_kernel multiplies
// them by the nibble weights.
//
// What bounds gemm4_kernel on the card, at the DiT-XL/2 serving shapes:
// the s8 products at M = 2048 (1979 TOP/s int8 dense: qkv 8.2 us, fc2 22
// us), the weight stream at M = 8 (ada: 4 MB of nibbles, 1.2 us at 3.35
// TB/s). Two things stand in the way. Hopper's wgmma has no s4 operand.
// And the per-K-group f32 rescale must add the groups in ascending order,
// so K cannot be split: every 256-deep group ends in a stop where the s32
// partials become f32 (a shift, conversion, multiply and add per
// accumulator), ALU work worth 60 % of the group's tensor-core time.
//
// Design:
// - Operands swapped: the kernel computes y^T tiles. The weights are
//   wgmma's A operand, from registers; the activation codes are its B
//   operand, K-major in shared memory (TMA, 128-byte swizzle), as 8-bit
//   wgmma requires. A consumer warpgroup owns 64 output channels (wgmma's
//   M = 64) against BA activation rows (its N): BA = 128, MRQ 64 (two
//   region accumulators), and 8 for M <= 8 (ada, t_mlp, final_ada), so
//   those calls need no split K: each CTA streams its channels' nibbles
//   once, groups ascending.
// - The weights come from the wrapper's tiled copy (kernels/int4_packed.py
//   ::_weight_layout): per (128 channels, k tile of 128) one 8 KB block,
//   loaded whole by one TMA bulk copy, laid out so that each thread reads
//   its two channels' 16 bytes (4 k32 steps x 4 bytes) with two
//   conflict-free 16-byte shared loads. Each 4-byte word holds k 4t..4t+3
//   and 16+4t..19+4t of one channel: a mask and a byte permute (prmt) per
//   half widen it to two registers of the wgmma A fragment as 16 x code in
//   s8 (the nibble moved to the byte's high half: sign included, no
//   extension). The s32 partials are 16 x the exact products; >> 4 is
//   exact. MRQ widens once for its two region products.
// - Warp specialisation, 3 warpgroups, persistent (one CTA per SM walks
//   the tiles). Warpgroup 0 gives its registers away (setmaxnreg 40; the
//   consumers take 232) and its first thread keeps a ring of stages full
//   (code tile(s) + weight block, one full mbarrier each). Warpgroups 1 and
//   2 share the code tile and take 64 channels each.
// - The K-group rescale: the first product of each group overwrites the
//   s32 accumulators (wgmma scale-d = 0). The conversion to f32 adds the
//   partial to the bits of 1.5 x 2^23 and subtracts 1.5 x 2^23 (exact for
//   |p - corr| < 2^22, two full-rate instructions in place of the 1/8-rate
//   conversion unit); a warp whose corr values lie outside that range
//   converts with I2F. The group's scale (and corr) of the thread's two
//   channels are read before its products and used after them. The two
//   consumer warpgroups share the stages but not a lock step, so one's
//   rescale and epilogue overlap the other's products; making them take
//   turns per group (named barriers) measured slower and is not used.
// - Register A fragments: MRQ widens the next tile while this tile's
//   products run (two fragment sets). B4/B7a drain after each tile: with
//   one accumulator chain, double-buffered fragments make ptxas serialise
//   every wgmma (C7513).
// - VEC: a tile whose activation rows share one group (every tile at
//   serving: 256 tokens per image) reads one scale per channel as B4/B5
//   do; a tile of mixed groups (the M = 8 calls of the slot pool) reads
//   each accumulator's scale (and corr) by its row's group.
// - Epilogue: + bias per channel, y staged transposed through shared
//   memory per warpgroup, then gate, residual and out 16 bytes a thread
//   (csrc/hopper.cuh::store_chunk), in the plain version's op order.
//
// Exactness: the f32 steps are __fsub/__fmul_rn/__fadd_rn in the plain
// version's order, groups ascending, no split K, built with -fmad=false:
// bit-exact against the plain version (repro_torch/kernels/ref.py). A
// wait on an mbarrier that never completes traps.
#include "prologue.cuh"

namespace {

constexpr int BK = TMA_BK;          // k tile: 128 codes
constexpr int BW = 128;             // channels per tile: two warpgroups of 64
constexpr int WTILE = BW * BK / 2;  // nibble bytes per (channel tile, k tile)
constexpr int THREADS = 384;        // warpgroup 0 loads, 1 and 2 multiply
constexpr int MAX_GK = 32768;       // |16 x partial| < 2^25, |partial| <= 2^21

template <bool MRQ, int BA>
struct Layout {                     // dynamic shared memory (1024-aligned)
  static constexpr int R = MRQ ? 2 : 1;          // code tiles per stage
  static constexpr int ATILE = BA * BK;
  static constexpr int STAGE = R * ATILE + WTILE;
  static constexpr int STAGES = BA <= 8 ? 12 : 5;
  static constexpr int YS = 64 + 4;              // floats per staged y row
  static constexpr int Y = STAGES * STAGE;       // y: 2 warpgroups x BA x YS
  static constexpr int GRP = Y + 2 * BA * YS * 4;  // VEC: each row's group
  static constexpr int BARS = GRP + 2 * BA * 4;  // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stages keep the swizzle atoms aligned");
  static_assert(BYTES <= 232448, "fits in an SM's shared memory");
};

struct G4Args {
  const uint8_t* wt;                           // the weight tiles
  const float* scale_a; const float* scale_b;  // (G, nk, N)
  const int* corr; const float* bias; const int* g;
  const int* bv; const float* gate; const void* res; void* out;
  int M, N, nk;
  int tpg;              // k tiles per group (gkp / BK)
  int ntiles;           // k tiles holding any code of x
  int nkt;              // k tiles per channel tile of the weight copy
  int res_bf16, out_bf16;
  int G;                // groups in the stacks
  int lim;              // |corr| < lim: p - corr converts by the magic add
  int vec_ok;           // N % 8 == 0, out/gate/res 16-byte aligned
};

// d[64 x BA] += A[64 x 32] (registers) . B[BA x 32]^T (shared memory,
// K-major), s8 x s8 -> s32; acc = 0 overwrites d. d[4j + e]: channel
// 16 * warp + lane / 4 + 8 * (e >> 1), row 8j + 2 * (lane % 4) + (e & 1).
__device__ __forceinline__ void wgmma_rs(int (&d)[4], const unsigned (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[32], const unsigned (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(int (&d)[64], const unsigned (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// A thread's word of packed weights -> its two A fragment registers (k
// 4t..4t+3, 16+4t..19+4t), each code as 16 x code in one s8 byte.
__device__ __forceinline__ void widen(unsigned w, unsigned& a_lo, unsigned& a_hi) {
  const unsigned lo = (w << 4) & 0xF0F0F0F0u, hi = w & 0xF0F0F0F0u;
  a_lo = __byte_perm(lo, hi, 0x5140);
  a_hi = __byte_perm(lo, hi, 0x7362);
}

// True in every thread when pred holds in all n threads of barrier id.
__device__ __forceinline__ bool bar_all(int id, int n, bool pred) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 q, %1, 0;\n"
      "bar.red.and.pred p, %2, %3, q;\nselp.s32 %0, 1, 0, p;\n}\n"
      : "=r"(r) : "r"((int)pred), "r"(id), "r"(n) : "memory");
  return r != 0;
}

// One k tile: the thread's two channels' words (w, w + 512) widened into
// the register A fragments f (f[s]: k32 step s; a0/a2 channel gid, a1/a3
// channel gid + 8), then 4 products per region against the code tile(s)
// at st, committed as one wgmma group. first: the group's first tile (its
// first product overwrites the accumulators).
template <bool MRQ, int NR>
__device__ __forceinline__ void issue_tile(int (&acc)[MRQ ? 2 : 1][NR],
                                           unsigned (&f)[4][4],
                                           const uint8_t* w, uint32_t st,
                                           int atile, bool first) {
  const uint4 r0 = *reinterpret_cast<const uint4*>(w);
  const uint4 r1 = *reinterpret_cast<const uint4*>(w + 512);
  widen(r0.x, f[0][0], f[0][2]); widen(r1.x, f[0][1], f[0][3]);
  widen(r0.y, f[1][0], f[1][2]); widen(r1.y, f[1][1], f[1][3]);
  widen(r0.z, f[2][0], f[2][2]); widen(r1.z, f[2][1], f[2][3]);
  widen(r0.w, f[3][0], f[3][2]); widen(r1.w, f[3][1], f[3][3]);
  fence_regs(f);    // every fragment defined before the first product, or
  wgmma_fence();    // ptxas serialises the wgmmas (C7513)
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int keep = !(first && k == 0);
    wgmma_rs(acc[0], f[k], desc(st) + 2 * k, keep);
    if (MRQ) wgmma_rs(acc[MRQ ? 1 : 0], f[k], desc(st + atile) + 2 * k, keep);
  }
  wgmma_commit();
}

template <bool MRQ, bool VEC, int BA>
__global__ void __launch_bounds__(THREADS, 1)
gemm4_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, const G4Args a) {
  using L = Layout<MRQ, BA>;
  constexpr int R = L::R, S = L::STAGES, NR = BA / 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = su32(smem);
  const uint32_t full = sbase + L::BARS, empty = full + 8 * S;
  const int M = a.M, N = a.N;
  const int tm = (M + BA - 1) / BA;              // units: (channel tile, row tile)
  const int units = tm * ((N + BW - 1) / BW);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);               // one per consumer group
    }
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
        const int m0 = (u % tm) * BA;
        const uint8_t* w = a.wt + (long)(u / tm) * a.nkt * WTILE;
        for (int i = 0; i < a.ntiles; ++i, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
          const uint32_t st = sbase + s * L::STAGE, bar = full + 8 * s;
          mbar_expect_tx(bar, L::STAGE);
          tma_load(st, &map_a, i * BK, m0, bar);
          if (MRQ) tma_load(st + L::ATILE, &map_b, i * BK, m0, bar);
          bulk_load(st + R * L::ATILE, w + (long)i * WTILE, WTILE, bar);
        }
      }
    }
  } else {  // -- consumers: warpgroups 1 and 2, 64 channels each -------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ct = threadIdx.x - 128, cw = ct >> 7, lt = ct & 127;
    const int warp = lt >> 5, lane = threadIdx.x & 31;
    const int nl = 16 * warp + (lane >> 2);       // channels nl, nl + 8
    const int tq = lane & 3;                      // + 8j: row pair 2 tq
    float* ys = reinterpret_cast<float*>(smem + L::Y) + cw * BA * L::YS;
    int* grp_s = reinterpret_cast<int*>(smem + L::GRP) + cw * BA;
    // this thread's 16-byte words in a stage's weight block
    const uint8_t* wfrag = smem + R * L::ATILE + (cw * 8 + warp * 2) * 512
                           + lane * 16;
    int acc[R][NR];
    unsigned fa[4][4], fb[4][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[r][e] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) fa[k][j] = fb[k][j] = 0;
    int it = 0;                   // k tiles consumed so far, over all units
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u % tm) * BA;
      const int c0 = (u / tm) * BW + 64 * cw;     // this warpgroup's channels
      const int ch[2] = {min(c0 + nl, N - 1), min(c0 + nl + 8, N - 1)};
      // the tile's group: the call's, or its rows' when they share one
      int tg = group_at(a.g, VEC ? min(m0, M - 1) : 0, VEC, a.G);
      bool mixed = false;
      if (VEC) {
        int mine = tg;
        if (lt < BA) {
          mine = group_at(a.g, min(m0 + lt, M - 1), 1, a.G);
          grp_s[lt] = mine;
        }
        mixed = !bar_all(3 + cw, 128, mine == tg);
      }
      float facc[NR];
#pragma unroll
      for (int e = 0; e < NR; ++e) facc[e] = 0.f;
      for (int kg = 0; kg < a.nk; ++kg) {
        const int kb = kg * a.tpg, ke = min(kb + a.tpg, a.ntiles);
        // the group's scale (and corr) of the thread's two channels: read
        // now, used after the products
        float sa[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
        int cr[2] = {0, 0};
        if (!mixed) {
          const long o = ((long)tg * a.nk + kg) * N;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sa[h] = __ldg(a.scale_a + o + ch[h]);
            if (MRQ) sb[h] = __ldg(a.scale_b + o + ch[h]);
            else cr[h] = __ldg(a.corr + o + ch[h]);
          }
        }
        // the group's products, tile by tile. MRQ double-buffers the
        // fragments (the next tile's widening overlaps this one's
        // products); one accumulator chain fed that way makes ptxas
        // serialise every wgmma (C7513), so B4/B7a drain after each tile
        for (int i = kb; i < ke; i += MRQ ? 2 : 1) {
          int s = it % S;
          mbar_wait(full + 8 * s, (it / S) & 1);
          issue_tile<MRQ, NR>(acc, fa, wfrag + s * L::STAGE,
                              sbase + s * L::STAGE, L::ATILE, i == kb);
          ++it;
          if (!MRQ) {
            wgmma_wait<0>();
            fence_regs(fa);
            if (lt == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
            continue;
          }
          wgmma_wait<1>();          // tile i - 1 is done: its stage and fb
          fence_regs(fb);
          if (i > kb && lt == 0) mbar_arrive(empty + 8 * ((it - 2) % S));
          if (i + 1 < ke) {
            s = it % S;
            mbar_wait(full + 8 * s, (it / S) & 1);
            issue_tile<MRQ, NR>(acc, fb, wfrag + s * L::STAGE,
                                sbase + s * L::STAGE, L::ATILE, false);
            ++it;
            wgmma_wait<1>();        // tile i is done: its stage and fa
            fence_regs(fa);
            if (lt == 0) mbar_arrive(empty + 8 * ((it - 2) % S));
          }
        }
        if (MRQ) {
          wgmma_wait<0>();
          fence_regs(fa);
          fence_regs(fb);
          if (lt == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
        }
#pragma unroll
        for (int r = 0; r < R; ++r) fence_regs(acc[r]);

        // -- the group's rescale: acc + (p - corr) * scale, or acc + (pn *
        //    scale_neg + pp * scale_pos), p = the s32 partial >> 4
        if (!mixed) {
          if (MRQ || __all_sync(0xffffffffu, cr[0] > -a.lim && cr[0] < a.lim
                                             && cr[1] > -a.lim && cr[1] < a.lim)) {
            const int cm[2] = {MAGIC - cr[0], MAGIC - cr[1]};
#pragma unroll
            for (int e = 0; e < NR; ++e) {
              const int h = (e >> 1) & 1;
              float t;
              if (!MRQ) {
                t = __fmul_rn(__fsub_rn(__int_as_float((acc[0][e] >> 4) + cm[h]),
                                        FMAGIC), sa[h]);
              } else {
                t = __fadd_rn(
                    __fmul_rn(__fsub_rn(__int_as_float((acc[0][e] >> 4) + MAGIC),
                                        FMAGIC), sa[h]),
                    __fmul_rn(__fsub_rn(__int_as_float((acc[R - 1][e] >> 4) + MAGIC),
                                        FMAGIC), sb[h]));
              }
              facc[e] = __fadd_rn(facc[e], t);
            }
          } else {
#pragma unroll
            for (int e = 0; e < NR; ++e) {
              const int h = (e >> 1) & 1;
              facc[e] = __fadd_rn(facc[e],
                                  __fmul_rn((float)((acc[0][e] >> 4) - cr[h]), sa[h]));
            }
          }
        } else {                    // each row's own group
#pragma unroll
          for (int e = 0; e < NR; ++e) {
            const int h = (e >> 1) & 1, ml = 8 * (e >> 2) + 2 * tq + (e & 1);
            const long o = ((long)grp_s[ml] * a.nk + kg) * N + ch[h];
            float t;
            if (!MRQ) {
              t = __fmul_rn((float)((acc[0][e] >> 4) - __ldg(a.corr + o)),
                            __ldg(a.scale_a + o));
            } else {
              t = __fadd_rn(__fmul_rn((float)(acc[0][e] >> 4), __ldg(a.scale_a + o)),
                            __fmul_rn((float)(acc[R - 1][e] >> 4), __ldg(a.scale_b + o)));
            }
            facc[e] = __fadd_rn(facc[e], t);
          }
        }
      }

      // -- epilogue: + bias, y staged transposed (row, 64 channels), then 8
      //    channels a thread (+ gate * y + residual) and one write
      float bias[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bias[h] = c0 + nl + 8 * h < N ? __ldg(a.bias + c0 + nl + 8 * h) : 0.f;
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int h = (e >> 1) & 1, ml = 8 * (e >> 2) + 2 * tq + (e & 1);
        ys[ml * L::YS + nl + 8 * h] = __fadd_rn(facc[e], bias[h]);
      }
      bar_sync(3 + cw, 128);        // this warpgroup's tile is staged
      for (int idx = lt; idx < BA * 8; idx += 128) {
        const int ml = idx >> 3, c8 = (idx & 7) * 8;
        const int row = m0 + ml, col = c0 + c8;
        if (row < M && col < N)
          store_chunk(a, row, col, min(8, N - col), ys + ml * L::YS + c8);
      }
      bar_sync(3 + cw, 128);        // ... and written: the buffer is free
    }
  }
}

template <bool MRQ, bool VEC, int BA>
cudaError_t launch_gemm4(const CUtensorMap& ma, const CUtensorMap& mb,
                         const G4Args& g, cudaStream_t s) {
  constexpr int bytes = Layout<MRQ, BA>::BYTES;
  int sms = 1;
  const cudaError_t e = kernel_sms<gemm4_kernel<MRQ, VEC, BA>>(bytes, &sms);
  if (e != cudaSuccess) return e;
  // persistent: one CTA per SM (or per unit) walks the units
  const long units = (long)((g.M + BA - 1) / BA) * ((g.N + BW - 1) / BW);
  if (units > INT_MAX) return cudaErrorInvalidValue;
  gemm4_kernel<MRQ, VEC, BA><<<(unsigned)(units < sms ? units : sms), THREADS,
                               bytes, s>>>(ma, mb, g);
  return cudaGetLastError();
}

// The activation tile width: 8 rows for the weight streams (M <= 8), else
// 128 (MRQ: 64, two region accumulators).
template <bool MRQ, bool VEC>
cudaError_t run(const PArgs& q, const G4Args& g, int x_bf16, int nm_bf16,
                cudaStream_t s) {
  const int ba = g.M <= 8 ? 8 : MRQ ? 64 : 128;
  CUtensorMap ma, mb;
  cudaError_t e = make_map(&ma, q.qa, g.M, q.Kq, ba);
  if (e == cudaSuccess) e = make_map(&mb, q.qb, g.M, q.Kq, ba);
  if (e == cudaSuccess) e = launch_prologue<MRQ>(q, x_bf16, nm_bf16, s);
  if (e != cudaSuccess) return e;
  if (ba == 8) return launch_gemm4<MRQ, VEC, 8>(ma, mb, g, s);
  return launch_gemm4<MRQ, VEC, MRQ ? 64 : 128>(ma, mb, g, s);
}

}  // namespace

// wt: the packed weights tiled by kernels/int4_packed.py::_weight_layout:
// ceil(N / 128) x (Kq / 128) blocks of 8192 bytes, channel tile major;
// Kq = nk * gkp, gkp % 128 == 0, each K group zero-padded to gkp / 2 bytes.
// codes_a/codes_b: (M, Kq) int8 scratch allocated by the caller.
// g: device int32 group index (gs = 0) or per-row (M,) vector (gs = 1),
// each clamped into [0, G) on the device.
extern "C" int int4_matmul_launch(
    const void* x, const void* wt, const void* s_a, const void* s_b,
    const void* scale_a, const void* scale_b, const void* corr,
    const void* bias, const void* g, const void* ps, const void* bv,
    const void* sh, const void* sc, const void* gate, const void* res,
    void* out, void* codes_a, void* codes_b, int M, int K, int Kq, int N,
    int gk, int gkp, int nk, int x_bf16, int nm_bf16, int res_bf16,
    int out_bf16, int mrq, int gs, int G, long sh_rs, long sc_rs,
    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || gk <= 0 || gk % 2 || gk > MAX_GK
      || gkp < gk || gkp % BK || Kq != nk * gkp || nk * gk < K
      || (nk - 1) * gk >= K || (gs != 0 && gs != 1) || G <= 0
      || reinterpret_cast<uintptr_t>(wt) % 16)
    return (int)cudaErrorInvalidValue;
  const PArgs q = prologue_args(x, s_a, s_b, g, ps, bv, sh, sc, sh_rs, sc_rs,
                                codes_a, codes_b, M, K, Kq, 8, gk, gkp, gs, G);
  G4Args a;
  a.wt = static_cast<const uint8_t*>(wt);
  a.scale_a = static_cast<const float*>(scale_a);
  a.scale_b = static_cast<const float*>(scale_b);
  a.corr = static_cast<const int*>(corr); a.bias = static_cast<const float*>(bias);
  a.g = q.g; a.bv = q.bv; a.gate = static_cast<const float*>(gate);
  a.res = res; a.out = out;
  a.M = M; a.N = N; a.nk = nk; a.tpg = gkp / BK; a.nkt = Kq / BK;
  // code columns up to the last real row of the last group
  a.ntiles = ((nk - 1) * gkp + (K - (nk - 1) * gk) + BK - 1) / BK;
  a.res_bf16 = res_bf16; a.out_bf16 = out_bf16; a.G = G;
  a.lim = (1 << 22) - 64 * gk;    // |partial| <= 64 gk (codes in [-8, 8])
  a.vec_ok = N % 8 == 0 && aligned16(out)
             && (!gate || (aligned16(gate) && aligned16(res)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mrq) e = gs ? run<true, true>(q, a, x_bf16, nm_bf16, s)
                  : run<true, false>(q, a, x_bf16, nm_bf16, s);
  else e = gs ? run<false, true>(q, a, x_bf16, nm_bf16, s)
              : run<false, false>(q, a, x_bf16, nm_bf16, s);
  return (int)e;
}

// Shared by the port's Hopper GEMMs (csrc/int8_fused.cu::gemm_kernel and
// csrc/int4_packed.cu::gemm4_kernel): mbarriers, TMA loads (tensor-map
// and plain bulk copies), wgmma descriptors and fences, named barriers,
// the staged epilogue's 16-byte row stores, and the host's tensor-map
// encoder.
#pragma once

#include "common.cuh"

#include <cuda.h>      // CUtensorMap and its enums; cuTensorMapEncodeTiled
#include <limits.h>    // is fetched at run time (no libcuda at link time)
#include <string.h>

namespace {

constexpr int TMA_BK = 128;     // k box of every code tile: one swizzle row

__device__ __forceinline__ uint32_t su32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Wait until the barrier's phase of this parity has completed; trap after
// ~2^28 polls (seconds), far beyond any legitimate wait.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (unsigned n = 0;; ++n) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (n == (1u << 28)) __trap();
  }
}
// One 2-D TMA box (k, row) of a tensor map into shared memory, counted
// on the barrier's transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row),
         "r"(bar)
      : "memory");
}
// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) by the TMA
// unit's plain bulk copy, counted on the barrier's transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: 8-row core groups 1024 bytes apart (SBO), LBO unused.
// Adding 2 (32 bytes) steps one k32 slice along the swizzled row.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32)
         | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or reuses of registers that an
// async wgmma reads or writes (accumulators, register A fragments) across
// the wait that completes it.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <typename T, int N, int M>
__device__ __forceinline__ void fence_regs(T (&d)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(d[i]);
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void unpack8(const float4& a, const float4& b,
                                        float (&v)[8]) {
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// 8 values from 16-byte aligned memory (32 bytes of f32, 16 of bf16)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  unpack8(__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1), v);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Epilogue, second pass: y of n <= 8 columns of one row (staged, 16-byte
// aligned), (+ gate * y + residual), one write: 16 bytes a thread where
// the row allows, else one column at a time. A: the kernel's arguments
// (N, gate, bv, res, out, res_bf16, out_bf16, vec_ok).
template <typename A>
__device__ __forceinline__ void store_chunk(const A& a, int row, int col,
                                            int n, const float* ys) {
  float y[8];
  unpack8(*reinterpret_cast<const float4*>(ys),
          *reinterpret_cast<const float4*>(ys + 4), y);
  const long o = (long)row * a.N + col;
  if (n == 8 && a.vec_ok) {
    if (a.gate) {
      float gt[8], rs[8];
      load8(a.gate + (long)a.bv[row] * a.N + col, gt);
      if (a.res_bf16) load8(static_cast<const __nv_bfloat16*>(a.res) + o, rs);
      else load8(static_cast<const float*>(a.res) + o, rs);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = __fadd_rn(rs[i], __fmul_rn(gt[i], y[i]));
    }
    if (a.out_bf16) store8(static_cast<__nv_bfloat16*>(a.out) + o, y);
    else store8(static_cast<float*>(a.out) + o, y);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i >= n) break;
    float v = y[i];
    if (a.gate) {
      const float r = a.res_bf16
          ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.res)[o + i])
          : static_cast<const float*>(a.res)[o + i];
      v = __fadd_rn(r, __fmul_rn(a.gate[(long)a.bv[row] * a.N + col + i], v));
    }
    if (a.out_bf16) static_cast<__nv_bfloat16*>(a.out)[o + i] = __float2bfloat16_rn(v);
    else static_cast<float*>(a.out)[o + i] = v;
  }
}

// -- host side ---------------------------------------------------------------
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {         // libcuda's cuTensorMapEncodeTiled, once
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a K-major (rows, Kp) int8 matrix, in boxes of box_rows x
// TMA_BK bytes, 128-byte swizzle, zero fill outside the matrix.
cudaError_t make_map(CUtensorMap* map, const void* p, int rows, int Kp,
                     int box_rows) {
  EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(p) % 16 || Kp % 16)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)TMA_BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }
int aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

// Once a device and kernel: the kernel's shared-memory size attribute and
// the SM count (a persistent grid has one CTA per SM). Returns the
// attribute's error, or cudaSuccess and *sms_out.
template <auto Kernel>
cudaError_t kernel_sms(int bytes, int* sms_out) {
  static cudaError_t attr[64];
  static int sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    attr[dev] = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr[dev] == cudaSuccess)
      attr[dev] = cudaDeviceGetAttribute(&sms[dev],
                                         cudaDevAttrMultiProcessorCount, dev);
    if (attr[dev] != cudaSuccess) sms[dev] = 1;
  }
  *sms_out = sms[dev];
  return attr[dev];
}

}  // namespace

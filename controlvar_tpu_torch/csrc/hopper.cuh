// Hopper (sm_90a) building blocks shared by the TMA/wgmma decode kernels:
// mbarriers, named barriers, TMA tile loads and stores and the tensor-map
// prefetch, wgmma with A from registers or from shared memory and B from
// 128-byte-swizzled shared memory, the online-softmax step on a wgmma score
// fragment, and the host-side tensor-map encoder. Raw PTX only, so a source
// that includes this builds in seconds (no CUTLASS, no PyTorch).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only: nothing links libcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace hopper {

constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernels

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA

// a 4-D box {c0, c1, c2, c3} (innermost first) of `map` into shared memory
// at `dst`, completing `bytes` of `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared memory at `src` to a 4-D box of `map`; rows outside the map's
// extent are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the committed stores are complete
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// brings a __grid_constant__ tensor map into the TMA unit's descriptor cache
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"((uint64_t)map) : "memory");
}

// --------------------------------------------------------- named barriers

// wait at barrier `id` until `n` threads (this one included) have arrived
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------- wgmma

// Shared-memory descriptor of a tile with 128-byte rows in TMA's 128-byte
// swizzle (base 1024-byte aligned): 8-row groups 1024 bytes apart (SBO).
// K-major operands step k by +32 bytes of the start address, MN-major ones
// (one 64-element swizzle atom wide) by +2048 bytes (16 rows).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define HOPPER_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F8(i) HOPPER_F4(i), HOPPER_F4(i + 4)

// D (+)= A . B, one wgmma m64nNk16 with A from registers. D is 64 x N fp32,
// the fragment at d[0 .. N/2) (d[4n + j]: row g + 8 (j >> 1) of each warp's
// 16, column 8n + 2t + (j & 1)); A is 64 x 16 bf16, the mma.sync m16n8k16 A
// fragment of each warp's 16 rows; B is 16 x N in shared memory at `desc`,
// stored K-major (TB = 0) or MN-major (TB = 1). acc = 0 overwrites D.
// Load A's registers afresh before each use: ptxas (CUDA 12.8) gave the
// registers of A fragments that were only read, and live across a loop of
// these wgmma, to other values after the loop's first pass (the second
// tile's q.K^T then read P), so the kernels keep q's fragments in shared
// memory and reload them for every tile.
template <int N, int TB>
struct WgmmaRS;

template <int TB>
struct WgmmaRS<16, TB> {
  __device__ __forceinline__ static void run(float* d, const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : HOPPER_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<32, TB> {
  __device__ __forceinline__ static void run(float* d, const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<64, TB> {
  __device__ __forceinline__ static void run(float* d, const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc), "n"(TB));
  }
};

// D (+)= A . B, one wgmma m64nNk16 with A and B both in shared memory,
// both K-major in the 128-byte swizzle (descriptors from smem_desc)
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int acc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
        : "l"(desc_a), "l"(desc_b), "r"(acc));
  }
};

#undef HOPPER_F8
#undef HOPPER_F4

// ----------------------------------------------------- softmax and packing

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One 64-key tile of the online softmax on a 64 x 64 wgmma score fragment
// (s[4n + j]: row g + 8 (j >> 1), key 8n + 2t + (j & 1)), already masked:
// updates the running max and denominator of rows g and g + 8, turns s
// into p = exp(s - m) (the denominator sums the unrounded p), packs p to
// bf16 A fragments of the four 16-key chunks and returns in `alpha` the
// factor that rescales the output accumulator.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m_run)[2],
                                             float (&l_part)[2], float (&alpha)[2],
                                             uint32_t (&pa)[4][4]) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    alpha[r] = __expf(m_run[r] - m_new);
    m_run[r] = m_new;
    l_part[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = __expf(s[i] - m_run[(i >> 1) & 1]);
    l_part[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const float* a = &s[8 * kc];  // key n-tiles 2 kc and 2 kc + 1
    pa[kc][0] = pack_bf16(a[0], a[1]);
    pa[kc][1] = pack_bf16(a[2], a[3]);
    pa[kc][2] = pack_bf16(a[4], a[5]);
    pa[kc][3] = pack_bf16(a[6], a[7]);
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softmax_tile with exp(s - m) taken as 2^(s log2e - m log2e): one FFMA and
// one MUFU.EX2 a score where __expf(s - m) takes an FADD, an FMUL and the
// MUFU (at hd = 64 a tile's exponentials, at 16 a clock, take as many SM
// clocks as its two products at the bf16 peak). Probabilities below
// 2^-126 flush to 0.
__device__ __forceinline__ void softmax_tile_ex2(float (&s)[32], float (&m_run)[2],
                                                 float (&l_part)[2], float (&alpha)[2],
                                                 uint32_t (&pa)[4][4]) {
  constexpr float L2E = 1.4426950408889634f;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_ml[2];  // -m log2e of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
    alpha[r] = ex2_approx((m_run[r] - m_new) * L2E);
    m_run[r] = m_new;
    l_part[r] *= alpha[r];
    neg_ml[r] = -m_new * L2E;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2_approx(fmaf(s[i], L2E, neg_ml[(i >> 1) & 1]));
    l_part[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const float* a = &s[8 * kc];  // key n-tiles 2 kc and 2 kc + 1
    pa[kc][0] = pack_bf16(a[0], a[1]);
    pa[kc][1] = pack_bf16(a[2], a[3]);
    pa[kc][2] = pack_bf16(a[4], a[5]);
    pa[kc][3] = pack_bf16(a[6], a[7]);
  }
}

// O (64 x N wgmma fragment: o[4n + j], row g + 8 (j >> 1), column 8n + 2t +
// (j & 1)) times the per-row factors
template <int M>
__device__ __forceinline__ void scale_rows(float (&o)[M], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < M; ++i) o[i] *= f[(i >> 1) & 1];
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A 4-D bf16 map, dims innermost first, dim 0 dense; strides in elements of
// dims 1..3; boxes of box0 x box1 x 1 x 1 in the 128-byte swizzle (box0
// must be 64: 128-byte rows). Reads outside the dims are zero-filled.
inline bool encode_4d(CUtensorMap* map, const void* base, const long long (&dims)[4],
                      const long long (&strides)[3], int box0, int box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[4], gstride[3];
  for (int i = 0; i < 4; ++i) gdim[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 3; ++i) gstride[i] = (cuuint64_t)strides[i] * sizeof(__nv_bfloat16);
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), gdim, gstride,
            box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace hopper

// Flat-layout decode attention (K7) for Hopper (sm_90a), bf16, any head dim
// that is a multiple of 16 from 16 to 128.
//
// Replaces the TPU kernel controlvar_tpu/ops/attention.py:flash_decode
// (_decode_kernel / _decode_kernel_masked): for every (batch, head), out =
// softmax(q*scale . K^T [mask -> -1e30]) . V over cache rows [0, cur) of one
// layer of the FLAT, transposed (depth, B, H, hd, L_max) cache, the layout the
// JAX package keeps when head_dim != 64 or the head count is odd (kv_layout
// "flat"). Rounding points follow the TPU kernel: q*scale is rounded to bf16
// before the first product (fp32 scores), and the probabilities are rounded
// to bf16 before the second.
//
// What bounds it on the H100: at VAR-d13's final scale (128 CFG rows, 13
// heads of 64, l = 256, cur = 680) the two products are 7.4e10 FLOP, 0.075 ms
// at 989 TFLOP/s, against 0.40 GB of q, K, V and out, 0.119 ms at 3.35 TB/s:
// the bytes bound it.
//
// Design: one block per (q group, batch*head), the q group fastest in the
// grid, so the blocks of one head run together and each K/V tile comes from
// HBM once and from L2 for the others; the grid runs over B*H, so an odd
// head count needs nothing of its own. A q group is 64 rows (one consumer
// warpgroup) at l <= 64 and 128 rows (two) above: at the final scale two
// blocks a head, two blocks an SM at hd <= 64 (four-warpgroup blocks, one a
// head, measured no faster). One producer warp streams the K^T and V^T
// tiles, hd rows of 64 keys (128-byte rows at every hd), with TMA
// (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 4 stages paced by
// full and empty mbarriers. The tensor maps end at key cur, so TMA
// zero-fills the tile that straddles it and reads nothing at or past it;
// scores past cur are -inf (weight 0). Each consumer warpgroup reads its 64
// rows of q through their strides (the fused QKV's view, no copy) into
// wgmma A fragments of q*scale (kept in shared memory, reloaded per tile:
// see hopper.cuh); S = q K^T is wgmma m64n64k16 with the K^T
// tile as B stored MN-major (the transpose bit), and O += P V takes P from
// registers and the V^T tile as B stored K-major (m64n64 / n32 / n16 pieces
// covering hd), fp32 accumulators in registers. The ring takes 1 KB per
// head dim, the q fragments 128 bytes per head dim and warpgroup, of
// dynamic shared memory (161 KB at hd = 128). ptxas (CUDA 12.8, sm_90a):
// 93 (hd 16) to 154 (hd 128) registers; at hd 32 to 64 the two-warpgroup
// instances, held to two blocks an SM, take 96 and spill 4 to 132 bytes,
// which measured faster than one block an SM without spills (PERF.md
// §11.6).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::smem_desc;
using hopper::smem_u32;

constexpr int BK = 64;      // keys per tile
constexpr int STAGES = 4;   // the TMA ring

// a (B, H, l, HD) bf16 operand read through its (batch, head, row) strides
struct Rows {
  const __nv_bfloat16* p;
  long long sb, sh, sr;
};

// the ring, each consumer thread's q fragments, and alignment to 1024
template <int HD, int NWG>
constexpr int smem_bytes() { return STAGES * 2 * HD * 128 + NWG * 128 * HD + 1024; }

// O (64 x HD) += P (64 x 16 keys, registers) . V^T tile's 16 keys at `vt`
// (hd rows of 128 bytes, K-major), in wgmma pieces of 64, 32 and 16 columns
template <int HD>
__device__ __forceinline__ void pv_chunk(float (&o)[HD / 2], const uint32_t (&pa)[4],
                                         uint32_t vt) {
#pragma unroll
  for (int c = 0; c + 64 <= HD; c += 64) {
    hopper::WgmmaRS<64, 0>::run(&o[c / 2], pa, smem_desc(vt + c * 128), 1);
  }
  constexpr int c32 = HD / 64 * 64;
  if constexpr (HD - c32 >= 32) {
    hopper::WgmmaRS<32, 0>::run(&o[c32 / 2], pa, smem_desc(vt + c32 * 128), 1);
  }
  constexpr int c16 = c32 + (HD - c32 >= 32 ? 32 : 0);
  if constexpr (HD - c16 >= 16) {
    hopper::WgmmaRS<16, 0>::run(&o[c16 / 2], pa, smem_desc(vt + c16 * 128), 1);
  }
}

template <int HD, int NWG>  // NWG consumer warpgroups: q rows per block = 64 NWG
__global__ void __launch_bounds__(NWG * 128 + 32, HD > 64 ? 1 : 2)
decode_flat_kernel(const __grid_constant__ CUtensorMap km,  // layer's K^T, keys [0, cur)
                   const __grid_constant__ CUtensorMap vm,  // layer's V^T
                   Rows q,                                  // (B, H, l, HD)
                   const uint8_t* __restrict__ mask,        // (l, cur) or null
                   __nv_bfloat16* __restrict__ out,         // (B*H, l, HD)
                   int H, int l, int cur, float scale) {
  constexpr int TILE = HD * 128;  // bytes of one K^T or V^T tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: K^T, then V^T
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row_blk = blockIdx.x * NWG * 64;
  const int n_wg = min(NWG, (l - row_blk + 63) / 64);  // warpgroups with q rows
  const int ntiles = (cur + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(smem_u32(&full[s]), 1);
      hopper::mbar_init(smem_u32(&empty[s]), 4 * n_wg);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp
    if (lane == 0) {
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(smem_u32(&empty[s]), (it / STAGES - 1) & 1);
        const uint32_t kdst = ring + s * 2 * TILE, bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, 2 * TILE);
        hopper::tma_load_4d(kdst, &km, bar, it * BK, 0, h, b);
        hopper::tma_load_4d(kdst + TILE, &vm, bar, it * BK, 0, h, b);
      }
    }
    return;
  }
  const int wg = warp / 4;
  if (wg >= n_wg) return;

  const int g = lane / 4, t = lane % 4;                  // fragment row / column pair
  const int row0 = row_blk + wg * 64 + (warp % 4) * 16;  // this warp's first q row
  // q*scale as A fragments, rounded to bf16 (rows past l are zero), kept in
  // shared memory and loaded afresh for every tile: see hopper.cuh
  const __nv_bfloat16* qb = q.p + b * q.sb + h * q.sh;
  uint4* qs = reinterpret_cast<uint4*>(smem_raw + (ring - smem_u32(smem_raw)) +
                                       STAGES * 2 * TILE) + tid;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + g + (j & 1) * 8, c = kk * 16 + 2 * t + (j >> 1) * 8;
      float2 f = make_float2(0.f, 0.f);
      if (r < l) {
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qb + (long long)r * q.sr + c));
      }
      a[j] = hopper::pack_bf16(f.x * scale, f.y * scale);
    }
    qs[kk * NWG * 128] = make_uint4(a[0], a[1], a[2], a[3]);
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {hopper::NEG_INF, hopper::NEG_INF}, l_part[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES, t0 = it * BK;
    mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
    const uint32_t kt = ring + s * 2 * TILE, vt = kt + TILE;

    // S = (q*scale) K^T: the K^T tile [hd][key] is B stored MN-major
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint4 v = qs[kk * NWG * 128];
      const uint32_t a[4] = {v.x, v.y, v.z, v.w};
      hopper::WgmmaRS<BK, 1>::run(sc, a, smem_desc(kt + 2048 * kk), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    fence_regs(sc);

    // mask (-1e30, as the reference) and the ragged end (-inf: weight 0)
    if (mask != nullptr || t0 + BK > cur) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = t0 + 8 * (i >> 2) + 2 * t + (i & 1), r = row0 + g + 8 * ((i >> 1) & 1);
        if (col >= cur) {
          sc[i] = -CUDART_INF_F;
        } else if (mask != nullptr && r < l && !mask[(long long)r * cur + col]) {
          sc[i] = hopper::NEG_INF;
        }
      }
    }
    float alpha[2];
    uint32_t pa[BK / 16][4];
    hopper::softmax_tile(sc, m_run, l_part, alpha, pa);
    hopper::scale_rows(o, alpha);

    // O += P V: the V^T tile [hd][key] is B stored K-major
    fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) pv_chunk<HD>(o, pa[kc], vt + 32 * kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    fence_regs(o);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + i * 8;
    const float inv = 1.f / hopper::quad_sum(l_part[i]);
    if (r < l) {
      __nv_bfloat16* orow = out + ((long long)bh * l + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      }
    }
  }
}

template <int HD, int NWG>
int launch(const CUtensorMap& km, const CUtensorMap& vm, Rows q, const void* mask,
           void* out, int B, int H, int l, int cur, float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      decode_flat_kernel<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<HD, NWG>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + 64 * NWG - 1) / (64 * NWG), B * H);
  decode_flat_kernel<HD, NWG><<<grid, NWG * 128 + 32, smem_bytes<HD, NWG>(), stream>>>(
      km, vm, q, (const uint8_t*)mask, (__nv_bfloat16*)out, H, l, cur, scale);
  return (int)cudaGetLastError();
}

// keys [0, cur) of a layer's (B, H, HD, L) K^T or V^T as a TMA map of
// [HD][64 keys] tiles
bool keys_map(CUtensorMap* map, const void* p, long long sb, long long sh, long long sd,
              int B, int H, int hd, int cur) {
  const long long dims[4] = {cur, hd, H, B}, strides[3] = {sd, sh, sb};
  return hopper::encode_4d(map, p, dims, strides, BK, hd);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim with no instance or when a tensor
// map cannot be made (the head dim's and the batch and head strides must be
// multiples of 16 bytes, the bases 16-byte aligned).
extern "C" int decode_flat_bf16(int hd, const void* q, long long q_sb, long long q_sh,
                                long long q_sr, const void* k, const void* v,
                                const void* mask, void* out, int B, int H, int l, int cur,
                                long long k_sb, long long k_sh, long long k_sd,
                                long long v_sb, long long v_sh, long long v_sd,
                                float scale, void* stream) {
  if (hd % 16 != 0 || hd < 16 || hd > 128) return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  if (!keys_map(&km, k, k_sb, k_sh, k_sd, B, H, hd, cur) ||
      !keys_map(&vm, v, v_sb, v_sh, v_sd, B, H, hd, cur)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const Rows qr{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr};
#define CASE(D)                                                                          \
  case D:                                                                                \
    return l <= 64 ? launch<D, 1>(km, vm, qr, mask, out, B, H, l, cur, scale, st)        \
                   : launch<D, 2>(km, vm, qr, mask, out, B, H, l, cur, scale, st);
  switch (hd) {
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}

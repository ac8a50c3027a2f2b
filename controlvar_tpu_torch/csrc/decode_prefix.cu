// In-place decode attention (K6) for Hopper (sm_90a), bf16, hd = 64.
//
// Replaces the TPU kernel controlvar_tpu/ops/attention.py:flash_decode_inplace
// (_inplace_kernel): attention of q over [cache prefix | fresh rows], as
// ops/attention.py:flash_decode_prefix (_prefix_kernel_paired) computes it,
// over layer li of the stacked (depth, B, H, L_max, 64) cache, with the
// fresh rows written into rows [pos, pos + l) of that layer; unmasked. (K5,
// flash_decode_prefix itself, runs csrc/decode_attention.cu's kernel
// through a tile load of its own.) Rounding points follow the TPU kernel:
// q*scale rounded to bf16 before q.K^T (fp32 scores), p = exp(s - m)
// rounded to bf16 for the PV product (fp32 sums), the denominator summed
// over the unrounded p, and the output divided once, after PV.
//
// What bounds it on the H100: at the d24 joint path's final scale (16 CFG
// rows, 24 heads, l = 512, pos = 848) the two products are 6.8e10 FLOP,
// 0.069 ms at 989 TFLOP/s, against 0.18 GB of q, K, V and out plus the 50
// MB fresh-row write: 0.070 ms at 3.35 TB/s; the two bounds are even.
//
// Design (decode_inplace_kernel): one block per (q group, batch*head), the
// q group fastest in the grid, so the few blocks of one head run together
// and each K/V tile comes from HBM once and from L2 for the others. A q
// group is 64 rows (one consumer warpgroup) at l <= 64 and 128 rows (two)
// above. One producer warp streams 64-row K and V tiles with TMA
// (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 4 stages whose
// full and empty mbarriers pace it against the consumers. The prefix's
// tensor maps end at row pos and the fresh rows' at l, so TMA zero-fills
// the ragged tiles and reads nothing at or past either end. Each consumer
// warpgroup turns its 64 rows of q*scale into wgmma A fragments (kept in
// shared memory, reloaded per tile: see hopper.cuh) and runs S = q K^T as
// wgmma m64n64k16 (B = the K tile, K-major) and O += P V with P from
// registers (B = the V tile, MN-major: the transpose bit, no copy), fp32
// accumulators in registers; two blocks fit an SM. The write: the block
// that owns a q group stores that group's fresh K/V tiles from shared
// memory with a TMA store through a map of layer li that ends at row
// pos + l, so each fresh row is written once, nothing past pos + l is, and
// no block reads a row at or past pos. ptxas (CUDA 12.8, sm_90a):
// decode_inplace_kernel<1> and <2> 96 registers, no spills, 64 bytes of
// static shared memory (the mbarriers) and 74,752 / 82,944 bytes dynamic
// (the 64 KB ring, 8 KB of q fragments a warpgroup, 1 KB of alignment).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace inplace {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::smem_desc;
using hopper::smem_u32;

constexpr int HD = 64, BK = 64;
constexpr int STAGES = 4;                       // the TMA ring
constexpr int TILE = BK * HD * 2;               // bytes of one K or V tile

// the ring, each consumer thread's q fragments, and alignment to 1024
template <int NWG>
constexpr int smem_bytes() { return STAGES * 2 * TILE + NWG * 128 * HD + 1024; }

struct Rows {
  const __nv_bfloat16* p;
  long long sb, sh, sr;
};

template <int NWG>  // consumer warpgroups: q rows per block = 64 NWG
__global__ void __launch_bounds__(NWG * 128 + 32, 2)
decode_inplace_kernel(const __grid_constant__ CUtensorMap pk,  // layer li, rows [0, pos)
                      const __grid_constant__ CUtensorMap pv,
                      const __grid_constant__ CUtensorMap nk,  // fresh rows [0, l)
                      const __grid_constant__ CUtensorMap nv,
                      const __grid_constant__ CUtensorMap wk,  // layer li, rows [0, pos + l)
                      const __grid_constant__ CUtensorMap wv,
                      Rows q, __nv_bfloat16* __restrict__ out,  // (B*H, l, HD)
                      int H, int l, int pos, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: K, then V
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row_blk = blockIdx.x * NWG * 64;
  const int n_wg = min(NWG, (l - row_blk + 63) / 64);  // warpgroups with q rows
  const int np = (pos + BK - 1) / BK;                  // prefix tiles, then fresh ones
  const int ntiles = np + (l + BK - 1) / BK;

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
        const bool pre = it < np;
        const int r0 = (pre ? it : it - np) * BK;
        hopper::tma_load_4d(kdst, pre ? &pk : &nk, bar, 0, r0, h, b);
        hopper::tma_load_4d(kdst + TILE, pre ? &pv : &nv, bar, 0, r0, h, b);
      }
    }
    return;
  }
  const int wg = warp / 4;
  if (wg >= n_wg) return;

  const int g = lane / 4, t = lane % 4;             // fragment row / column pair
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
    const int s = it % STAGES;
    mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
    const uint32_t kt = ring + s * 2 * TILE, vt = kt + TILE;
    const bool pre = it < np;
    const int t0 = (pre ? it : it - np) * BK, n_valid = pre ? pos : l;
    // this block's own fresh rows: into cache rows pos + t0.. (the map ends
    // at pos + l), straight from the tiles just loaded
    const bool store = !pre && tid == 0 && (it - np) / NWG == (int)blockIdx.x;
    if (store) {
      hopper::tma_store_4d(&wk, kt, 0, pos + t0, h, b);
      hopper::tma_store_4d(&wv, vt, 0, pos + t0, h, b);
      hopper::tma_store_commit();
    }
    __syncwarp();

    // S = (q*scale) K^T: the K tile [key][hd] is B stored K-major
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint4 v = qs[kk * NWG * 128];
      const uint32_t a[4] = {v.x, v.y, v.z, v.w};
      hopper::WgmmaRS<BK, 0>::run(sc, a, smem_desc(kt + 32 * kk), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    fence_regs(sc);

    if (t0 + BK > n_valid) {  // the ragged end of a range: weight 0
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (t0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n_valid) sc[i] = -CUDART_INF_F;
      }
    }
    float alpha[2];
    uint32_t pa[BK / 16][4];
    hopper::softmax_tile(sc, m_run, l_part, alpha, pa);
    hopper::scale_rows(o, alpha);

    // O += P V: the V tile [key][hd] is B stored MN-major
    fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      hopper::WgmmaRS<HD, 1>::run(o, pa[kc], smem_desc(vt + 2048 * kc), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    fence_regs(o);
    if (store) hopper::tma_store_wait_read();
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
  if (tid == 0) hopper::tma_store_wait();
}

// layer rows [0, rows) of a (B, H, n, 64) operand as a TMA map of 64 x 64 tiles
bool rows_map(CUtensorMap* map, const void* p, long long sb, long long sh, long long sr,
              int B, int H, int rows) {
  const long long dims[4] = {HD, rows, H, B}, strides[3] = {sr, sh, sb};
  return hopper::encode_4d(map, p, dims, strides, HD, BK);
}

template <int NWG>
int launch(const CUtensorMap (&m)[6], Rows q, void* out, int B, int H, int l, int pos,
           float scale, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      decode_inplace_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<NWG>());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((l + 64 * NWG - 1) / (64 * NWG), B * H);
  decode_inplace_kernel<NWG><<<grid, NWG * 128 + 32, smem_bytes<NWG>(), stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], q, (__nv_bfloat16*)out, H, l, pos, scale);
  return (int)cudaGetLastError();
}

}  // namespace inplace

// K6: ck/cv are layer li of the stacked caches (rows [0, pos) are read,
// rows [pos, pos + l) are written from nk/nv); unmasked. Every row stride
// and the head and batch strides are multiples of 16 bytes, the bases
// 16-byte aligned (TMA's terms). Returns cudaErrorInvalidValue when a
// tensor map cannot be made.
extern "C" int decode_inplace_bf16(
    const void* q, long long q_sb, long long q_sh, long long q_sr,
    void* ck, long long ck_sb, long long ck_sh, long long ck_sr,
    void* cv, long long cv_sb, long long cv_sh, long long cv_sr,
    const void* nk, long long nk_sb, long long nk_sh, long long nk_sr,
    const void* nv, long long nv_sb, long long nv_sh, long long nv_sr,
    void* out, int B, int H, int l, int pos, float scale, void* stream) {
  CUtensorMap m[6];
  // at pos == 0 the prefix maps are made (one row) but never read
  const bool ok = inplace::rows_map(&m[0], ck, ck_sb, ck_sh, ck_sr, B, H, pos > 0 ? pos : 1) &&
                  inplace::rows_map(&m[1], cv, cv_sb, cv_sh, cv_sr, B, H, pos > 0 ? pos : 1) &&
                  inplace::rows_map(&m[2], nk, nk_sb, nk_sh, nk_sr, B, H, l) &&
                  inplace::rows_map(&m[3], nv, nv_sb, nv_sh, nv_sr, B, H, l) &&
                  inplace::rows_map(&m[4], ck, ck_sb, ck_sh, ck_sr, B, H, pos + l) &&
                  inplace::rows_map(&m[5], cv, cv_sb, cv_sh, cv_sr, B, H, pos + l);
  if (!ok) return (int)cudaErrorInvalidValue;
  const inplace::Rows qr{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr};
  const cudaStream_t st = (cudaStream_t)stream;
  return l <= 64 ? inplace::launch<1>(m, qr, out, B, H, l, pos, scale, st)
                 : inplace::launch<2>(m, qr, out, B, H, l, pos, scale, st);
}

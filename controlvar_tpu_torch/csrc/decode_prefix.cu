// Prefix decode attention (K5) and in-place decode (K6) for Hopper (sm_90a),
// bf16, hd = 64.
//
// Replaces two TPU kernels of controlvar_tpu/ops/attention.py that compute
// one function, attention of q over [cache prefix | fresh rows]:
//   K5 flash_decode_prefix (_prefix_kernel_paired and its masked variant):
//      the prefix is rows [0, pos) of one layer's cache, any strides with
//      dense rows; the fresh rows are this scale's k_new/v_new; an optional
//      (l, pos + l) bool mask;
//   K6 flash_decode_inplace (_inplace_kernel): the same attention over layer
//      li of the stacked (depth, B, H, L_max, 64) cache, and the fresh rows
//      written into rows [pos, pos + l) of that layer; unmasked.
// Rounding points follow the TPU kernels: q*scale rounded to bf16 before
// q.K^T (fp32 scores), p = exp(s - m) rounded to bf16 for the PV product
// (fp32 sums), the denominator summed over the unrounded p, and the output
// divided once, after PV.
//
// What bounds them on the H100: at the d24 joint path's final scale (16 CFG
// rows, 24 heads, l = 512, pos = 848) the two products are 6.8e10 FLOP,
// 0.069 ms at 989 TFLOP/s, against 0.18 GB of q, K, V and out (K6 adds the
// 50 MB fresh-row write: 0.070 ms at 3.35 TB/s); the two bounds are even.
//
// K5's design is K1's first one (csrc/decode_attention.cu): one block of 4
// warps per (64-row q tile, batch*head), each warp owning 16 q rows; K/V
// stream through shared memory in 64-row tiles, double-buffered with
// cp.async, first the prefix tiles, read through strides, then the fresh
// tiles, into one running max and denominator (the TPU's joint softmax over
// two score tiles becomes one online softmax over both ranges); rows past
// pos in the prefix range and past l in the fresh range are zero-filled and
// their scores set to -inf (weight 0), so no padded copy of either exists;
// mma.sync m16n8k16 bf16 with fp32 accumulation.
//
// K6's design (decode_inplace_kernel) is Hopper's: one block per (q group,
// batch*head), the q group fastest in the grid, so the few blocks of one
// head run together and each K/V tile comes from HBM once and from L2 for
// the others. A q group is 64 rows (one consumer warpgroup) at l <= 64 and
// 128 rows (two) above. One producer warp streams 64-row K and V tiles with
// TMA (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 4 stages whose
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
// (the 64 KB ring, 8 KB of q fragments a warpgroup, 1 KB of alignment);
// decode_prefix_kernel (K5) 162 registers, 36,864 bytes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = HD + 8;   // padded shared-memory row (bank-conflict free)
constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernels

// a (B, H, n, HD) bf16 operand read through its (batch, head, row) strides
struct Rows {
  const __nv_bfloat16* p;
  long long sb, sh, sr;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_size = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__global__ void __launch_bounds__(THREADS)
decode_prefix_kernel(Rows q, Rows pk, Rows pv, Rows nk, Rows nv,
                     const uint8_t* __restrict__ mask,  // (l, pos + l) or null
                     __nv_bfloat16* __restrict__ out,   // (B*H, l, HD)
                     int H, int l, int pos, float scale) {
  __shared__ __align__(128) __nv_bfloat16 ks[2][BK * LDS];
  __shared__ __align__(128) __nv_bfloat16 vs[2][BK * LDS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment row / column pair
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * BQ + warp * 16;  // this warp's first q row
  const __nv_bfloat16* pkb = pk.p + b * pk.sb + h * pk.sh;
  const __nv_bfloat16* pvb = pv.p + b * pv.sb + h * pv.sh;
  const __nv_bfloat16* nkb = nk.p + b * nk.sb + h * nk.sh;
  const __nv_bfloat16* nvb = nv.p + b * nv.sb + h * nv.sh;
  const int np = (pos + BK - 1) / BK;            // prefix tiles, then fresh ones
  const int ntiles = np + (l + BK - 1) / BK;
  const long long ncols = (long long)pos + l;    // the mask's row length

  auto load_tile = [&](int it, int buf) {
    const bool pre = it < np;
    const int t0 = (pre ? it : it - np) * BK, n = pre ? pos : l;
    const __nv_bfloat16* kb = pre ? pkb : nkb;
    const __nv_bfloat16* vb = pre ? pvb : nvb;
    const long long ksr = pre ? pk.sr : nk.sr, vsr = pre ? pv.sr : nv.sr;
    for (int i = tid; i < BK * HD / 8; i += THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const bool valid = t0 + r < n;
      const long long rr = valid ? t0 + r : 0;
      cp_async16(&ks[buf][r * LDS + c], kb + rr * ksr + c, valid);
      cp_async16(&vs[buf][r * LDS + c], vb + rr * vsr + c, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_tile(0, 0);

  // q*scale as A fragments, rounded to bf16; rows past l are zero
  const __nv_bfloat16* qb = q.p + b * q.sb + h * q.sh;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + g + (j & 1) * 8, c = kk * 16 + 2 * t + (j >> 1) * 8;
      float2 f = make_float2(0.f, 0.f);
      if (r < l) {
        f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qb + (long long)r * q.sr + c));
      }
      qa[kk][j] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_part[2] = {0.f, 0.f};  // rows g, g+8

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    const bool pre = it < np;
    const int t0 = (pre ? it : it - np) * BK, n_valid = pre ? pos : l;
    const int col0 = pre ? t0 : pos + t0;        // first mask column of the tile
    if (it + 1 < ntiles) {
      load_tile(it + 1, buf ^ 1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const __nv_bfloat16* kt = ks[buf];
    const __nv_bfloat16* vt = vs[buf];

    // S = (q*scale) K^T: 8 key n-tiles of 8 columns
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = kt + (n * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[n], qa[kk], b0, b1);
      }
    }

    // mask (-1e30, as the reference) and the ragged end of each range
    // (-inf: weight 0)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n * 8 + 2 * t + (j & 1), r = row0 + g + (j >> 1) * 8;
        if (t0 + col >= n_valid) {
          s[n][j] = -CUDART_INF_F;
        } else if (mask != nullptr && r < l && !mask[(long long)r * ncols + col0 + col]) {
          s[n][j] = NEG_INF;
        }
        mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_run[i], quad_max(mx[i]));
      alpha[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_part[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = __expf(s[n][j] - m_run[j >> 1]);
        l_part[j >> 1] += s[n][j];
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V; P's score fragments of key chunk kc are the A operand
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const unsigned vaddr = (unsigned)__cvta_generic_to_shared(
          vt + (kc * 16 + (lane & 15)) * LDS);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1) : "r"(vaddr + n * 16));
        mma_bf16(o[n], pa, b0, b1);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + i * 8;
    const float inv = 1.f / quad_sum(l_part[i]);
    if (r < l) {
      __nv_bfloat16* orow = out + ((long long)bh * l + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
      }
    }
  }
}

}  // namespace

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

// K5: pk/pv are the prefix rows [0, pos) (one layer's cache), nk/nv the l
// fresh rows, each (B, H, n, 64) through (batch, head, row) strides; mask
// (l, pos + l) uint8 or null. Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int decode_prefix_bf16(
    const void* q, long long q_sb, long long q_sh, long long q_sr,
    const void* pk, long long pk_sb, long long pk_sh, long long pk_sr,
    const void* pv, long long pv_sb, long long pv_sh, long long pv_sr,
    const void* nk, long long nk_sb, long long nk_sh, long long nk_sr,
    const void* nv, long long nv_sb, long long nv_sh, long long nv_sr,
    const void* mask, void* out, int B, int H, int l, int pos, float scale,
    void* stream) {
  using bf = const __nv_bfloat16*;
  dim3 grid(B * H, (l + BQ - 1) / BQ);
  decode_prefix_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      Rows{(bf)q, q_sb, q_sh, q_sr}, Rows{(bf)pk, pk_sb, pk_sh, pk_sr},
      Rows{(bf)pv, pv_sb, pv_sh, pv_sr}, Rows{(bf)nk, nk_sb, nk_sh, nk_sr},
      Rows{(bf)nv, nv_sb, nv_sh, nv_sr}, (const uint8_t*)mask, (__nv_bfloat16*)out,
      H, l, pos, scale);
  return (int)cudaGetLastError();
}

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

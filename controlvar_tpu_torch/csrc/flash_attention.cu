// Masked flash attention for training on Hopper (sm_90a), bf16, hd = 64:
// the forward (kernel K3) and its backward (kernel K4: a dq pass and a dk/dv
// pass).
//
// Replaces the TPU kernels controlvar_tpu/ops/attention.py:flash_attention
// (_flash_kernel) and controlvar_tpu/ops/attention.py:flash_attention_bwd
// (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel). For every (batch, head):
//   forward   out = softmax(S) V, lse = logsumexp(S), S = (q*scale) K^T with
//             masked scores at -1e30;
//   backward  P = exp(S - lse), dS = P o (dO V^T - D), D = rowsum(dO o out);
//             dq = scale dS K, dk = scale dS^T q, dv = P^T dO.
//
// What bounds them on the H100: at the d16 training shape (B*H = 128,
// L = 1360) the forward is 4 hd FLOP per unmasked score, 3.8e10 FLOP over
// the block-causal mask's 61.9% of L x L (0.038 ms at 989 TFLOP/s bf16),
// against 89 MB of q, k, v and out (0.027 ms at 3.35 TB/s); the backward
// needs 10 hd per unmasked score (0.095 ms) and its two passes compute 14
// (S and dP in both): the tensor cores bound both.
//
// K3's design (namespace fwd) is K4's dq pass with the forward's products.
// One block per (64-row q tile, batch*head), numbered with the q tile
// fastest and the last first (under the block-causal mask the later q
// rows walk the most tiles); a block is one consumer warpgroup and one
// producer warpgroup that gives its registers to the consumers (setmaxnreg)
// and streams the K and V tiles by TMA (128-byte swizzle) through a 3-stage
// mbarrier ring. Producer and consumers walk only the K/V tiles of the q
// tile's row of the flags that are not flagged 2 (fully masked). The
// consumer warpgroup stages q*scale rounded to bf16 (the TPU kernel's
// rounding point, so any scale) as a swizzled shared tile; S = q K^T is
// wgmma m64n64k16 with both operands in shared memory, O += P V takes P
// from registers (bf16) and the V tile as B stored MN-major, and P.V of one
// tile and S of the next go to the tensor cores in one flight. The softmax
// is online in base 2 (ex2 of one FFMA a score); in a tile that holds
// masked scores (-1e30) those take their row's exponent (-1e30 - m) log2e
// instead: 0 where the row has a real score and 1 where it has none (the
// TPU kernel's exp(-1e30 - m)), which the FFMA cannot give at m = -1e30
// (its rounding of m log2e is ~1e23). Skipping a tile flagged 2 is exact:
// tile_flags gives 2 only where every row of the tile attends somewhere, so
// its p are 0 for every row, and where such a tile would come first a later
// alpha = 0 wipes it. Three blocks an SM: measured at the d16 shape, this
// beat two consumer warpgroups sharing a 128-row block's tiles (at one or
// two blocks an SM), two blocks an SM, four blocks with a 2-stage ring
// (which spilled), and the next tile's q.K^T issued before each softmax
// (PERF.md §11.6). ptxas (CUDA 12.8, sm_90a): 80 registers a thread at
// launch (136 for the consumers after setmaxnreg), no spills, no
// serialised wgmma; 58,368 bytes of dynamic shared memory (the 48 KB ring,
// the q tile, 1 KB of alignment).
//
// K4's design (namespace bwd) is Hopper's, after the TMA/wgmma decode
// kernels (decode_attention.cu). It keeps the TPU's split: the dq pass owns
// q tiles and streams K/V, the dk/dv pass owns K/V tiles and streams q/dO,
// so each block writes only its own tile, with no atomics, and gradients
// are the same from run to run. A block is one consumer warpgroup (64 rows)
// and one producer warpgroup that gives its registers to the consumers
// (setmaxnreg) and streams the other operand's 64-row tiles by TMA through
// a 4-stage mbarrier ring, with the q/dO, lse and D rows for the dk/dv
// pass; two blocks fit an SM, numbered so that those running together share
// a (batch, head). Each pass walks only the tiles of its row or column of
// the flags that are not fully masked (34% of the d16 mask's tiles are),
// producer and consumers alike. The products are wgmma m64n64k16: S and dP
// (S^T and dP^T) with both operands in shared memory, and dq += dS K, dV +=
// P^T dO and dK += dS^T q with A from registers and B stored MN-major (the
// transpose bit). The dq pass also computes D = rowsum(dO o out) of its
// rows, once, and stores it for the dk/dv pass. Rounding points are the TPU
// kernels': q*scale is rounded to bf16 before QK^T, which K4 gets exactly
// by scaling the fp32 scores instead, since the wrapper takes only a scale
// that is a power of two (1/32 at hd 64, 1 under cos_attn); p is rounded
// to bf16 before P^T.dO; dS is rounded to bf16 before dS.K and dS^T.q; dq
// and dk are multiplied by scale once, after accumulating. P = exp(S - lse)
// is ex2 of one FFMA, and a masked score's exponent is (-1e30 - lse) log2e
// for its row, so a row that masks every key gets the TPU kernel's P = 1.
// ptxas (CUDA 12.8, sm_90a): both passes 128 registers a thread at launch
// (216 for the consumers after setmaxnreg), no spills, no serialised
// wgmma; 82,944 bytes of dynamic shared memory (the 64 KB ring, the
// block's two 8 KB tiles, 1 KB of alignment) and 3 KB static in the dk/dv
// pass (the streamed rows' lse terms and D).
//
// Tile flags: the wrapper passes one per 64 x 64 tile of the mask: 1 where
// the tile has no False, 2 where it has no True (and every row of its q
// rows has a True elsewhere, so P = 0 exactly on it), else 0. Tiles flagged
// 1 or 2 read no mask bytes, which otherwise cost a load per score (97% of
// the d16 mask's tiles); K3 and K4 skip the tiles flagged 2.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int HD = 64;        // head dim
constexpr int BR = 64;        // rows of the tile a block owns
constexpr int BC = 64;        // rows of each streamed tile
typedef __nv_bfloat16 bf16;

}  // namespace

// K4 (the backward) on Hopper: two passes of TMA tiles and wgmma.
namespace bwd {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::pack_a;
using hopper::smem_desc;
using hopper::smem_u32;
using hopper::WgmmaRS;
using hopper::WgmmaSS;

constexpr int STAGES = 4;                // the TMA ring
constexpr int TILE = BC * HD * 2;        // bytes of one 64 x 64 bf16 tile
constexpr float L2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// the ring (two streamed tiles a stage), the block's own two 64 x 64 tiles
// and alignment to 1024
constexpr int SMEM_BYTES = STAGES * 2 * TILE + 2 * TILE + 1024;

// Registers: one consumer warpgroup and one producer warpgroup a block, two
// blocks an SM, so each thread starts with 128 of the SM's 64K (ptxas
// allocates exactly that to a kernel that uses setmaxnreg: prepare() checks
// it). The producer keeps 40 and the consumers take what that frees, 216:
// the dk/dv pass holds four 64 x 64 fp32 accumulators (S^T, dP^T, dK, dV)
// and two bf16 A operands in flight.
constexpr int THREADS = 256;
constexpr int LAUNCH_REGS = 65536 / (2 * THREADS);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = (LAUNCH_REGS * THREADS - PRODUCER_REGS * 128) / 128 / 8 * 8;

// a (B, H, L, HD) bf16 operand read through its (batch, head, row) strides
struct Rows {
  const bf16* p;
  long long sb, sh, sr;
};

// The tiles of one row of the (nt, nt) flags (step 1: the k tiles of a q
// tile) or one column (step nt: the q tiles of a k tile) that are not fully
// masked, in order: the first at or after j, else nt. Producer and
// consumers walk the same flags, so the same tiles. A row or column with
// none (which tile_flags never gives) walks tile 0 alone, as fully masked.
__device__ __forceinline__ int next_tile(const uint8_t* f, int step, int j, int nt) {
  while (j < nt && f[(long long)j * step] == 2) ++j;
  return j;
}

__device__ __forceinline__ int first_tile(const uint8_t* f, int step, int nt) {
  const int j = next_tile(f, step, 0, nt);
  return j < nt ? j : 0;
}

// rows [r0, r0 + 64) of one (batch, head) of a strided operand into a 64 x 64
// K-major shared tile in TMA's 128-byte swizzle, by the 128 threads of a
// warpgroup (tid its thread); rows past L are zero. With `other` (the
// forward's out), also D = rowsum(x o other) in fp32 of each row into d[r]
// and, for rows < L, into dg[r0 + r].
__device__ __forceinline__ void stage_tile(uint32_t dst, const bf16* base, long long sr, int r0,
                                           int L, int tid, const bf16* other = nullptr,
                                           long long osr = 0, float* d = nullptr,
                                           float* dg = nullptr) {
#pragma unroll
  for (int i = tid; i < BC * HD / 8; i += 128) {
    const int r = i / (HD / 8), c = i % (HD / 8);  // row, 16-byte chunk
    uint4 v = make_uint4(0u, 0u, 0u, 0u), w = v;
    if (r0 + r < L) {
      v = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * sr + 8 * c);
      if (other != nullptr) {
        w = *reinterpret_cast<const uint4*>(other + (long long)(r0 + r) * osr + 8 * c);
      }
    }
    const uint32_t a = dst + (r / 8) * 1024 + (r % 8) * 128 + ((c ^ (r % 8)) * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
    if (other != nullptr) {  // the 8 lanes of a row hold its 8 chunks
      const uint32_t x[4] = {v.x, v.y, v.z, v.w}, y[4] = {w.x, w.y, w.z, w.w};
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[k]));
        const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y[k]));
        part = fmaf(fx.x, fy.x, part);
        part = fmaf(fx.y, fy.y, part);
      }
      part += __shfl_xor_sync(FULL_MASK, part, 1);
      part += __shfl_xor_sync(FULL_MASK, part, 2);
      part += __shfl_xor_sync(FULL_MASK, part, 4);
      if (c == 0) {
        d[r] = part;
        if (r0 + r < L) dg[r0 + r] = part;
      }
    }
  }
}

__device__ __forceinline__ void init_barriers(uint64_t (&full)[STAGES], uint64_t (&empty)[STAGES],
                                              int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(smem_u32(&full[s]), full_count);
      hopper::mbar_init(smem_u32(&empty[s]), 4);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// The dq pass: one block per (64-row q tile, batch*head), numbered with the
// q tile fastest (last tile first), so the blocks running together share a
// head's K and V in L2. The producer streams the K and V tiles of the q
// tile's flags row that are not fully masked; the consumer warpgroup holds q
// and dO as shared A operands and, per K/V tile, S = q K^T and dP = dO V^T
// (both operands in shared memory), P = exp(scale S - lse) (masked scores
// at -1e30 before it, keys past L at weight 0), dS = P (dP - D) rounded to
// bf16 in registers, and dq += dS K (K as B, MN-major). It computes D =
// rowsum(dO o out) of its rows on the way and stores it for the dk/dv pass.
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap km, const __grid_constant__ CUtensorMap vm,
                    Rows q, Rows dout, Rows out, const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ flags, const float* __restrict__ lse,
                    float* __restrict__ dsum, bf16* __restrict__ dq, int H, int L, int nt,
                    float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float d_rows[BR];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: K, then V
  const uint32_t qtile = ring + STAGES * 2 * TILE, dotile = qtile + TILE;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL_MASK, tid / 32, 0);  // warp-uniform, as ptxas sees it
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int qt = nt - 1 - (int)(blockIdx.x % nt);
  const uint8_t* frow = flags + (long long)qt * nt;
  init_barriers(full, empty, 1);

  if (warp >= 4) {  // the producer warpgroup; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == 4 && lane == 0) {
      hopper::prefetch_tensormap(&km);
      hopper::prefetch_tensormap(&vm);
      int it = 0;
      for (int j = first_tile(frow, 1, nt); j < nt; j = next_tile(frow, 1, j + 1, nt), ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(smem_u32(&empty[s]), (it / STAGES - 1) & 1);
        const uint32_t dst = ring + s * 2 * TILE, bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, 2 * TILE);
        hopper::tma_load_4d(dst, &km, bar, 0, j * BC, h, b);
        hopper::tma_load_4d(dst + TILE, &vm, bar, 0, j * BC, h, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int g = lane / 4, t = lane % 4;
  const int r_q = qt * BR;                       // the block's first q row
  const int row0 = warp * 16;                    // this warp's first row in the tile
  const long long bhL = (long long)bh * L;
  stage_tile(qtile, q.p + b * q.sb + h * q.sh, q.sr, r_q, L, tid);
  stage_tile(dotile, dout.p + b * dout.sb + h * dout.sh, dout.sr, r_q, L, tid,
             out.p + b * out.sb + h * out.sh, out.sr, d_rows, dsum + bhL);
  hopper::fence_proxy_async();
  hopper::named_sync(1, 128);

  // per row (g, g + 8): -lse log2e, the exponent of a masked score ((-1e30
  // - lse) log2e: P = 0, or 1 where the row masks every key and lse is
  // -1e30, as the TPU kernel's exp(-1e30 - lse)), and D
  float nl[2], cm[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_q + row0 + g + 8 * i;
    const float x = r < L ? lse[bhL + r] : 0.f;
    nl[i] = -x * L2E;
    cm[i] = (hopper::NEG_INF - x) * L2E;
    dd[i] = d_rows[row0 + g + 8 * i];
  }
  const float cs = scale * L2E;  // scale is a power of two: q*scale is exact

  float acc[HD / 2], sc[BC / 2], dp[BC / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  auto issue = [&](uint32_t kt) {  // S = q K^T, dP = dO V^T
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<BC>::run(sc, smem_desc(qtile + 32 * kk), smem_desc(kt + 32 * kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<BC>::run(dp, smem_desc(dotile + 32 * kk), smem_desc(kt + TILE + 32 * kk), kk > 0);
    }
    hopper::wgmma_commit();
  };
  int j = __shfl_sync(FULL_MASK, first_tile(frow, 1, nt), 0);
  mbar_wait(smem_u32(&full[0]), 0);
  issue(ring);
  for (int it = 0; j < nt; ++it) {
    const int jn = __shfl_sync(FULL_MASK, next_tile(frow, 1, j + 1, nt), 0);
    const int f = __shfl_sync(FULL_MASK, (int)frow[j], 0);
    const uint32_t kt = ring + (it % STAGES) * 2 * TILE;
    hopper::wgmma_wait0();  // S, dP of this tile, dS K of the last one
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(acc);
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));

    // the exponent of P in base 2, then the mask and the end of the keys, as selects
    const int c0 = j * BC;
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) sc[i] = fmaf(sc[i], cs, nl[(i >> 1) & 1]);
    if (f == 0) {  // rows past L read row L - 1: they are not stored
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int r = min(r_q + row0 + g + 8 * ((i >> 1) & 1), L - 1);
        const int col = min(c0 + 8 * (i >> 2) + 2 * t + (i & 1), L - 1);
        sc[i] = mask[(long long)r * L + col] ? sc[i] : cm[(i >> 1) & 1];
      }
    } else if (f == 2) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) sc[i] = cm[(i >> 1) & 1];
    }
    if (c0 + BC > L) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        sc[i] = c0 + 8 * (i >> 2) + 2 * t + (i & 1) >= L ? -CUDART_INF_F : sc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      sc[i] = hopper::ex2_approx(sc[i]) * (dp[i] - dd[(i >> 1) & 1]);  // dS
    }
    uint32_t dsa[BC / 16][4];
    pack_a(sc, dsa);

    // dq += dS K: the K tile [key][hd] is B stored MN-major
    fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BC / 16; ++kc) {
      WgmmaRS<HD, 1>::run(acc, dsa[kc], smem_desc(kt + 2048 * kc), 1);
    }
    hopper::wgmma_commit();
    if (jn < nt) {
      const int s1 = (it + 1) % STAGES;
      mbar_wait(smem_u32(&full[s1]), ((it + 1) / STAGES) & 1);
      issue(ring + s1 * 2 * TILE);
    }
    j = jn;
  }
  hopper::wgmma_wait0();
  fence_regs(acc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_q + row0 + g + 8 * i;
    if (r < L) {
      bf16* row = dq + (bhL + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
      }
    }
  }
}

// The dk/dv pass: one block per (64-row K/V tile, batch*head), numbered
// with the K/V tile fastest. The producer warp streams the q and dO tiles
// of the K/V tile's flags column that are not fully masked, and with each
// the rows' -lse log2e, masked exponent and D (written by the dq pass); the
// consumer warpgroup holds K and V as shared A operands and, per q tile,
// S^T = K q^T and dP^T = V dO^T (both operands in shared memory; the
// accumulators lie as the next products' A operands), P^T = exp(scale S^T -
// lse) (q rows past L at weight 0, whatever lse holds there), dV += P^T dO
// with P^T rounded to bf16, dS^T = P^T (dP^T - D) rounded to bf16, and dK +=
// dS^T q (dO and q as B, MN-major); dk is multiplied by scale once, at the
// end.
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qm,
                     const __grid_constant__ CUtensorMap dom, Rows k, Rows v,
                     const uint8_t* __restrict__ mask, const uint8_t* __restrict__ flags,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int L, int nt,
                     float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float rows[STAGES][3][BC];  // per q row: -lse log2e, masked exponent, D
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: q, then dO
  const uint32_t ktile = ring + STAGES * 2 * TILE, vtile = ktile + TILE;
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL_MASK, tid / 32, 0);
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int kt = (int)(blockIdx.x % nt);
  const uint8_t* fcol = flags + kt;
  const long long bhL = (long long)bh * L;
  init_barriers(full, empty, 1 + 32);  // the TMA bytes' arrival, one per producer lane

  if (warp >= 4) {  // the producer warpgroup: its first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == 4) {
      if (lane == 0) {
        hopper::prefetch_tensormap(&qm);
        hopper::prefetch_tensormap(&dom);
      }
      int it = 0;
      for (int i = first_tile(fcol, nt, nt); i < nt; i = next_tile(fcol, nt, i + 1, nt), ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(smem_u32(&empty[s]), (it / STAGES - 1) & 1);
        const uint32_t dst = ring + s * 2 * TILE, bar = smem_u32(&full[s]);
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * TILE);
          hopper::tma_load_4d(dst, &qm, bar, 0, i * BR, h, b);
          hopper::tma_load_4d(dst + TILE, &dom, bar, 0, i * BR, h, b);
        }
        for (int r = lane; r < BR; r += 32) {
          const int row = i * BR + r;
          const float x = row < L ? lse[bhL + row] : 0.f;
          rows[s][0][r] = -x * L2E;
          rows[s][1][r] = (hopper::NEG_INF - x) * L2E;
          rows[s][2][r] = row < L ? dsum[bhL + row] : 0.f;
        }
        mbar_arrive(bar);  // releases this lane's stores to the consumers
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int g = lane / 4, t = lane % 4;
  const int r_k = kt * BC;                       // the block's first key row
  const int row0 = warp * 16;                    // this warp's first key row in the tile
  stage_tile(ktile, k.p + b * k.sb + h * k.sh, k.sr, r_k, L, tid);
  stage_tile(vtile, v.p + b * v.sb + h * v.sh, v.sr, r_k, L, tid);
  hopper::fence_proxy_async();
  hopper::named_sync(1, 128);
  const float cs = scale * L2E;

  float dk_acc[HD / 2], dv_acc[HD / 2], st[BR / 2], dpt[BR / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  fence_regs(dk_acc);
  fence_regs(dv_acc);
  auto issue = [&](uint32_t qs) {  // S^T = K q^T, dP^T = V dO^T
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<BR>::run(st, smem_desc(ktile + 32 * kk), smem_desc(qs + 32 * kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<BR>::run(dpt, smem_desc(vtile + 32 * kk), smem_desc(qs + TILE + 32 * kk), kk > 0);
    }
    hopper::wgmma_commit();
  };
  int i = __shfl_sync(FULL_MASK, first_tile(fcol, nt, nt), 0);
  mbar_wait(smem_u32(&full[0]), 0);
  issue(ring);
  for (int it = 0; i < nt; ++it) {
    const int in = __shfl_sync(FULL_MASK, next_tile(fcol, nt, i + 1, nt), 0);
    const int f = __shfl_sync(FULL_MASK, (int)fcol[(long long)i * nt], 0);
    const int s = it % STAGES;
    const uint32_t qs = ring + s * 2 * TILE, dos = qs + TILE;
    hopper::wgmma_wait0();  // S^T, dP^T of this tile, dV and dK of the last one
    fence_regs(st);
    fence_regs(dpt);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));

    // column c of the fragments is q row i * 64 + c: its exponent of P in
    // base 2, then the mask (read transposed) and q rows past L, as selects
    const float* nl = rows[s][0];
    const float* cm = rows[s][1];
    const float* dd = rows[s][2];
    const int c0 = i * BR;
#pragma unroll
    for (int e = 0; e < BR / 2; ++e) st[e] = fmaf(st[e], cs, nl[8 * (e >> 2) + 2 * t + (e & 1)]);
    if (f == 0) {  // key rows past L read key L - 1: they are not stored
#pragma unroll
      for (int e = 0; e < BR / 2; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1);
        const int key = min(r_k + row0 + g + 8 * ((e >> 1) & 1), L - 1);
        st[e] = mask[(long long)min(c0 + c, L - 1) * L + key] ? st[e] : cm[c];
      }
    } else if (f == 2) {
#pragma unroll
      for (int e = 0; e < BR / 2; ++e) st[e] = cm[8 * (e >> 2) + 2 * t + (e & 1)];
    }
    if (c0 + BR > L) {
#pragma unroll
      for (int e = 0; e < BR / 2; ++e) {
        st[e] = c0 + 8 * (e >> 2) + 2 * t + (e & 1) >= L ? -CUDART_INF_F : st[e];
      }
    }
#pragma unroll
    for (int e = 0; e < BR / 2; ++e) {
      st[e] = hopper::ex2_approx(st[e]);                                  // P^T
      dpt[e] = st[e] * (dpt[e] - dd[8 * (e >> 2) + 2 * t + (e & 1)]);     // dS^T
    }
    uint32_t pa[BR / 16][4], dsa[BR / 16][4];
    pack_a(st, pa);
    pack_a(dpt, dsa);

    // dV += P^T dO, dK += dS^T q: the dO and q tiles [q row][hd] are B
    // stored MN-major
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BR / 16; ++kc) {
      WgmmaRS<HD, 1>::run(dv_acc, pa[kc], smem_desc(dos + 2048 * kc), 1);
    }
#pragma unroll
    for (int kc = 0; kc < BR / 16; ++kc) {
      WgmmaRS<HD, 1>::run(dk_acc, dsa[kc], smem_desc(qs + 2048 * kc), 1);
    }
    hopper::wgmma_commit();
    if (in < nt) {
      const int s1 = (it + 1) % STAGES;
      mbar_wait(smem_u32(&full[s1]), ((it + 1) / STAGES) & 1);
      issue(ring + s1 * 2 * TILE);
    }
    i = in;
  }
  hopper::wgmma_wait0();
  fence_regs(dk_acc);
  fence_regs(dv_acc);

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r_k + row0 + g + 8 * e;
    if (r < L) {
      const long long off = (bhL + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) = __floats2bfloat162_rn(
            dk_acc[4 * n + 2 * e] * scale, dk_acc[4 * n + 2 * e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * e], dv_acc[4 * n + 2 * e + 1]);
      }
    }
  }
}

// setmaxnreg.inc would wait forever for registers the block never had:
// check ptxas's count, then allow the dynamic shared memory
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int launch_regs = LAUNCH_REGS, int smem = SMEM_BYTES) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs != launch_regs) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// rows [0, L) of a strided (B, H, L, 64) operand as a TMA map of 64 x 64 tiles
bool rows_map(CUtensorMap* map, const void* p, long long sb, long long sh, long long sr, int B,
              int H, int L) {
  const long long dims[4] = {HD, L, H, B}, strides[3] = {sr, sh, sb};
  return hopper::encode_4d(map, p, dims, strides, HD, BC);
}

}  // namespace bwd

// K3 (the forward) on Hopper: TMA tiles and wgmma over the tiles that are
// not fully masked.
namespace fwd {

using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::smem_desc;
using hopper::smem_u32;

constexpr int BLOCKS = 3;                // blocks an SM
constexpr int STAGES = 3;                // the TMA ring
constexpr int TILE = BC * HD * 2;        // bytes of one 64 x 64 bf16 tile
constexpr float L2E = 1.4426950408889634f;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;             // a consumer and a producer warpgroup

// the ring (a K and a V tile a stage), the q tile and alignment to 1024
constexpr int SMEM_BYTES = STAGES * 2 * TILE + TILE + 1024;

// Registers: BLOCKS blocks an SM, so each thread starts with LAUNCH_REGS of
// the SM's 64K (ptxas allocates exactly that to a kernel that uses
// setmaxnreg: bwd::prepare checks it); the producer keeps 24 and the
// consumers take what that frees, 136, for O and S (32 fp32 each) and P's
// bf16 fragments in flight.
constexpr int LAUNCH_REGS = 65536 / (BLOCKS * THREADS) / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = (LAUNCH_REGS * THREADS - PRODUCER_REGS * 128) / 128 / 8 * 8;

// hopper::softmax_tile_ex2 for a tile that holds masked scores (-1e30):
// those take their row's exponent (-1e30 - m) log2e, so P = 0 where the row
// has a real score and P = 1 where it has none, as the TPU kernel's
// exp(-1e30 - m) (fmaf(-1e30, log2e, -m log2e) at m = -1e30 is off by the
// rounding of m log2e, ~1e23, either way)
__device__ __forceinline__ void softmax_tile_masked(float (&s)[32], float (&m_run)[2],
                                                    float (&l_part)[2], float (&alpha)[2],
                                                    uint32_t (&pa)[4][4]) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg_ml[2], cm[2];  // -m log2e and the masked exponent of rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_run[r], hopper::quad_max(mx[r]));
    alpha[r] = hopper::ex2_approx((m_run[r] - m_new) * L2E);
    m_run[r] = m_new;
    l_part[r] *= alpha[r];
    neg_ml[r] = -m_new * L2E;
    cm[r] = (hopper::NEG_INF - m_new) * L2E;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = hopper::ex2_approx(s[i] == hopper::NEG_INF ? cm[r] : fmaf(s[i], L2E, neg_ml[r]));
    l_part[r] += s[i];
  }
  hopper::pack_a(s, pa);
}

// One block per (64-row q tile, batch*head), numbered with the q tile
// fastest, last tile first.
__global__ void __launch_bounds__(THREADS, BLOCKS)
flash_fwd_kernel(const __grid_constant__ CUtensorMap km, const __grid_constant__ CUtensorMap vm,
                 bwd::Rows q, const uint8_t* __restrict__ mask,   // (L, L)
                 const uint8_t* __restrict__ flags,               // (nt, nt)
                 bf16* __restrict__ out,                          // (B*H, L, HD)
                 float* __restrict__ lse,                         // (B*H, L)
                 int H, int L, int nt, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: K, then V
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(FULL_MASK, tid / 32, 0);  // warp-uniform, as ptxas sees it
  const int bh = blockIdx.x / nt, b = bh / H, h = bh % H;
  const int qt = nt - 1 - (int)(blockIdx.x % nt);
  const uint8_t* frow = flags + (long long)qt * nt;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(smem_u32(&full[s]), 1);
      hopper::mbar_init(smem_u32(&empty[s]), 4);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == 4 && lane == 0) {
      hopper::prefetch_tensormap(&km);
      hopper::prefetch_tensormap(&vm);
      int it = 0;
      for (int j = bwd::first_tile(frow, 1, nt); j < nt; j = bwd::next_tile(frow, 1, j + 1, nt),
               ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(smem_u32(&empty[s]), (it / STAGES - 1) & 1);
        const uint32_t dst = ring + s * 2 * TILE, bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, 2 * TILE);
        hopper::tma_load_4d(dst, &km, bar, 0, j * BC, h, b);
        hopper::tma_load_4d(dst + TILE, &vm, bar, 0, j * BC, h, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int g = lane / 4, t = lane % 4;
  const int row0 = qt * BR + warp * 16;         // this warp's first q row
  const uint32_t qtile = ring + STAGES * 2 * TILE;
  const bf16* qb = q.p + b * q.sb + h * q.sh;
  // q*scale rounded to bf16 (rows past L are zero) as a 64 x 64 K-major
  // tile in TMA's 128-byte swizzle: q.K^T's A operand
#pragma unroll
  for (int i = tid % 128; i < BR * HD / 8; i += 128) {
    const int r = i / (HD / 8), c = i % (HD / 8);  // row, 16-byte chunk
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (qt * BR + r < L) {
      v = *reinterpret_cast<const uint4*>(qb + (long long)(qt * BR + r) * q.sr + 8 * c);
    }
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      w[j] = hopper::pack_bf16(f.x * scale, f.y * scale);
    }
    const uint32_t dst = qtile + (r / 8) * 1024 + (r % 8) * 128 + ((c ^ (r % 8)) * 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(dst), "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]) : "memory");
  }
  hopper::fence_proxy_async();
  hopper::named_sync(1, 128);  // the warpgroup's tile is whole

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  fence_regs(o);  // defined before any wgmma is in flight
  float m_run[2] = {hopper::NEG_INF, hopper::NEG_INF}, l_part[2] = {0.f, 0.f};

  // S = (q*scale) K^T; P.V of tile j and S of tile j + 1 go to the tensor
  // cores back to back, and one wait covers both
  float sc[BC / 2];
  auto issue_s = [&](uint32_t kt) {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      hopper::WgmmaSS<BC>::run(sc, smem_desc(qtile + 32 * kk), smem_desc(kt + 32 * kk), kk > 0);
    }
    hopper::wgmma_commit();
  };
  int j = __shfl_sync(FULL_MASK, bwd::first_tile(frow, 1, nt), 0);
  mbar_wait(smem_u32(&full[0]), 0);
  issue_s(ring);
  for (int it = 0; j < nt; ++it) {
    const int jn = __shfl_sync(FULL_MASK, bwd::next_tile(frow, 1, j + 1, nt), 0);
    const int f = __shfl_sync(FULL_MASK, (int)frow[j], 0);
    const uint32_t vt = ring + (it % STAGES) * 2 * TILE + TILE;
    hopper::wgmma_wait0();  // S of this tile, P.V of the last one
    fence_regs(sc);
    fence_regs(o);
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));

    // the mask (-1e30) and keys past L (-inf: weight 0), as selects
    const int c0 = j * BC;
    if (f == 0) {  // rows past L read row L - 1: they are not stored
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int r = min(row0 + g + 8 * ((i >> 1) & 1), L - 1);
        const int col = min(c0 + 8 * (i >> 2) + 2 * t + (i & 1), L - 1);
        sc[i] = mask[(long long)r * L + col] ? sc[i] : hopper::NEG_INF;
      }
    } else if (f == 2) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) sc[i] = hopper::NEG_INF;
    }
    if (c0 + BC > L) {
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        sc[i] = c0 + 8 * (i >> 2) + 2 * t + (i & 1) >= L ? -CUDART_INF_F : sc[i];
      }
    }
    float alpha[2];
    uint32_t pa[BC / 16][4];
    if (f == 1) {
      hopper::softmax_tile_ex2(sc, m_run, l_part, alpha, pa);
    } else {
      softmax_tile_masked(sc, m_run, l_part, alpha, pa);
    }
    hopper::scale_rows(o, alpha);

    // O += P V: the V tile [key][hd] is B stored MN-major
    fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BC / 16; ++kc) {
      hopper::WgmmaRS<HD, 1>::run(o, pa[kc], smem_desc(vt + 2048 * kc), 1);
    }
    hopper::wgmma_commit();
    if (jn < nt) {
      const int s1 = (it + 1) % STAGES;
      mbar_wait(smem_u32(&full[s1]), ((it + 1) / STAGES) & 1);
      issue_s(ring + s1 * 2 * TILE);
    }
    j = jn;
  }
  hopper::wgmma_wait0();
  fence_regs(o);

  // out = O / l in bf16, lse = m + ln(l) (natural log, as K4 reads it)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    const float l = fmaxf(hopper::quad_sum(l_part[i]), 1e-30f);
    if (r < L) {
      bf16* orow = out + ((long long)bh * L + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] / l, o[4 * n + 2 * i + 1] / l);
      }
      if (t == 0) lse[(long long)bh * L + r] = m_run[i] + logf(l);
    }
  }
}

}  // namespace fwd

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). q, k, v and dO are (B, H, L, 64) bf16 with a dense last dim,
// passed with their (batch, head, row) strides; out, dq, dk and dv are dense
// (B*H, L, 64) bf16; lse and D are dense (B*H, L) fp32; mask is (L, L) bool
// and flags (nt, nt) uint8, nt = ceil(L / 64), one per 64 x 64 tile of the
// mask: 1 where it has no False, 2 where it has no True, else 0. K3 takes
// any scale (q*scale is rounded to bf16 in the kernel); its k and v are
// read by TMA, so their strides are multiples of 16 bytes and their bases
// 16-byte aligned; returns cudaErrorInvalidValue when a tensor map cannot
// be made.
extern "C" int flash_fwd_bf16(const void* q, long long q_sb, long long q_sh, long long q_sr,
                              const void* k, long long k_sb, long long k_sh, long long k_sr,
                              const void* v, long long v_sb, long long v_sh, long long v_sr,
                              const void* mask, const void* flags, void* out, void* lse,
                              int B, int H, int L, float scale, void* stream) {
  static cudaError_t ready = cudaErrorNotReady;  // one card a process
  if (ready == cudaErrorNotReady) {
    ready = bwd::prepare(fwd::flash_fwd_kernel, fwd::LAUNCH_REGS, fwd::SMEM_BYTES);
  }
  if (ready != cudaSuccess) return (int)ready;
  CUtensorMap km, vm;
  if (!bwd::rows_map(&km, k, k_sb, k_sh, k_sr, B, H, L) ||
      !bwd::rows_map(&vm, v, v_sb, v_sh, v_sr, B, H, L)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nt = (L + BR - 1) / BR;
  const long long items = (long long)nt * B * H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  fwd::flash_fwd_kernel<<<(unsigned)items, fwd::THREADS, fwd::SMEM_BYTES, (cudaStream_t)stream>>>(
      km, vm, bwd::Rows{(const bf16*)q, q_sb, q_sh, q_sr}, (const uint8_t*)mask,
      (const uint8_t*)flags, (bf16*)out, (float*)lse, H, L, nt, scale);
  return (int)cudaGetLastError();
}

// K4: dO its cotangent (the shape of q, any strides) and out the forward's
// output (any strides), dsum a (B*H, L) fp32 buffer that the dq pass fills
// with D and the dk/dv pass reads; scale a power of two. The q, k, v and dO
// strides are multiples of 16 bytes, their bases 16-byte aligned (TMA's
// terms); returns cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int flash_bwd_bf16(const void* q, long long q_sb, long long q_sh, long long q_sr,
                              const void* k, long long k_sb, long long k_sh, long long k_sr,
                              const void* v, long long v_sb, long long v_sh, long long v_sr,
                              const void* dout, long long d_sb, long long d_sh, long long d_sr,
                              const void* out, long long o_sb, long long o_sh, long long o_sr,
                              const void* mask, const void* flags, const void* lse, void* dsum,
                              void* dq, void* dk, void* dv,
                              int B, int H, int L, float scale, void* stream) {
  static cudaError_t ready = cudaErrorNotReady;  // one card a process
  if (ready == cudaErrorNotReady) {
    ready = bwd::prepare(bwd::flash_bwd_dq_kernel);
    if (ready == cudaSuccess) ready = bwd::prepare(bwd::flash_bwd_dkv_kernel);
  }
  if (ready != cudaSuccess) return (int)ready;
  CUtensorMap km, vm, qm, dom;
  if (!bwd::rows_map(&km, k, k_sb, k_sh, k_sr, B, H, L) ||
      !bwd::rows_map(&vm, v, v_sb, v_sh, v_sr, B, H, L) ||
      !bwd::rows_map(&qm, q, q_sb, q_sh, q_sr, B, H, L) ||
      !bwd::rows_map(&dom, dout, d_sb, d_sh, d_sr, B, H, L)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nt = (L + BR - 1) / BR;
  const long long items = (long long)nt * B * H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* m = (const uint8_t*)mask;
  const uint8_t* f = (const uint8_t*)flags;
  bwd::flash_bwd_dq_kernel<<<(unsigned)items, bwd::THREADS, bwd::SMEM_BYTES, st>>>(
      km, vm, bwd::Rows{(const bf16*)q, q_sb, q_sh, q_sr},
      bwd::Rows{(const bf16*)dout, d_sb, d_sh, d_sr}, bwd::Rows{(const bf16*)out, o_sb, o_sh, o_sr},
      m, f, (const float*)lse, (float*)dsum, (bf16*)dq, H, L, nt, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd::flash_bwd_dkv_kernel<<<(unsigned)items, bwd::THREADS, bwd::SMEM_BYTES, st>>>(
      qm, dom, bwd::Rows{(const bf16*)k, k_sb, k_sh, k_sr},
      bwd::Rows{(const bf16*)v, v_sb, v_sh, v_sr}, m, f, (const float*)lse, (const float*)dsum,
      (bf16*)dk, (bf16*)dv, H, L, nt, scale);
  return (int)cudaGetLastError();
}

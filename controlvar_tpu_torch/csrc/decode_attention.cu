// KV-cached scale-step decode attention for Hopper (sm_90a), bf16, hd = 64:
// K1 over the paired layout's two caches and K8 over the fused cache.
//
// K1 replaces the TPU kernel controlvar_tpu/ops/attention.py:flash_decode_paired
// (_decode_kernel_paired / _decode_kernel_paired_masked): for every (batch,
// head), out = softmax(q*scale . K^T [mask -> -1e30]) . V over cache rows
// [0, cur) of one layer of the stacked (depth, B, H, L_max, 64) caches.
// K8 replaces ops/attention.py:flash_decode_fused (_decode_kernel_fused): the
// same function over ONE fused (depth, B, H, L_max, 128) buffer whose rows are
// [k_h | v_h], bitwise equal to K1 on the same rows (the JAX package's own
// contract). Rounding points follow the TPU kernel: q*scale is rounded to
// bf16 before q.K^T (fp32 scores), p = exp(s - m) is rounded to bf16 for
// P.V, the denominator sums the unrounded p, and the output is divided once.
//
// What bounds it on the H100: at the d16 serving path's final scale (B*R =
// 64, H = 16, l = 512, cur = 1360) the two products are 1.8e11 FLOP, 0.18 ms
// at the 989 TFLOP/s bf16 tensor-core peak, against 0.36 GB of K and V, 0.11
// ms at 3.35 TB/s: the tensor cores bound it. At VAR-d12's final scale (128
// CFG rows, 12 heads, l = 256, cur = 680) the bytes do: 0.37 GB, 0.11 ms,
// against 6.8e10 FLOP, 0.069 ms.
//
// Design: K6's (csrc/decode_prefix.cu) on a persistent grid. A work item is
// a (q group, batch*head) pair, numbered with the q group fastest; a q group
// is 64 rows (one consumer warpgroup) at l <= 64 and 128 rows (two) above.
// The grid holds as many blocks as fit the card at once (two an SM), never
// more than there are items, and block i takes items i, i + G, i + 2G, ...,
// so the blocks running together cover every q group of a few heads: each
// head's K/V comes from HBM once and from L2 for its other groups. Items run
// along one axis, so B*H has no grid limit. Each block sets up its mbarriers
// and its producer once: a warpgroup that gives its registers to the
// consumers (setmaxnreg) and whose one thread streams 64-row K and V tiles
// with TMA (cp.async.bulk.tensor, 128-byte swizzle) into a ring of 4
// stages, item after item, so it loads the next item's first tiles while
// the consumers finish the last one's. The tile load is the template
// parameter and all compute is shared, so K8 is K1 bit for bit: K1 reads
// two tensor maps, the K and the V layer; K8 one map over the fused layer
// (inner extent 128) in two 64 x 64 boxes a stage, column 0 into the K slot
// and column 64 into the V slot (the swizzle caps a box row at 128 bytes; a
// [k | v] row is 256). Every map ends at row cur, so TMA zero-fills the
// tile that straddles it, and scores past cur are -inf (weight 0). Each
// consumer warpgroup reads its 64 q rows through their strides (the fused
// QKV's view, no copy) into a swizzled shared tile of q*scale; S = q K^T is
// wgmma m64n64k16 with both operands in shared memory (the K tile K-major),
// the optional (l, cur) mask is read in the score fragment's layout, and
// O += P V takes P from registers and the V tile as B stored MN-major (the
// transpose bit), fp32 accumulators in registers. Per tile the warpgroup
// waits once: P.V of tile j and q.K^T of tile j + 1 are issued back to
// back. The exponentials are ex2 of s log2e - m log2e
// (hopper.cuh:softmax_tile_ex2). PERF.md §11.6 has what each step of
// this design measured, and what was tried and dropped (ping-pong between
// the two warpgroups, a one-warp producer, one block an SM, 256-row groups).
// ptxas (CUDA 12.8, sm_90a): 80 registers a thread at launch for the
// two-warpgroup instances (104 for the consumers after setmaxnreg; 28 bytes
// of spill stores), 128 for the one-warpgroup ones (232; no spills); 64
// bytes of static shared memory (the mbarriers) and 74,752 / 82,944 bytes
// dynamic (the 64 KB ring, an 8 KB q tile a warpgroup, 1 KB of alignment).
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

constexpr int HD = 64, BK = 64;
constexpr int STAGES = 4;                       // the TMA ring
constexpr int TILE = BK * HD * 2;               // bytes of one K or V tile

// the ring, each consumer warpgroup's 64 x 64 q tile, and alignment to 1024
template <int NWG>
constexpr int smem_bytes() { return STAGES * 2 * TILE + NWG * 128 * HD + 1024; }

// Registers. A block is NWG consumer warpgroups and one producer warpgroup,
// two blocks an SM, so each thread starts with LAUNCH_REGS of the SM's 64K
// (ptxas allocates exactly that to a kernel that uses setmaxnreg: launch()
// checks it). The producer gives all but 24 back and the consumers take
// what that frees: 104 at NWG = 2 (96 with a one-warp producer, which left
// 5 warps on one of the SM's four schedulers) and 232 at NWG = 1.
template <int NWG>
constexpr int threads_of() { return (NWG + 1) * 128; }
template <int NWG>
constexpr int LAUNCH_REGS = 65536 / (2 * threads_of<NWG>()) / 8 * 8;
constexpr int PRODUCER_REGS = 24;
template <int NWG>
constexpr int CONSUMER_REGS =
    (LAUNCH_REGS<NWG> * threads_of<NWG>() - PRODUCER_REGS * 128) / (NWG * 128) / 8 * 8;

// a (B, H, l, HD) bf16 operand read through its (batch, head, row) strides
struct Rows {
  const __nv_bfloat16* p;
  long long sb, sh, sr;
};

// FUSED: km is the fused layer, rows [k_h | v_h]; vm is unused
template <bool FUSED, int NWG>  // NWG consumer warpgroups: q rows per item = 64 NWG
__global__ void __launch_bounds__(threads_of<NWG>(), 2)
decode_attention_kernel(const __grid_constant__ CUtensorMap km,  // rows [0, cur)
                        const __grid_constant__ CUtensorMap vm,
                        Rows q, const uint8_t* __restrict__ mask,  // (l, cur) or null
                        __nv_bfloat16* __restrict__ out,           // (B*H, l, HD)
                        int H, int l, int cur, int n_groups, int n_items, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: K, then V
  const int tid = threadIdx.x, lane = tid % 32;
  // the warp index, warp-uniform as far as ptxas can see (a shuffle from
  // lane 0): a wgmma under a branch ptxas takes for divergent is serialised
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int ntiles = (cur + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(smem_u32(&full[s]), 1);
      hopper::mbar_init(smem_u32(&empty[s]), 4 * NWG);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup; one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == 4 * NWG && lane == 0) {
      hopper::prefetch_tensormap(&km);
      if (!FUSED) hopper::prefetch_tensormap(&vm);
      int it = 0;  // tiles issued by this block
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / n_groups, b = bh / H, h = bh % H;
        for (int tile = 0; tile < ntiles; ++tile, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(smem_u32(&empty[s]), (it / STAGES - 1) & 1);
          const uint32_t kdst = ring + s * 2 * TILE, bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, 2 * TILE);
          hopper::tma_load_4d(kdst, &km, bar, 0, tile * BK, h, b);
          hopper::tma_load_4d(kdst + TILE, FUSED ? &km : &vm, bar, FUSED ? HD : 0, tile * BK,
                              h, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS<NWG>));
  // Every consumer warpgroup runs every tile of every item, also where its q
  // rows all lie past l (the last group's second warpgroup at some l): it
  // then attends with q = 0 and stores nothing, and no wgmma sits under a
  // branch.
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;  // fragment row / column pair
  const uint32_t qtile = ring + STAGES * 2 * TILE + wg * 64 * HD * 2;
  int it = 0;  // tiles consumed by this block
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int grp = item % n_groups, bh = item / n_groups, b = bh / H, h = bh % H;
    const int row_wg = (grp * NWG + wg) * 64;             // this warpgroup's first q row
    const int row0 = row_wg + (warp % 4) * 16;            // this warp's first q row
    const __nv_bfloat16* qb = q.p + b * q.sb + h * q.sh;
    // q*scale rounded to bf16 (rows past l are zero) as a 64 x 64 K-major
    // tile in TMA's 128-byte swizzle, q.K^T's A operand: read from shared
    // memory, it holds no registers across the tile loop (see hopper.cuh).
    // The last item's wgmma have all completed: nothing reads the old tile.
#pragma unroll
    for (int i = tid % 128; i < 64 * HD / 8; i += 128) {
      const int r = i / (HD / 8), c = i % (HD / 8);  // row, 16-byte chunk
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row_wg + r < l) {
        v = *reinterpret_cast<const uint4*>(qb + (long long)(row_wg + r) * q.sr + 8 * c);
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
    hopper::named_sync(1 + wg, 128);  // the warpgroup's tile is whole

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // o's zeros are set here, not inside the first q.K^T's flight: ptxas
    // serialises every wgmma of a kernel that defines accumulator registers
    // with other instructions while a wgmma is in flight
    fence_regs(o);
    float m_run[2] = {hopper::NEG_INF, hopper::NEG_INF}, l_part[2] = {0.f, 0.f};

    // S = (q*scale) K^T into sc: the K tile [key][hd] is B stored K-major.
    // The loop is software-pipelined: P.V of tile j and q.K^T of tile j + 1
    // go to the tensor cores back to back, and one wait covers both.
    float sc[BK / 2];
    auto issue_s = [&](uint32_t kt) {
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        hopper::WgmmaSS<BK>::run(sc, smem_desc(qtile + 32 * kk), smem_desc(kt + 32 * kk),
                                 kk > 0);
      }
      hopper::wgmma_commit();
    };
    mbar_wait(smem_u32(&full[it % STAGES]), (it / STAGES) & 1);
    issue_s(ring + (it % STAGES) * 2 * TILE);
    for (int t0 = 0; t0 < cur; t0 += BK, ++it) {
      const uint32_t vt = ring + (it % STAGES) * 2 * TILE + TILE;
      hopper::wgmma_wait0();  // S of this tile, P.V of the last one
      fence_regs(sc);
      fence_regs(o);
      if (t0 > 0 && lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));

      // mask (-1e30, as the reference) and the ragged end (-inf: weight 0),
      // as selects: no score is defined under a divergent branch
      if (mask != nullptr) {  // rows past l read row l - 1: they are not stored
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = min(t0 + 8 * (i >> 2) + 2 * t + (i & 1), cur - 1);
          const int r = min(row0 + g + 8 * ((i >> 1) & 1), l - 1);
          sc[i] = mask[(long long)r * cur + col] ? sc[i] : hopper::NEG_INF;
        }
      }
      if (t0 + BK > cur) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = t0 + 8 * (i >> 2) + 2 * t + (i & 1);
          sc[i] = col >= cur ? -CUDART_INF_F : sc[i];
        }
      }
      float alpha[2];
      uint32_t pa[BK / 16][4];
      hopper::softmax_tile_ex2(sc, m_run, l_part, alpha, pa);
      hopper::scale_rows(o, alpha);

      // O += P V: the V tile [key][hd] is B stored MN-major
      fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        hopper::WgmmaRS<HD, 1>::run(o, pa[kc], smem_desc(vt + 2048 * kc), 1);
      }
      hopper::wgmma_commit();
      if (t0 + BK < cur) {
        const int s1 = (it + 1) % STAGES;
        mbar_wait(smem_u32(&full[s1]), ((it + 1) / STAGES) & 1);
        issue_s(ring + s1 * 2 * TILE);
      }
    }
    hopper::wgmma_wait0();
    fence_regs(o);
    if (lane == 0) mbar_arrive(smem_u32(&empty[(it - 1) % STAGES]));

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
}

// Blocks of one launch: as many as fit the card at once, at most n_items.
template <bool FUSED, int NWG>
int launch(const CUtensorMap& km, const CUtensorMap& vm, Rows q, const void* mask, void* out,
           int B, int H, int l, int cur, float scale, cudaStream_t stream) {
  constexpr int threads = threads_of<NWG>();
  static int resident = 0;  // blocks the card holds at once (one card a process)
  if (resident == 0) {
    // setmaxnreg.inc would wait forever for registers the block never had
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, decode_attention_kernel<FUSED, NWG>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != LAUNCH_REGS<NWG>) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(decode_attention_kernel<FUSED, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<NWG>());
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_attention_kernel<FUSED, NWG>, threads, smem_bytes<NWG>());
    }
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  const int n_groups = (l + 64 * NWG - 1) / (64 * NWG);
  const long long items = (long long)n_groups * B * H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int n_items = (int)items;
  const int grid = n_items < resident ? n_items : resident;
  decode_attention_kernel<FUSED, NWG><<<grid, threads, smem_bytes<NWG>(), stream>>>(
      km, vm, q, (const uint8_t*)mask, (__nv_bfloat16*)out, H, l, cur, n_groups, n_items, scale);
  return (int)cudaGetLastError();
}

// rows [0, cur) of a layer, `width` bf16 a row, as a TMA map of 64 x 64 boxes
bool rows_map(CUtensorMap* map, const void* p, long long sb, long long sh, long long sr,
              int B, int H, int cur, int width) {
  const long long dims[4] = {width, cur, H, B}, strides[3] = {sr, sh, sb};
  return hopper::encode_4d(map, p, dims, strides, HD, BK);
}

template <bool FUSED>
int dispatch(const CUtensorMap& km, const CUtensorMap& vm, Rows q, const void* mask,
             void* out, int B, int H, int l, int cur, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return l <= 64 ? launch<FUSED, 1>(km, vm, q, mask, out, B, H, l, cur, scale, st)
                 : launch<FUSED, 2>(km, vm, q, mask, out, B, H, l, cur, scale, st);
}

}  // namespace

// K1: k and v are layer li of the stacked caches, (B, H, L_max, 64) through
// (batch, head, row) strides; q (B, H, l, 64) through its strides; mask (l,
// cur) uint8 or null; out (B*H, l, 64) contiguous. Every stride is a
// multiple of 16 bytes, each base 16-byte aligned (TMA's terms). Launches on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when a tensor map cannot be made.
extern "C" int decode_attention_bf16(const void* q, long long q_sb, long long q_sh,
                                     long long q_sr, const void* k, const void* v,
                                     const void* mask, void* out,
                                     int B, int H, int l, int cur,
                                     long long k_sb, long long k_sh, long long k_sr,
                                     long long v_sb, long long v_sh, long long v_sr,
                                     float scale, void* stream) {
  CUtensorMap km, vm;
  if (!rows_map(&km, k, k_sb, k_sh, k_sr, B, H, cur, HD) ||
      !rows_map(&vm, v, v_sb, v_sh, v_sr, B, H, cur, HD)) {
    return (int)cudaErrorInvalidValue;
  }
  const Rows qr{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr};
  return dispatch<false>(km, vm, qr, mask, out, B, H, l, cur, scale, stream);
}

// K8: kv is layer li of the fused cache, rows [k_h | v_h] of 2 * 64 bf16
// with (batch, head, row) strides kv_sb, kv_sh, kv_sr; the rest as K1.
extern "C" int decode_fused_bf16(const void* q, long long q_sb, long long q_sh, long long q_sr,
                                 const void* kv, const void* mask, void* out,
                                 int B, int H, int l, int cur,
                                 long long kv_sb, long long kv_sh, long long kv_sr,
                                 float scale, void* stream) {
  CUtensorMap km;
  if (!rows_map(&km, kv, kv_sb, kv_sh, kv_sr, B, H, cur, 2 * HD)) {
    return (int)cudaErrorInvalidValue;
  }
  const Rows qr{(const __nv_bfloat16*)q, q_sb, q_sh, q_sr};
  return dispatch<true>(km, km, qr, mask, out, B, H, l, cur, scale, stream);
}

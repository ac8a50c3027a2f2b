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
// L = 1360) the forward is 4 B H L^2 hd = 6.1e10 FLOP (0.061 ms at 989
// TFLOP/s bf16) against 89 MB of q, k, v and out (0.027 ms at 3.35 TB/s), and
// the backward 14 B H L^2 hd = 2.1e11 FLOP (0.21 ms): the tensor cores bound
// both. Every tile of the L x L score matrix is computed, as on the TPU, though
// the block-causal mask leaves 34% of the 64 x 64 tiles fully masked.
//
// Design (after decode_attention.cu): one block of 4 warps owns a 64-row
// output tile, each warp 16 rows, and streams the other operand through
// shared memory in 64-row tiles, double-buffered with cp.async (rows past L
// are zero-filled, and their scores set to -inf, so the ragged last tile
// needs no padded copies). Products run on the tensor cores as mma.sync
// m16n8k16 bf16 with fp32 accumulators; scores, probabilities and the
// accumulators stay in registers. The backward keeps the TPU's split: the dq
// pass owns q tiles and streams K/V, the dk/dv pass owns K/V tiles and
// streams q/dO, so each block writes only its own tile, with no atomics, and
// gradients are the same from run to run. Rounding points are the TPU
// kernels': q*scale is rounded to bf16 before QK^T (also in the backward,
// where the dk/dv pass rounds each streamed q tile once in shared memory);
// p is rounded to bf16 before P.V and P^T.dO; dS is rounded to bf16 before
// dS.K and dS^T.q; dq and dk are multiplied by scale once, after accumulating.
// The wrapper passes one flag per 64 x 64 tile of the mask, saying whether
// the tile has no False or no True: those tiles (97% of the d16 block-causal
// mask) read no mask bytes, which otherwise cost a load per score; fully
// masked tiles are still computed, as on the TPU. wgmma, TMA and skipping
// fully masked tiles are later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dim
constexpr int BR = 64;        // rows of the tile a block owns
constexpr int BC = 64;        // rows of each streamed tile
constexpr int WARPS = BR / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = HD + 8;   // padded shared-memory row (bank-conflict free)
constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernels

typedef __nv_bfloat16 bf16;

// (batch, head, row) strides of a (B, H, L, 64) operand whose last dim is dense
struct Strides {
  long long b, h, r;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int src_size = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
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

// two bf16 values times `scale`, rounded back to bf16 (q*scale of the TPU)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void zero(float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// A fragments (16 rows x 64) of a warp's rows [row0, row0 + 16) of one
// (batch, head) operand, times `scale` and rounded to bf16; rows past L are 0
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], const bf16* base,
                                       long long sr, int row0, int L, float scale,
                                       int g, int t) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + g + (j & 1) * 8, c = kk * 16 + 2 * t + (j >> 1) * 8;
      float2 f = make_float2(0.f, 0.f);
      if (r < L) {
        f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(base + r * sr + c));
      }
      a[kk][j] = pack_bf16(f.x * scale, f.y * scale);
    }
  }
}

// acc (16 x 8n) = A (16 x 64) . T^T, T a 64-row shared tile read as the
// "col" B operand (row n of T is column n of B)
__device__ __forceinline__ void mma_abt(float (&acc)[BC / 8][4], const uint32_t (&a)[HD / 16][4],
                                        const bf16* tile, int g, int t) {
#pragma unroll
  for (int n = 0; n < BC / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bf16* row = tile + (n * 8 + g) * LDS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8);
      mma_bf16(acc[n], a[kk], b0, b1);
    }
  }
}

// acc (16 x 64) += X (16 x 64, fp32 C fragments, rounded to bf16 here) . T,
// T a 64-row shared tile read through ldmatrix.trans as the "row" B operand
__device__ __forceinline__ void mma_xt(float (&acc)[HD / 8][4], const float (&x)[BC / 8][4],
                                       const bf16* tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < BC / 16; ++kc) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                            pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                            pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                            pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
    const unsigned addr = (unsigned)__cvta_generic_to_shared(tile + (kc * 16 + (lane & 15)) * LDS);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t b0, b1;
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(b0), "=r"(b1) : "r"(addr + n * 16));
      mma_bf16(acc[n], xa, b0, b1);
    }
  }
}

// issue the cp.async copies of rows [r0, r0 + 64) of two (B, H, L, 64)
// operands of one (batch, head) into shared tiles
__device__ __forceinline__ void load_tiles(bf16* ta, const bf16* a, long long a_sr,
                                           bf16* tb, const bf16* b, long long b_sr,
                                           int r0, int L, int tid) {
  for (int i = tid; i < BC * HD / 8; i += THREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const bool valid = r0 + r < L;
    const long long rr = valid ? r0 + r : 0;
    cp_async16(&ta[r * LDS + c], a + rr * a_sr + c, valid);
    cp_async16(&tb[r * LDS + c], b + rr * b_sr + c, valid);
  }
}

// Scores of a warp's 16 x 64 C-fragment tile (rows r0 + g + {0, 8},
// columns t0 + 8n + 2t + {0, 1}, as mma lays them out): masked ones to
// -1e30, as the TPU kernels, and columns past L to -inf, which weighs them 0.
// `transposed`: rows are keys and columns queries, so the mask is read as
// mask[col][row]. `flag` is the tile's: 1 (no False) and 2 (no True) read
// no mask bytes, 0 reads one per score.
__device__ __forceinline__ void apply_mask(float (&s)[BC / 8][4], const uint8_t* mask,
                                           uint8_t flag, int r0, int t0, int g, int t, int L,
                                           bool transposed) {
  if (flag == 1 && t0 + BC <= L) return;
#pragma unroll
  for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = t0 + n * 8 + 2 * t + (j & 1), r = r0 + g + (j >> 1) * 8;
      if (col >= L) {
        s[n][j] = -CUDART_INF_F;
      } else if (flag == 2 || (flag == 0 && r < L &&
                               !mask[transposed ? (long long)col * L + r
                                                : (long long)r * L + col])) {
        s[n][j] = NEG_INF;
      }
    }
  }
}

// K3: one block per (64-row q tile, batch*head)
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, Strides qs_, const bf16* __restrict__ k,
                 Strides ks_, const bf16* __restrict__ v, Strides vs_,
                 const uint8_t* __restrict__ mask,   // (L, L)
                 const uint8_t* __restrict__ flags,  // (nt, nt), see apply_mask
                 bf16* __restrict__ out,             // (B*H, L, HD)
                 float* __restrict__ lse,            // (B*H, L)
                 int H, int L, float scale) {
  __shared__ __align__(128) bf16 kt_s[2][BC * LDS];
  __shared__ __align__(128) bf16 vt_s[2][BC * LDS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * BR + warp * 16;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  load_tiles(kt_s[0], kb, ks_.r, vt_s[0], vb, vs_.r, 0, L, tid);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  load_a(qa, q + b * qs_.b + h * qs_.h, qs_.r, row0, L, scale, g, t);

  float o[HD / 8][4];
  zero(o);
  float m_run[2] = {NEG_INF, NEG_INF}, l_part[2] = {0.f, 0.f};  // rows g, g+8

  const int ntiles = (L + BC - 1) / BC;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, t0 = it * BC;
    if (it + 1 < ntiles) {
      load_tiles(kt_s[buf ^ 1], kb, ks_.r, vt_s[buf ^ 1], vb, vs_.r, t0 + BC, L, tid);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    float s[BC / 8][4];
    mma_abt(s, qa, kt_s[buf], g, t);

    // mask (-1e30, as the TPU kernel) and the ragged end (-inf: weight 0)
    apply_mask(s, mask, flags[blockIdx.y * ntiles + it], row0, t0, g, t, L, false);
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
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
    for (int n = 0; n < BC / 8; ++n) {
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
    mma_xt(o, s, vt_s[buf], lane);  // O += P V, P rounded to bf16
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + i * 8;
    const float l = fmaxf(quad_sum(l_part[i]), 1e-30f);
    if (r < L) {
      bf16* orow = out + ((long long)bh * L + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] / l, o[n][2 * i + 1] / l);
      }
      if (t == 0) lse[(long long)bh * L + r] = m_run[i] + logf(l);
    }
  }
}

// K4, dq pass: one block per (64-row q tile, batch*head); streams K and V
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, Strides qs_, const bf16* __restrict__ k,
                    Strides ks_, const bf16* __restrict__ v, Strides vs_,
                    const bf16* __restrict__ dout, Strides ds_,
                    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ flags,
                    const float* __restrict__ lse,    // (B*H, L)
                    const float* __restrict__ dsum,   // (B*H, L): D
                    bf16* __restrict__ dq,            // (B*H, L, HD)
                    int H, int L, float scale) {
  __shared__ __align__(128) bf16 kt_s[2][BC * LDS];
  __shared__ __align__(128) bf16 vt_s[2][BC * LDS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * BR + warp * 16;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  load_tiles(kt_s[0], kb, ks_.r, vt_s[0], vb, vs_.r, 0, L, tid);
  cp_async_commit();

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_a(qa, q + b * qs_.b + h * qs_.h, qs_.r, row0, L, scale, g, t);
  load_a(da, dout + b * ds_.b + h * ds_.h, ds_.r, row0, L, 1.f, g, t);
  float lse_r[2], d_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + i * 8;
    lse_r[i] = r < L ? lse[(long long)bh * L + r] : 0.f;
    d_r[i] = r < L ? dsum[(long long)bh * L + r] : 0.f;
  }

  float acc[HD / 8][4];
  zero(acc);
  const int ntiles = (L + BC - 1) / BC;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, t0 = it * BC;
    if (it + 1 < ntiles) {
      load_tiles(kt_s[buf ^ 1], kb, ks_.r, vt_s[buf ^ 1], vb, vs_.r, t0 + BC, L, tid);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
    mma_abt(s, qa, kt_s[buf], g, t);   // S = (q*scale) K^T
    mma_abt(dp, da, vt_s[buf], g, t);  // dP = dO V^T
    apply_mask(s, mask, flags[blockIdx.y * ntiles + it], row0, t0, g, t, L, false);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[n][j] - lse_r[j >> 1]);
        s[n][j] = p * (dp[n][j] - d_r[j >> 1]);   // dS
      }
    }
    mma_xt(acc, s, kt_s[buf], lane);  // dq += dS K, dS rounded to bf16
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + i * 8;
    if (r < L) {
      bf16* row = dq + ((long long)bh * L + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(row + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
      }
    }
  }
}

// K4, dk/dv pass: one block per (64-row K/V tile, batch*head); streams q and
// dO. Each warp computes the transposed products for its 16 key rows:
// S^T = K (q*scale)^T, dP^T = V dO^T, dv += P^T dO, dk += dS^T q.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, Strides qs_, const bf16* __restrict__ k,
                     Strides ks_, const bf16* __restrict__ v, Strides vs_,
                     const bf16* __restrict__ dout, Strides ds_,
                     const uint8_t* __restrict__ mask, const uint8_t* __restrict__ flags,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,  // (B*H, L, HD)
                     int H, int L, float scale) {
  __shared__ __align__(128) bf16 qt_s[2][BC * LDS];
  __shared__ __align__(128) bf16 dt_s[2][BC * LDS];
  __shared__ __align__(128) bf16 qs_s[BC * LDS];   // q*scale of the current tile
  __shared__ float lse_s[2][BC], d_s[2][BC];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * BR + warp * 16;   // this warp's first key row
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* db = dout + b * ds_.b + h * ds_.h;
  const float* lse_b = lse + (long long)bh * L;
  const float* d_b = dsum + (long long)bh * L;

  auto load = [&](int t0, int buf) {
    load_tiles(qt_s[buf], qb, qs_.r, dt_s[buf], db, ds_.r, t0, L, tid);
    if (tid < BC) {
      lse_s[buf][tid] = t0 + tid < L ? lse_b[t0 + tid] : 0.f;
    } else if (tid < 2 * BC) {
      d_s[buf][tid - BC] = t0 + tid - BC < L ? d_b[t0 + tid - BC] : 0.f;
    }
  };
  load(0, 0);
  cp_async_commit();

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a(ka, k + b * ks_.b + h * ks_.h, ks_.r, row0, L, 1.f, g, t);
  load_a(va, v + b * vs_.b + h * vs_.h, vs_.r, row0, L, 1.f, g, t);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int ntiles = (L + BC - 1) / BC;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, t0 = it * BC;
    if (it + 1 < ntiles) load(t0 + BC, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    // q*scale rounded to bf16, once per tile
    for (int i = tid; i < BC * HD / 2; i += THREADS) {
      const int off = (i / (HD / 2)) * LDS + (i % (HD / 2)) * 2;
      *reinterpret_cast<uint32_t*>(&qs_s[off]) =
          scale_bf16x2(*reinterpret_cast<const uint32_t*>(&qt_s[buf][off]), scale);
    }
    __syncthreads();

    float s[BC / 8][4], dp[BC / 8][4];
    mma_abt(s, ka, qs_s, g, t);         // S^T = K (q*scale)^T
    mma_abt(dp, va, dt_s[buf], g, t);   // dP^T = V dO^T
    apply_mask(s, mask, flags[it * ntiles + blockIdx.y], row0, t0, g, t, L, true);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = n * 8 + 2 * t + (j & 1);                   // query in the tile
        s[n][j] = __expf(s[n][j] - lse_s[buf][cl]);               // P^T
        dp[n][j] = s[n][j] * (dp[n][j] - d_s[buf][cl]);           // dS^T
      }
    }
    mma_xt(dv_acc, s, dt_s[buf], lane);   // dv += P^T dO, P rounded to bf16
    mma_xt(dk_acc, dp, qt_s[buf], lane);  // dk += dS^T q, dS rounded to bf16
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + i * 8;
    if (r < L) {
      const long long off = ((long long)bh * L + r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
            __floats2bfloat162_rn(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
            __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() (0 on
// success). q, k, v and dO are (B, H, L, 64) bf16 with a dense last dim,
// passed with their (batch, head, row) strides; out, dq, dk and dv are dense
// (B*H, L, 64) bf16; lse and D are dense (B*H, L) fp32; mask is (L, L) bool
// and flags (nt, nt) uint8, nt = ceil(L / 64), one per 64 x 64 tile of the
// mask: 1 where it has no False, 2 where it has no True, else 0.
extern "C" int flash_fwd_bf16(const void* q, long long q_sb, long long q_sh, long long q_sr,
                              const void* k, long long k_sb, long long k_sh, long long k_sr,
                              const void* v, long long v_sb, long long v_sh, long long v_sr,
                              const void* mask, const void* flags, void* out, void* lse,
                              int B, int H, int L, float scale, void* stream) {
  dim3 grid(B * H, (L + BR - 1) / BR);
  flash_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, Strides{q_sb, q_sh, q_sr}, (const bf16*)k, Strides{k_sb, k_sh, k_sr},
      (const bf16*)v, Strides{v_sb, v_sh, v_sr}, (const uint8_t*)mask, (const uint8_t*)flags,
      (bf16*)out, (float*)lse, H, L, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_bf16(const void* q, long long q_sb, long long q_sh, long long q_sr,
                              const void* k, long long k_sb, long long k_sh, long long k_sr,
                              const void* v, long long v_sb, long long v_sh, long long v_sr,
                              const void* dout, long long d_sb, long long d_sh, long long d_sr,
                              const void* mask, const void* flags, const void* lse,
                              const void* dsum,
                              void* dq, void* dk, void* dv,
                              int B, int H, int L, float scale, void* stream) {
  dim3 grid(B * H, (L + BR - 1) / BR);
  const Strides qs{q_sb, q_sh, q_sr}, ks{k_sb, k_sh, k_sr}, vs{v_sb, v_sh, v_sr},
      ds{d_sb, d_sh, d_sr};
  flash_bwd_dq_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, qs, (const bf16*)k, ks, (const bf16*)v, vs, (const bf16*)dout, ds,
      (const uint8_t*)mask, (const uint8_t*)flags, (const float*)lse, (const float*)dsum,
      (bf16*)dq, H, L, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, qs, (const bf16*)k, ks, (const bf16*)v, vs, (const bf16*)dout, ds,
      (const uint8_t*)mask, (const uint8_t*)flags, (const float*)lse, (const float*)dsum,
      (bf16*)dk, (bf16*)dv, H, L, scale);
  return (int)cudaGetLastError();
}

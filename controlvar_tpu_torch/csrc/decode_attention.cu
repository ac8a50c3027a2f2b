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
// contract). The two share every line of compute and differ only in how a
// tile reaches shared memory (the template parameter FUSED): K1 copies a
// 64-row K tile and a 64-row V tile, K8 one 64 x 128 block, 256 contiguous
// bytes a row, whose first 64 columns land in the K tile and last 64 in the
// V tile. So the shared tiles, and everything computed from them, are the
// same bits.
//
// What bounds it on the H100: at the d16 serving path's final scale (B*R =
// 64, H = 16, l = 512, cur = 1360) the two products are 1.8e11 FLOP, 0.18 ms
// at the 989 TFLOP/s bf16 tensor-core peak, against 0.36 GB of K and V, 0.11
// ms at 3.35 TB/s: the tensor cores bound it. At VAR-d12's final scale (128
// CFG rows, 12 heads, l = 256, cur = 680) the bytes do: 0.37 GB, 0.110 ms,
// against 6.8e10 FLOP, 0.069 ms. At the seven small scales (l <= 72) a 64-row
// q tile is mostly padding and launch cost dominates.
//
// Design: one block of 4 warps per (64-row q tile, batch*head); each warp
// owns 16 q rows. K/V stream through shared memory in 64-row tiles, read in
// place from the cache through strides (no copy of the prefix), double-
// buffered with cp.async (rows past cur are zero-filled). Both products run
// on the tensor cores as mma.sync m16n8k16 bf16 with fp32 accumulation; the
// scores, the online softmax (running max and sum) and the output stay in
// registers, and the score fragments are re-packed in place as the A operand
// of P.V. Rounding points follow the TPU kernel: q*scale is rounded to bf16
// before the first product, and the probabilities are rounded to bf16 before
// the second. wgmma/TMA and warp specialisation are later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // cache rows per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = HD + 8;   // padded shared-memory row (bank-conflict free)
constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernel

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

// FUSED: k is the fused layer base, rows [k_h | v_h] with k's strides; v and
// its strides are unused
template <bool FUSED>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,   // (B*H, l, HD)
                        const __nv_bfloat16* __restrict__ k,   // layer base
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ mask,      // (l, cur) or null
                        __nv_bfloat16* __restrict__ out,       // (B*H, l, HD)
                        int H, int l, int cur,
                        long long k_sb, long long k_sh, long long k_sr,
                        long long v_sb, long long v_sh, long long v_sr,
                        float scale) {
  __shared__ __align__(128) __nv_bfloat16 ks[2][BK * LDS];
  __shared__ __align__(128) __nv_bfloat16 vs[2][BK * LDS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment row / column pair
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * BQ + warp * 16;  // this warp's first q row
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  auto load_tile = [&](int t0, int buf) {
    if constexpr (FUSED) {
      // one 64 x 2HD block: chunks 0..7 of a row are k_h, 8..15 are v_h
      for (int i = tid; i < BK * 2 * HD / 8; i += THREADS) {
        const int r = i / (2 * HD / 8), c = (i % (2 * HD / 8)) * 8;
        const bool valid = t0 + r < cur;
        const long long rr = valid ? t0 + r : 0;
        __nv_bfloat16* dst = c < HD ? &ks[buf][r * LDS + c] : &vs[buf][r * LDS + c - HD];
        cp_async16(dst, kb + rr * k_sr + c, valid);
      }
    } else {
      for (int i = tid; i < BK * HD / 8; i += THREADS) {
        const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
        const bool valid = t0 + r < cur;
        const long long rr = valid ? t0 + r : 0;
        cp_async16(&ks[buf][r * LDS + c], kb + rr * k_sr + c, valid);
        cp_async16(&vs[buf][r * LDS + c], vb + rr * v_sr + c, valid);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_tile(0, 0);

  // q*scale as A fragments, rounded to bf16; rows past l are zero
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + g + (j & 1) * 8, c = kk * 16 + 2 * t + (j >> 1) * 8;
      float2 f = make_float2(0.f, 0.f);
      if (r < l) {
        f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            q + ((long long)bh * l + r) * HD + c));
      }
      qa[kk][j] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_part[2] = {0.f, 0.f};  // rows g, g+8

  const int ntiles = (cur + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1, t0 = it * BK;
    if (it + 1 < ntiles) {
      load_tile(t0 + BK, buf ^ 1);
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

    // mask (-1e30, as the reference) and the ragged end (-inf: weight 0)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t0 + n * 8 + 2 * t + (j & 1), r = row0 + g + (j >> 1) * 8;
        if (col >= cur) {
          s[n][j] = -CUDART_INF_F;
        } else if (mask != nullptr && r < l && !mask[(long long)r * cur + col]) {
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

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* mask, void* out,
                                     int B, int H, int l, int cur,
                                     long long k_sb, long long k_sh, long long k_sr,
                                     long long v_sb, long long v_sh, long long v_sr,
                                     float scale, void* stream) {
  dim3 grid(B * H, (l + BQ - 1) / BQ);
  decode_attention_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const uint8_t*)mask, (__nv_bfloat16*)out, H, l, cur,
      k_sb, k_sh, k_sr, v_sb, v_sh, v_sr, scale);
  return (int)cudaGetLastError();
}

// K8: kv is layer li of the fused cache, rows [k_h | v_h] of 2 * 64 bf16 with
// (batch, head, row) strides kv_sb, kv_sh, kv_sr.
extern "C" int decode_fused_bf16(const void* q, const void* kv, const void* mask, void* out,
                                 int B, int H, int l, int cur,
                                 long long kv_sb, long long kv_sh, long long kv_sr,
                                 float scale, void* stream) {
  dim3 grid(B * H, (l + BQ - 1) / BQ);
  decode_attention_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kv, (const __nv_bfloat16*)kv,
      (const uint8_t*)mask, (__nv_bfloat16*)out, H, l, cur,
      kv_sb, kv_sh, kv_sr, kv_sb, kv_sh, kv_sr, scale);
  return (int)cudaGetLastError();
}

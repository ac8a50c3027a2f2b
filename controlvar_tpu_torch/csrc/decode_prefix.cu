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
// What bounds it on the H100: at the d24 joint path's final scale (16 CFG
// rows, 24 heads, l = 512, pos = 848) the two products are 6.8e10 FLOP,
// 0.069 ms at 989 TFLOP/s, against 0.18 GB of q, K, V and out, 0.055 ms at
// 3.35 TB/s: the tensor cores bound it, as they do K1. K6 adds the 50 MB
// fresh-row write.
//
// Design: K1's (csrc/decode_attention.cu). One block of 4 warps per (64-row
// q tile, batch*head); each warp owns 16 q rows. K/V stream through shared
// memory in 64-row tiles, double-buffered with cp.async: first the prefix
// tiles, read through strides, then the fresh tiles, into the same running
// max and denominator (the TPU's joint softmax over two score tiles becomes
// one online softmax over both ranges). Rows past pos in the prefix range
// and past l in the fresh range are zero-filled and their scores set to -inf
// (weight 0), so no padded copy of either exists; the TPU's 8-aligned
// prefix block and padded fresh rows are its tiling, not the function.
// mma.sync m16n8k16 bf16 with fp32 accumulation; wgmma/TMA are later work.
//
// K6's write: blocks of one (b, h) run in any order, so no block reads a
// cache row at or past pos (those tiles come from k_new/v_new), and each
// block writes the fresh rows of its own q tile, [64 y, 64 y + 64) of l,
// into rows pos + r: exactly l rows, nothing past pos + l, no race with
// any read.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
                     int write,  // K6: copy k_new/v_new into rows pos.. of pk/pv
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

  if (write) {  // this q tile's fresh rows into cache rows pos + r
    __nv_bfloat16* wkb = const_cast<__nv_bfloat16*>(pkb);
    __nv_bfloat16* wvb = const_cast<__nv_bfloat16*>(pvb);
    for (int i = tid; i < BQ * HD / 8; i += THREADS) {
      const int r = blockIdx.y * BQ + i / (HD / 8), c = (i % (HD / 8)) * 8;
      if (r < l) {
        *reinterpret_cast<uint4*>(wkb + (long long)(pos + r) * pk.sr + c) =
            *reinterpret_cast<const uint4*>(nkb + (long long)r * nk.sr + c);
        *reinterpret_cast<uint4*>(wvb + (long long)(pos + r) * pv.sr + c) =
            *reinterpret_cast<const uint4*>(nvb + (long long)r * nv.sr + c);
      }
    }
  }

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

int launch(const void* q, long long q_sb, long long q_sh, long long q_sr,
           const void* pk, long long pk_sb, long long pk_sh, long long pk_sr,
           const void* pv, long long pv_sb, long long pv_sh, long long pv_sr,
           const void* nk, long long nk_sb, long long nk_sh, long long nk_sr,
           const void* nv, long long nv_sb, long long nv_sh, long long nv_sr,
           const void* mask, void* out, int write, int B, int H, int l, int pos,
           float scale, void* stream) {
  using bf = const __nv_bfloat16*;
  dim3 grid(B * H, (l + BQ - 1) / BQ);
  decode_prefix_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      Rows{(bf)q, q_sb, q_sh, q_sr}, Rows{(bf)pk, pk_sb, pk_sh, pk_sr},
      Rows{(bf)pv, pv_sb, pv_sh, pv_sr}, Rows{(bf)nk, nk_sb, nk_sh, nk_sr},
      Rows{(bf)nv, nv_sb, nv_sh, nv_sr}, (const uint8_t*)mask, (__nv_bfloat16*)out,
      write, H, l, pos, scale);
  return (int)cudaGetLastError();
}

}  // namespace

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
  return launch(q, q_sb, q_sh, q_sr, pk, pk_sb, pk_sh, pk_sr, pv, pv_sb, pv_sh, pv_sr,
                nk, nk_sb, nk_sh, nk_sr, nv, nv_sb, nv_sh, nv_sr, mask, out, 0,
                B, H, l, pos, scale, stream);
}

// K6: ck/cv are layer li of the stacked caches (rows [0, pos) are read,
// rows [pos, pos + l) are written from nk/nv); unmasked.
extern "C" int decode_inplace_bf16(
    const void* q, long long q_sb, long long q_sh, long long q_sr,
    void* ck, long long ck_sb, long long ck_sh, long long ck_sr,
    void* cv, long long cv_sb, long long cv_sh, long long cv_sr,
    const void* nk, long long nk_sb, long long nk_sh, long long nk_sr,
    const void* nv, long long nv_sb, long long nv_sh, long long nv_sr,
    void* out, int B, int H, int l, int pos, float scale, void* stream) {
  return launch(q, q_sb, q_sh, q_sr, ck, ck_sb, ck_sh, ck_sr, cv, cv_sb, cv_sh, cv_sr,
                nk, nk_sb, nk_sh, nk_sr, nv, nv_sb, nv_sh, nv_sr, nullptr, out, 1,
                B, H, l, pos, scale, stream);
}

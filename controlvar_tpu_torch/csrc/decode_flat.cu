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
// Design: K1's (csrc/decode_attention.cu). One block of 4 warps per (64-row
// q tile, batch*head); each warp owns 16 q rows; the grid runs over B*H, so
// an odd head count needs nothing of its own. What is K7's own is the
// layout: a K^T or V^T tile is hd rows (head dims) of 64 contiguous keys,
// streamed through shared memory double-buffered with cp.async straight from
// the cache's strides. The K^T tile is the first product's B operand stored
// k-major, so ldmatrix .trans gives its fragments; the V^T tile is already
// the column-major B operand of P.V, read with plain 32-bit loads. The chunk
// of 8 keys that holds `cur` is read only up to cur (cp.async's source size;
// the rest is zero-filled), nothing at or past L_max is read, and scores past
// cur are -inf (weight 0). Both products run as mma.sync m16n8k16 bf16 with
// fp32 accumulation, with the online softmax and the output in registers.
// Two buffers of K^T and V^T tiles take 576*hd bytes of shared memory (72 KB
// at hd = 128), so every instance takes it as dynamic shared memory after
// the opt-in. wgmma/TMA are later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDT = BK + 8;   // padded shared-memory row of 64 keys (bank-conflict free)
constexpr float NEG_INF = -1e30f;  // masked score, as the TPU kernel

// 16 bytes to shared memory of which the first `bytes` are read from global
// memory and the rest zero-filled (0: nothing read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_flat_kernel(const __nv_bfloat16* __restrict__ q,    // (B*H, l, HD)
                   const __nv_bfloat16* __restrict__ kT,   // layer base, (B, H, HD, L)
                   const __nv_bfloat16* __restrict__ vT,
                   const uint8_t* __restrict__ mask,       // (l, cur) or null
                   __nv_bfloat16* __restrict__ out,        // (B*H, l, HD)
                   int H, int l, int cur,
                   long long k_sb, long long k_sh, long long k_sd,
                   long long v_sb, long long v_sh, long long v_sd,
                   float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][HD][LDT]
  __nv_bfloat16* vs = ks + 2 * HD * LDT;                           // [2][HD][LDT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment row / column pair
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int row0 = blockIdx.y * BQ + warp * 16;  // this warp's first q row
  const __nv_bfloat16* kb = kT + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = vT + b * v_sb + h * v_sh;

  // one tile: HD rows of BK keys, 8 chunks of 8 keys a row; a chunk reads
  // only its keys below cur
  auto load_tile = [&](int t0, int buf) {
    for (int i = tid; i < HD * (BK / 8); i += THREADS) {
      const int d = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int n = min(max(cur - (t0 + c), 0), 8);
      const long long col = n > 0 ? t0 + c : 0;
      cp_async16(&ks[(buf * HD + d) * LDT + c], kb + d * k_sd + col, 2 * n);
      cp_async16(&vs[(buf * HD + d) * LDT + c], vb + d * v_sd + col, 2 * n);
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
    const __nv_bfloat16* kt = ks + buf * HD * LDT;
    const __nv_bfloat16* vt = vs + buf * HD * LDT;

    // S = (q*scale) K^T: the K^T tile is stored [head dim][key], k-major, so
    // ldmatrix .trans gives the B fragments of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const unsigned kaddr = (unsigned)__cvta_generic_to_shared(
          kt + (kk * 16 + (lane & 15)) * LDT);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1) : "r"(kaddr + n * 16));
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

    // O += P V; P's score fragments of key chunk kc are the A operand, and
    // the V^T tile's rows (one head dim each) hold the B fragments' pairs
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const __nv_bfloat16* vrow = vt + (n * 8 + g) * LDT + kc * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int B, int H, int l, int cur,
           long long k_sb, long long k_sh, long long k_sd,
           long long v_sb, long long v_sh, long long v_sd,
           float scale, void* stream) {
  const int smem = 4 * HD * LDT * (int)sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_flat_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (l + BQ - 1) / BQ);
  decode_flat_kernel<HD><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const uint8_t*)mask, (__nv_bfloat16*)out, H, l, cur,
      k_sb, k_sh, k_sd, v_sb, v_sh, v_sd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim with no instance.
extern "C" int decode_flat_bf16(int hd, const void* q, const void* k, const void* v,
                                const void* mask, void* out, int B, int H, int l, int cur,
                                long long k_sb, long long k_sh, long long k_sd,
                                long long v_sb, long long v_sh, long long v_sd,
                                float scale, void* stream) {
#define CASE(D)                                                                  \
  case D:                                                                        \
    return launch<D>(q, k, v, mask, out, B, H, l, cur, k_sb, k_sh, k_sd, v_sb,   \
                     v_sh, v_sd, scale, stream);
  switch (hd) {
    CASE(16) CASE(32) CASE(48) CASE(64) CASE(80) CASE(96) CASE(112) CASE(128)
  }
#undef CASE
  return (int)cudaErrorInvalidValue;
}

// The transformer blocks' AdaLN chains for Hopper (sm_90a): the LayerNorm,
// the modulation and the gated residual of each site, one pass a site.
//
// Replaces no TPU kernel: under jit, XLA fused these chains on the TPU. The
// port ran each as a dozen eager PyTorch ops, each of which wrote its result
// to device memory and read it back. A layer of models/transformer.py meets
// the rows (g1, g2, s1, s2, sh1, sh2) of its fp32 modulation (B, 6, C) at
// three sites:
//   adaln_norm_kernel      hn  = LN(h) (1 + s1) + sh1                  (QKV in)
//   adaln_add_norm_kernel  h'  = h + g1 (y + b) keep,                  (proj out)
//                          hn  = LN(h') (1 + s2) + sh2                 (FFN in)
//   adaln_add_kernel       h'' = h' + g2 (f + b) keep                  (fc2 out)
// LN is affine-free, its statistics fp32 and two-pass (the mean, then the
// mean of the squared deviation), with eps. y and f are the projections'
// outputs before their bias b, in the residual dtype or in fp32 (a
// tensor-parallel model group's sum); keep is an optional per-sample
// drop-path factor. Every value stays fp32 from its load to the one store in
// the residual dtype (bf16 or fp32): the eager chains' intermediate roundings
// are dropped, none is added. h' is normalised as computed, before its store.
//
// What bounds it on the H100: bytes. A bf16 site moves 4, 8 and 6 bytes an
// element of C (h in, hn out; h and y in, h' and hn out; h' and f in, h''
// out), against about 212 for the eager chains; the modulation's rows
// (4 to 12 bytes an element of a batch row, fp32) come from L2, which holds
// a layer's (B, 6, C). At the serving path's final scale (64 rows x 512
// tokens, C 1920) that is 1.0 GB a layer-step, 0.30 ms at 3.35 TB/s.
//
// Design: a block per (batch row, TOK consecutive tokens of it), C/8 threads
// (rounded up to a warp), each holding 8 columns of every token in registers,
// read and written 16 bytes at a time (two float4 for fp32). A block reads
// the modulation rows' and the bias's columns once for its TOK tokens, and
// issues all TOK tokens' loads before its first reduction; each LN pass
// reduces the TOK sums together (warp shuffles, then one shared-memory
// exchange: two barriers a block). TOK is 2 where that leaves at least 4
// blocks an SM, else 1, so the small scales (128 rows a launch) run a token
// a block and do not wait on a long block, and the large ones (32,768 rows)
// read the modulation half as often. Over one layer of a call's ten scales
// at 64 rows and C 1920, TOK up to 4 measured 3.9% slower (fewer blocks an
// SM: 80-90 registers) and TOK 1 throughout 6.6% slower (PERF.md). Blocks
// are 256 threads at most (C <= 2048); a wider C takes 1024-thread blocks of
// one token.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int VEC = 8;                  // columns a thread
constexpr int THREADS = 256;            // C <= 2048 (d30: 1920), up to 2 tokens a block
constexpr int WIDE_THREADS = 1024;      // C <= 8192, a token a block
constexpr int MIN_BLOCKS = 4 * 132;     // 4 blocks on each of the H100's SMs
constexpr unsigned FULL_MASK = 0xffffffffu;
enum Site { NORM, ADD_NORM, ADD };
enum Dtype { BF16 = 0, F32 = 1 };       // the wrapper's codes

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// s[t] <- the block's sum of s[t], for each of the TOK tokens at once
template <int TOK>
__device__ __forceinline__ void block_sum(float (&s)[TOK], float (*red)[TOK]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[t] += __shfl_xor_sync(FULL_MASK, s[t], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < TOK; ++t) red[warp][t] = s[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
    float a = 0.f;
    for (int w = 0; w < warps; ++w) a += red[w][t];
    s[t] = a;
  }
}

// The modulation rows of a site: batch row b's C values of each at
// row + b * sb (sb 0: one row for all).
struct Rows {
  const float *gate, *scale, *shift;
  long long sb;
};

// One site over the tokens [TOK * blockIdx.x, + TOK) of batch row blockIdx.y.
// h, y, h_out, n_out: (B, l, C) dense; bias (C,); keep: (B,) or null.
template <int SITE, int TOK, int MAXT, typename T, typename Y>
__device__ __forceinline__ void adaln_rows(const T* __restrict__ h, const Y* __restrict__ y,
                                           const Y* __restrict__ bias, const Rows m,
                                           const float* __restrict__ keep,
                                           T* __restrict__ h_out, T* __restrict__ n_out,
                                           int l, int C, float eps) {
  const int b = blockIdx.y, tok0 = blockIdx.x * TOK, c = threadIdx.x * VEC;
  const int ntok = min(TOK, l - tok0);
  const bool on = c < C;
  const long long mb = b * m.sb + c;
  const long long base = ((long long)b * l + tok0) * C + c;

  float x[TOK][VEC];
#pragma unroll
  for (int t = 0; t < TOK; ++t) {
    if (on && t < ntok) {
      load8(h + base + (long long)t * C, x[t]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[t][i] = 0.f;
    }
  }
  float sc[VEC], sh[VEC];   // s and sh, loaded before the reductions wait
  if constexpr (SITE != ADD) {
    if (on) {
      load8(m.scale + mb, sc);
      load8(m.shift + mb, sh);
    }
  }
  if constexpr (SITE != NORM) {
    float g[VEC], bb[VEC];
    const float k = keep == nullptr ? 1.f : keep[b];
    if (on) {
      load8(m.gate + mb, g);
      load8(bias + c, bb);
    }
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      if (on && t < ntok) {
        float v[VEC];
        load8(y + base + (long long)t * C, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[t][i] += (v[i] + bb[i]) * g[i] * k;
        store8(h_out + base + (long long)t * C, x[t]);
      }
    }
  }
  if constexpr (SITE != ADD) {
    __shared__ float red[2][MAXT / 32][TOK];
    float s[TOK], mean[TOK];
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      s[t] = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[t] += x[t][i];
    }
    block_sum<TOK>(s, red[0]);
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      mean[t] = s[t] / C;
      s[t] = 0.f;
      if (on) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = x[t][i] - mean[t];
          s[t] += d * d;
        }
      }
    }
    block_sum<TOK>(s, red[1]);
    if (!on) return;
#pragma unroll
    for (int i = 0; i < VEC; ++i) sc[i] += 1.f;
#pragma unroll
    for (int t = 0; t < TOK; ++t) {
      if (t < ntok) {
        const float rstd = rsqrtf(s[t] / C + eps);
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = (x[t][i] - mean[t]) * rstd * sc[i] + sh[i];
        store8(n_out + base + (long long)t * C, o);
      }
    }
  }
}

template <int TOK, int MAXT, typename T>
__global__ void __launch_bounds__(MAXT)
adaln_norm_kernel(const T* h, const Rows m, T* hn, int l, int C, float eps) {
  adaln_rows<NORM, TOK, MAXT, T, T>(h, nullptr, nullptr, m, nullptr, nullptr, hn, l, C, eps);
}

template <int TOK, int MAXT, typename T, typename Y>
__global__ void __launch_bounds__(MAXT)
adaln_add_norm_kernel(const T* h, const Y* y, const Y* bias, const Rows m, const float* keep,
                      T* h_out, T* hn, int l, int C, float eps) {
  adaln_rows<ADD_NORM, TOK, MAXT, T, Y>(h, y, bias, m, keep, h_out, hn, l, C, eps);
}

template <int TOK, int MAXT, typename T, typename Y>
__global__ void __launch_bounds__(MAXT)
adaln_add_kernel(const T* h, const Y* y, const Y* bias, const Rows m, const float* keep,
                 T* h_out, int l, int C) {
  adaln_rows<ADD, TOK, MAXT, T, Y>(h, y, bias, m, keep, h_out, nullptr, l, C, 0.f);
}

struct Args {
  const void *h, *y, *bias, *keep;
  Rows m;
  void *h_out, *n_out;
  int B, l, C;
  float eps;
  cudaStream_t stream;
};

template <int SITE, int TOK, int MAXT, typename T, typename Y>
void launch(const Args& p) {
  const dim3 grid((p.l + TOK - 1) / TOK, p.B), block((p.C / VEC + 31) / 32 * 32);
  const T* h = (const T*)p.h;
  const Y *y = (const Y*)p.y, *bias = (const Y*)p.bias;
  const float* keep = (const float*)p.keep;
  if constexpr (SITE == NORM) {
    adaln_norm_kernel<TOK, MAXT, T><<<grid, block, 0, p.stream>>>(h, p.m, (T*)p.n_out, p.l,
                                                                  p.C, p.eps);
  } else if constexpr (SITE == ADD_NORM) {
    adaln_add_norm_kernel<TOK, MAXT, T, Y><<<grid, block, 0, p.stream>>>(
        h, y, bias, p.m, keep, (T*)p.h_out, (T*)p.n_out, p.l, p.C, p.eps);
  } else {
    adaln_add_kernel<TOK, MAXT, T, Y><<<grid, block, 0, p.stream>>>(
        h, y, bias, p.m, keep, (T*)p.h_out, p.l, p.C);
  }
}

template <int SITE, typename T, typename Y>
void by_tokens(const Args& p) {
  if (p.C > VEC * THREADS) {
    launch<SITE, 1, WIDE_THREADS, T, Y>(p);
    return;
  }
  if ((long long)p.B * ((p.l + 1) / 2) >= MIN_BLOCKS) {
    launch<SITE, 2, THREADS, T, Y>(p);
  } else {
    launch<SITE, 1, THREADS, T, Y>(p);
  }
}

template <int SITE>
int run(int dt_h, int dt_y, const Args& p) {
  if (p.C <= 0 || p.C % VEC != 0 || p.C > VEC * WIDE_THREADS || p.B <= 0 || p.B > 65535 ||
      p.l <= 0 || (dt_h != BF16 && dt_h != F32) || (dt_y != BF16 && dt_y != F32)) {
    return (int)cudaErrorInvalidValue;
  }
  typedef __nv_bfloat16 bf16;
  if (dt_h == BF16 && dt_y == BF16) {
    by_tokens<SITE, bf16, bf16>(p);
  } else if (dt_h == BF16) {
    by_tokens<SITE, bf16, float>(p);
  } else if (dt_y == BF16) {
    by_tokens<SITE, float, bf16>(p);
  } else {
    by_tokens<SITE, float, float>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dt_*: 0 bf16, 1 fp32. Pointers 16-byte aligned; the modulation rows'
// batch stride sb (elements) a multiple of 4, 0 for one row for all.
extern "C" int adaln_norm(int dt_h, const void* h, const void* scale, const void* shift,
                          long long sb, void* hn, int B, int l, int C, float eps,
                          void* stream) {
  const Rows m{nullptr, (const float*)scale, (const float*)shift, sb};
  const Args p{h, nullptr, nullptr, nullptr, m, nullptr, hn, B, l, C, eps,
               (cudaStream_t)stream};
  return run<NORM>(dt_h, dt_h, p);
}

extern "C" int adaln_add_norm(int dt_h, int dt_y, const void* h, const void* y,
                              const void* bias, const void* gate, const void* scale,
                              const void* shift, long long sb, const void* keep, void* h_out,
                              void* hn, int B, int l, int C, float eps, void* stream) {
  const Rows m{(const float*)gate, (const float*)scale, (const float*)shift, sb};
  const Args p{h, y, bias, keep, m, h_out, hn, B, l, C, eps, (cudaStream_t)stream};
  return run<ADD_NORM>(dt_h, dt_y, p);
}

extern "C" int adaln_add(int dt_h, int dt_y, const void* h, const void* y, const void* bias,
                         const void* gate, long long sb, const void* keep, void* h_out, int B,
                         int l, int C, void* stream) {
  const Rows m{(const float*)gate, nullptr, nullptr, sb};
  const Args p{h, y, bias, keep, m, h_out, nullptr, B, l, C, 0.f, (cudaStream_t)stream};
  return run<ADD>(dt_h, dt_y, p);
}

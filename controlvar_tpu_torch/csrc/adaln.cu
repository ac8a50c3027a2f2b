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
//
// The backward (adaln_*_bwd_kernel), for training, where autograd calls it
// through ops/adaln.py: with x^ = (h - mu) rstd, u = dhn (1 + s),
//   norm      dh = rstd (u - mean_C(u) - x^ mean_C(u x^)),
//             ds = sum_l dhn x^, dsh = sum_l dhn;
//   add_norm  t = dh' + (the same LN backward of dhn through h'), dh = t,
//             dy = t g keep, dg = keep sum_l t (y + b), db = sum_b g keep sum_l t,
//             ds and dsh as for norm, of h';
//   add       dh = dout (the wrapper returns it as is), df = dout g keep,
//             dg and db as for add_norm with t = dout.
// A bf16 site moves 6, 12 and 6 bytes an element (h and dhn in, dh out; h,
// y, dh' and dhn in, dh and dy out; f and dout in, df out), against the
// eager chains' autograd of the same order as their forward. The LN
// statistics are recomputed in registers from the h (and y) that the
// backward loads anyway, two-pass as in the forward; h' is recomputed as the
// forward computes it, so the forward saves nothing of C width beyond its
// inputs. Design: the forward's, a block per (batch row, tpb consecutive
// tokens), 8 columns a thread, walking its tokens TOKB at a time; an LN
// site reduces a step's sums in two block reductions (the mean; then the
// squared deviation, sum u and sum u x^ together); a variant that loaded
// the next step before those barriers measured 2-3% faster and was left out
// (PERF.md). The column sums over tokens (the row and bias gradients) stay
// in registers across the block's tokens and are stored once as fp32
// partials (nq, B, blocks a row, C); adaln_bwd_sum_kernel adds a row's
// partials, adaln_bwd_batch_kernel the rows where the batch is summed (the
// bias, one modulation row for all), each in a fixed order: no atomics, so
// a gradient is the same bit for bit from run to run. The wrapper picks tpb
// so that the grid is one wave of the blocks the device holds at once
// (adaln_bwd_capacity: 2 an SM, 264 blocks, 42 tokens at B 8 and l 1360;
// three waves of 20 tokens measured 15-31% slower, PERF.md).
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

// ---- the backward ------------------------------------------------------------

constexpr int MID_THREADS = 512;        // backward, C <= 4096, a token at a time
constexpr int SUM_ROWS = 8;             // adaln_bwd_sum_kernel: 32 columns x 8 threads
constexpr int BATCH_THREADS = 256;      // adaln_bwd_batch_kernel
enum Which { W_NORM = 0, W_ADD_NORM = 1, W_ADD = 2 };   // adaln_bwd_capacity's codes

// Where a site's column sums lie in the partials: LN sites (shift, scale),
// branch sites (gate, bias) after them.
template <int SITE>
struct Quantities {
  static constexpr int SHIFT = 0, SCALE = 1;
  static constexpr int GATE = SITE == ADD ? 0 : 2, BIAS = GATE + 1;
  static constexpr int N = SITE == ADD_NORM ? 4 : 2;
};

// One step's loads: x h, v y, d dhn, e dh' or dout (zeros past C and l).
template <int TOKB>
struct Step {
  float x[TOKB][VEC], v[TOKB][VEC], d[TOKB][VEC], e[TOKB][VEC];
};

template <int SITE, int TOKB, typename T, typename Y>
__device__ __forceinline__ void load_step(Step<TOKB>& s, const T* __restrict__ h,
                                          const Y* __restrict__ y, const T* __restrict__ dout,
                                          const T* __restrict__ dn, long long base, int C,
                                          int nt, bool on) {
#pragma unroll
  for (int t = 0; t < TOKB; ++t) {
    const long long o = base + (long long)t * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s.x[t][i] = s.v[t][i] = s.d[t][i] = s.e[t][i] = 0.f;
    if (on && t < nt) {
      if constexpr (SITE != ADD) {
        load8(h + o, s.x[t]);
        load8(dn + o, s.d[t]);
      }
      if constexpr (SITE != NORM) {
        load8(y + o, s.v[t]);
        load8(dout + o, s.e[t]);
      }
    }
  }
}

// One site's backward over the tokens [tpb * blockIdx.x, + tpb) of batch row
// blockIdx.y, TOKB at a time. NORM: dn = dhn; ADD_NORM: dout = dh', dn = dhn;
// ADD: dout. dh, dy and part may be null (not asked for).
template <int SITE, int TOKB, int MAXT, typename T, typename Y>
__device__ __forceinline__ void adaln_bwd_rows(
    const T* __restrict__ h, const Y* __restrict__ y, const Y* __restrict__ bias,
    const Rows m, const float* __restrict__ keep, const T* __restrict__ dout,
    const T* __restrict__ dn, T* __restrict__ dh, Y* __restrict__ dy,
    float* __restrict__ part, int l, int C, int tpb, float eps) {
  constexpr bool LN = SITE != ADD, BRANCH = SITE != NORM;
  typedef Quantities<SITE> Q;
  const int b = blockIdx.y, c = threadIdx.x * VEC;
  const int tok0 = blockIdx.x * tpb, tok1 = min(l, tok0 + tpb);
  const bool on = c < C;
  const long long mb = b * m.sb + c;
  const long long row = (long long)b * l * C + c;

  float sc[VEC] = {}, g[VEC] = {}, bb[VEC] = {};   // 0 past C: those lanes add 0 to the sums
  const float k = (BRANCH && keep != nullptr) ? keep[b] : 1.f;
  if (on) {
    if constexpr (LN) {
      load8(m.scale + mb, sc);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sc[i] += 1.f;
    }
    if constexpr (BRANCH) {
      load8(m.gate + mb, g);
      load8(bias + c, bb);
    }
  }
  float acc[Q::N][VEC];
#pragma unroll
  for (int q = 0; q < Q::N; ++q) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
  }
  __shared__ float red1[MAXT / 32][TOKB];
  __shared__ float red3[MAXT / 32][3 * TOKB];

  for (int t0 = tok0; t0 < tok1; t0 += TOKB) {
    const int nt = min(TOKB, tok1 - t0);
    const long long base = row + (long long)t0 * C;
    Step<TOKB> cur;
    load_step<SITE, TOKB, T, Y>(cur, h, y, dout, dn, base, C, nt, on);
    // x: h (h' once the branch is added, then its deviation from the mean)
    if constexpr (BRANCH) {
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          cur.v[t][i] += bb[i];
          if constexpr (SITE == ADD_NORM) cur.x[t][i] += cur.v[t][i] * g[i] * k;
        }
      }
    }
    float rstd[TOKB], mu[TOKB], mux[TOKB];
    if constexpr (LN) {
      float s[TOKB], s3[3 * TOKB];
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
        s[t] = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[t] += cur.x[t][i];
      }
      block_sum<TOKB>(s, red1);
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
        const float mean = s[t] / C;
        float dd = 0.f, su = 0.f, sux = 0.f;
        if (on) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            cur.x[t][i] -= mean;
            const float u = cur.d[t][i] * sc[i];
            dd += cur.x[t][i] * cur.x[t][i];
            su += u;
            sux += u * cur.x[t][i];
          }
        }
        s3[3 * t] = dd;
        s3[3 * t + 1] = su;
        s3[3 * t + 2] = sux;
      }
      block_sum<3 * TOKB>(s3, red3);
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
        rstd[t] = rsqrtf(s3[3 * t] / C + eps);
        mu[t] = s3[3 * t + 1] / C;
        mux[t] = s3[3 * t + 2] * rstd[t] / C;   // mean_C(u x^)
      }
    }
    if (on) {
#pragma unroll
      for (int t = 0; t < TOKB; ++t) {
        if (t >= nt) continue;
        const long long o = base + (long long)t * C;
        float gx[VEC], gy[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float grad = cur.e[t][i];
          if constexpr (LN) {
            const float xh = cur.x[t][i] * rstd[t];
            grad += rstd[t] * (cur.d[t][i] * sc[i] - mu[t] - xh * mux[t]);
            acc[Q::SHIFT][i] += cur.d[t][i];
            acc[Q::SCALE][i] += cur.d[t][i] * xh;
          }
          if constexpr (BRANCH) {
            acc[Q::GATE][i] += grad * cur.v[t][i];
            acc[Q::BIAS][i] += grad;
            gy[i] = grad * g[i] * k;
          }
          gx[i] = grad;
        }
        if (SITE != ADD && dh != nullptr) store8(dh + o, gx);
        if (BRANCH && dy != nullptr) store8(dy + o, gy);
      }
    }
  }
  if (part != nullptr && on) {
#pragma unroll
    for (int q = 0; q < Q::N; ++q) {
      store8(part + (((long long)q * gridDim.y + b) * gridDim.x + blockIdx.x) * C + c, acc[q]);
    }
  }
}

template <int TOKB, int MAXT, typename T>
__global__ void __launch_bounds__(MAXT, MAXT <= THREADS ? 2 : 1)
adaln_norm_bwd_kernel(const T* h, const Rows m, const T* dhn, T* dh, float* part, int l,
                      int C, int tpb, float eps) {
  adaln_bwd_rows<NORM, TOKB, MAXT, T, T>(h, nullptr, nullptr, m, nullptr, nullptr, dhn, dh,
                                         nullptr, part, l, C, tpb, eps);
}

template <int TOKB, int MAXT, typename T, typename Y>
__global__ void __launch_bounds__(MAXT, MAXT <= THREADS ? 2 : 1)
adaln_add_norm_bwd_kernel(const T* h, const Y* y, const Y* bias, const Rows m,
                          const float* keep, const T* dh_out, const T* dhn, T* dh, Y* dy,
                          float* part, int l, int C, int tpb, float eps) {
  adaln_bwd_rows<ADD_NORM, TOKB, MAXT, T, Y>(h, y, bias, m, keep, dh_out, dhn, dh, dy, part,
                                             l, C, tpb, eps);
}

template <int TOKB, int MAXT, typename T, typename Y>
__global__ void __launch_bounds__(MAXT, MAXT <= THREADS ? 2 : 1)
adaln_add_bwd_kernel(const Y* y, const Y* bias, const Rows m, const float* keep,
                     const T* dout, Y* dy, float* part, int l, int C, int tpb) {
  adaln_bwd_rows<ADD, TOKB, MAXT, T, Y>(nullptr, y, bias, m, keep, dout, nullptr, nullptr, dy,
                                        part, l, C, tpb, 0.f);
}

// A row's column sums from the partials (nq, B, nblk, C): a block per (32
// columns, batch row b), its SUM_ROWS warps splitting the nblk partials,
// added in a fixed order. Per-row gradients (sb != 0) are written (B, C);
// what adaln_bwd_batch_kernel sums over the batch (the bias's g_b keep_b
// sum_l t, and one row for all's gradients) replaces the row's first partial.
// Outputs may be null (not asked for).
template <int SITE>
__global__ void __launch_bounds__(32 * SUM_ROWS)
adaln_bwd_sum_kernel(float* __restrict__ part, const Rows m, const float* __restrict__ keep,
                     float* dgate, float* dscale, float* dshift, int nblk, int C) {
  typedef Quantities<SITE> Q;
  constexpr bool LN = SITE != ADD, BRANCH = SITE != NORM;
  __shared__ float red[Q::N][SUM_ROWS][32];
  const int tx = threadIdx.x, ty = threadIdx.y, c = blockIdx.x * 32 + tx, b = blockIdx.y;
  const int B = gridDim.y;
  const bool on = c < C, per_row = m.sb != 0;
  float s[Q::N];
#pragma unroll
  for (int q = 0; q < Q::N; ++q) s[q] = 0.f;
  if (on) {
    for (int j = ty; j < nblk; j += SUM_ROWS) {
#pragma unroll
      for (int q = 0; q < Q::N; ++q) s[q] += part[(((long long)q * B + b) * nblk + j) * C + c];
    }
  }
#pragma unroll
  for (int q = 0; q < Q::N; ++q) red[q][ty][tx] = s[q];
  __syncthreads();
  if (ty != 0 || !on) return;
  float r[Q::N];
#pragma unroll
  for (int q = 0; q < Q::N; ++q) {
    r[q] = 0.f;
#pragma unroll
    for (int w = 0; w < SUM_ROWS; ++w) r[q] += red[q][w][tx];
  }
  const long long o = (long long)b * C + c;
  auto first = [&](int q) -> float& { return part[((long long)q * B + b) * nblk * C + c]; };
  const float k = keep == nullptr ? 1.f : keep[b];
  if constexpr (LN) {
    if (per_row) {
      if (dshift != nullptr) dshift[o] = r[Q::SHIFT];
      if (dscale != nullptr) dscale[o] = r[Q::SCALE];
    } else {
      first(Q::SHIFT) = r[Q::SHIFT];
      first(Q::SCALE) = r[Q::SCALE];
    }
  }
  if constexpr (BRANCH) {
    if (per_row) {
      if (dgate != nullptr) dgate[o] = k * r[Q::GATE];
    } else {
      first(Q::GATE) = k * r[Q::GATE];
    }
    first(Q::BIAS) = m.gate[b * m.sb + c] * k * r[Q::BIAS];
  }
}

// The batch's sums over b, in order, of what adaln_bwd_sum_kernel left in
// each row's first partial: the bias's gradient, and one row for all's
// (sb 0) gradients, (1, C).
template <int SITE>
__global__ void __launch_bounds__(BATCH_THREADS)
adaln_bwd_batch_kernel(const float* __restrict__ part, long long sb, float* dgate,
                       float* dscale, float* dshift, float* dbias, int B, int nblk, int C) {
  typedef Quantities<SITE> Q;
  constexpr bool LN = SITE != ADD, BRANCH = SITE != NORM;
  const int c = blockIdx.x * BATCH_THREADS + threadIdx.x;
  if (c >= C) return;
  float t[Q::N];
#pragma unroll
  for (int q = 0; q < Q::N; ++q) t[q] = 0.f;
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int q = 0; q < Q::N; ++q) t[q] += part[((long long)q * B + b) * nblk * C + c];
  }
  if (sb == 0) {
    if (LN && dshift != nullptr) dshift[c] = t[Q::SHIFT];
    if (LN && dscale != nullptr) dscale[c] = t[Q::SCALE];
    if (BRANCH && dgate != nullptr) dgate[c] = t[Q::GATE];
  }
  if (BRANCH && dbias != nullptr) dbias[c] = t[Q::BIAS];
}

struct BwdArgs {
  const void *h, *y, *bias, *keep;
  Rows m;
  const void *dout, *dn;
  void *dh, *dy;
  float *part, *dgate, *dscale, *dshift, *dbias;
  int B, l, C, tpb;
  float eps;
  cudaStream_t stream;
};

template <int SITE, int TOKB, int MAXT, typename T, typename Y>
const void* bwd_kernel() {
  if constexpr (SITE == NORM) {
    return (const void*)adaln_norm_bwd_kernel<TOKB, MAXT, T>;
  } else if constexpr (SITE == ADD_NORM) {
    return (const void*)adaln_add_norm_bwd_kernel<TOKB, MAXT, T, Y>;
  } else {
    return (const void*)adaln_add_bwd_kernel<TOKB, MAXT, T, Y>;
  }
}

// Launches a site's backward: the kernel, then the column sums.
struct Launch {
  const BwdArgs& p;
  template <int SITE, int TOKB, int MAXT, typename T, typename Y>
  int run() const {
    const int nblk = (p.l + p.tpb - 1) / p.tpb;
    const dim3 grid(nblk, p.B), block((p.C / VEC + 31) / 32 * 32);
    const Y *y = (const Y*)p.y, *bias = (const Y*)p.bias;
    const float* keep = (const float*)p.keep;
    if constexpr (SITE == NORM) {
      adaln_norm_bwd_kernel<TOKB, MAXT, T><<<grid, block, 0, p.stream>>>(
          (const T*)p.h, p.m, (const T*)p.dn, (T*)p.dh, p.part, p.l, p.C, p.tpb, p.eps);
    } else if constexpr (SITE == ADD_NORM) {
      adaln_add_norm_bwd_kernel<TOKB, MAXT, T, Y><<<grid, block, 0, p.stream>>>(
          (const T*)p.h, y, bias, p.m, keep, (const T*)p.dout, (const T*)p.dn, (T*)p.dh,
          (Y*)p.dy, p.part, p.l, p.C, p.tpb, p.eps);
    } else {
      adaln_add_bwd_kernel<TOKB, MAXT, T, Y><<<grid, block, 0, p.stream>>>(
          y, bias, p.m, keep, (const T*)p.dout, (Y*)p.dy, p.part, p.l, p.C, p.tpb);
    }
    if (p.part == nullptr) return 0;
    adaln_bwd_sum_kernel<SITE><<<dim3((p.C + 31) / 32, p.B), dim3(32, SUM_ROWS), 0,
                                 p.stream>>>(p.part, p.m, keep, p.dgate, p.dscale, p.dshift,
                                             nblk, p.C);
    if (p.m.sb == 0 || p.dbias != nullptr) {
      adaln_bwd_batch_kernel<SITE><<<(p.C + BATCH_THREADS - 1) / BATCH_THREADS,
                                     BATCH_THREADS, 0, p.stream>>>(
          p.part, p.m.sb, p.dgate, p.dscale, p.dshift, p.dbias, p.B, nblk, p.C);
    }
    return 0;
  }
};

// The blocks of a site's backward kernel resident on the device at once.
struct Capacity {
  int C;
  template <int SITE, int TOKB, int MAXT, typename T, typename Y>
  int run() const {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bwd_kernel<SITE, TOKB, MAXT, T, Y>(), (C / VEC + 31) / 32 * 32, 0);
    }
    return err != cudaSuccess ? -(int)err : max(per_sm, 1) * sms;
  }
};

// TOKB: as many tokens a step as the registers hold at 2 blocks an SM.
template <int SITE, typename T, typename Y, typename Op>
int by_width_bwd(int C, const Op& op) {
  constexpr int TOKB = SITE == ADD_NORM ? 2 : 4;
  if (C <= VEC * THREADS) return op.template run<SITE, TOKB, THREADS, T, Y>();
  if (C <= VEC * MID_THREADS) return op.template run<SITE, 1, MID_THREADS, T, Y>();
  return op.template run<SITE, 1, WIDE_THREADS, T, Y>();
}

template <int SITE, typename Op>
int by_dtype_bwd(int dt_h, int dt_y, int C, const Op& op) {
  typedef __nv_bfloat16 bf16;
  if (dt_h == BF16 && dt_y == BF16) return by_width_bwd<SITE, bf16, bf16>(C, op);
  if (dt_h == BF16) return by_width_bwd<SITE, bf16, float>(C, op);
  if (dt_y == BF16) return by_width_bwd<SITE, float, bf16>(C, op);
  return by_width_bwd<SITE, float, float>(C, op);
}

bool bad_bwd(int dt_h, int dt_y, int C) {
  return C <= 0 || C % VEC != 0 || C > VEC * WIDE_THREADS || (dt_h != BF16 && dt_h != F32) ||
         (dt_y != BF16 && dt_y != F32);
}

template <int SITE>
int run_bwd(int dt_h, int dt_y, const BwdArgs& p) {
  if (bad_bwd(dt_h, dt_y, p.C) || p.B <= 0 || p.B > 65535 || p.l <= 0 || p.tpb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  by_dtype_bwd<SITE>(dt_h, dt_y, p.C, Launch{p});
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

// The backward. part: (nq, B, ceil(l / tpb), C) fp32 (nq 2, 4, 2), or null
// where no row or bias gradient is asked for; the row gradients (B, C), or
// (1, C) for one row for all (sb 0); dbias (C,) fp32. A null output is not
// written.
extern "C" int adaln_norm_bwd(int dt_h, const void* h, const void* scale, long long sb,
                              const void* dhn, void* dh, float* part, float* dscale,
                              float* dshift, int B, int l, int C, int tpb, float eps,
                              void* stream) {
  const Rows m{nullptr, (const float*)scale, nullptr, sb};
  const BwdArgs p{h, nullptr, nullptr, nullptr, m, nullptr, dhn, dh, nullptr, part, nullptr,
                  dscale, dshift, nullptr, B, l, C, tpb, eps, (cudaStream_t)stream};
  return run_bwd<NORM>(dt_h, dt_h, p);
}

extern "C" int adaln_add_norm_bwd(int dt_h, int dt_y, const void* h, const void* y,
                                  const void* bias, const void* gate, const void* scale,
                                  long long sb, const void* keep, const void* dh_out,
                                  const void* dhn, void* dh, void* dy, float* part,
                                  float* dgate, float* dscale, float* dshift, float* dbias,
                                  int B, int l, int C, int tpb, float eps, void* stream) {
  const Rows m{(const float*)gate, (const float*)scale, nullptr, sb};
  const BwdArgs p{h, y, bias, keep, m, dh_out, dhn, dh, dy, part, dgate, dscale, dshift,
                  dbias, B, l, C, tpb, eps, (cudaStream_t)stream};
  return run_bwd<ADD_NORM>(dt_h, dt_y, p);
}

extern "C" int adaln_add_bwd(int dt_h, int dt_y, const void* y, const void* bias,
                             const void* gate, long long sb, const void* keep,
                             const void* dout, void* dy, float* part, float* dgate,
                             float* dbias, int B, int l, int C, int tpb, void* stream) {
  const Rows m{(const float*)gate, nullptr, nullptr, sb};
  const BwdArgs p{nullptr, y, bias, keep, m, dout, nullptr, nullptr, dy, part, dgate, nullptr,
                  nullptr, dbias, B, l, C, tpb, 0.f, (cudaStream_t)stream};
  return run_bwd<ADD>(dt_h, dt_y, p);
}

// The blocks of site `which`'s backward kernel (0 norm, 1 add_norm, 2 add)
// resident on the current device at once, for the wrapper's tokens a block;
// minus a cudaError_t on failure.
extern "C" int adaln_bwd_capacity(int which, int dt_h, int dt_y, int C) {
  if (bad_bwd(dt_h, dt_y, C)) return -(int)cudaErrorInvalidValue;
  const Capacity op{C};
  if (which == W_NORM) return by_dtype_bwd<NORM>(dt_h, dt_h, C, op);
  if (which == W_ADD_NORM) return by_dtype_bwd<ADD_NORM>(dt_h, dt_y, C, op);
  if (which == W_ADD) return by_dtype_bwd<ADD>(dt_h, dt_y, C, op);
  return -(int)cudaErrorInvalidValue;
}

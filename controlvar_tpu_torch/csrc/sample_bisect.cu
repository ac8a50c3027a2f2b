// Sort-free top-k / top-p sampling for Hopper (sm_90a): per-row bisection
// filter, then a gumbel-max draw over the kept set.
//
// Replaces the TPU kernel controlvar_tpu/ops/sample_kernel.py:
// sample_top_k_top_p_bisect (kept_mask, _sample_kernel with the noise as an
// input, _sample_kernel_prng with in-kernel random bits). Per row of fp32
// logits (V <= 4096):
//   top-k: 26 bisection steps on count(l >= t) >= k           -> kept l >= lo
//   top-p: 26 steps on the strictly-greater kept exp(l - m) mass >= top_p*Z
//          (the crossing token is kept)                        -> kept l > lo2
//   entries more than 80 nats below the row max are never kept;
//   draw: argmax over the kept set of l + gumbel, ties to the smallest index.
//
// What bounds it on the H100: one read of the logits (12288 x 4096 fp32 =
// 201 MB at the final scale, 0.06 ms at 3.35 TB/s); the 52 passes over a row
// run from registers. Design: one block of 256 threads per row, 16 values
// per thread held in registers for every pass; each bisection step is one
// block reduction. Noise is either read from an (n, V) fp32 input, or made by
// a Philox4x32-10 written into the kernel, counter (column, row), key (two
// seed words), with u = (x >> 9 + 0.5) * 2^-23 and g = -log(-log(u)) as the
// TPU kernel does.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;            // values per thread: V <= THREADS * PER
constexpr float NEG_INF = -1e30f;  // the filter sentinel of the TPU kernel
constexpr float TAIL_NATS = 80.f;
constexpr int N_ITER = 26;         // bisection steps per filter

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();  // red is free: every thread has read the previous result
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];  // same order in every thread
  return t;
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) t = fmaxf(t, red[w]);
  return t;
}

// Philox4x32-10 (Salmon et al., SC'11): first output word of counter
// (c0, c1, 0, 0) under key (k0, k1).
__device__ __forceinline__ uint32_t philox_x0(uint32_t c0, uint32_t c1,
                                              uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

template <bool PRNG>
__global__ void __launch_bounds__(THREADS)
sample_bisect_kernel(const float* __restrict__ logits, const float* __restrict__ noise,
                     long long* __restrict__ out, int V, int top_k, float top_p,
                     uint32_t s0, uint32_t s1) {
  __shared__ float red[WARPS];
  __shared__ float best_v[WARPS];
  __shared__ int best_i[WARPS];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* lr = logits + (long long)row * V;

  float x[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * THREADS + tid;
    x[j] = c < V ? lr[c] : -CUDART_INF_F;  // padding is never kept
  }
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < PER; ++j) m = fmaxf(m, x[j]);
  m = block_max(m, red);
  const float lo0 = m - TAIL_NATS;

  // top-k: invariant count(l >= lo) >= k, count(l >= hi) < k
  float thr_k = lo0;
  if (top_k > 0 && top_k < V) {
    float lo = lo0, hi = m + 1.0f;
    for (int it = 0; it < N_ITER; ++it) {
      const float mid = 0.5f * (lo + hi);
      float cnt = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) cnt += x[j] >= mid ? 1.f : 0.f;
      if (block_sum(cnt, red) >= (float)top_k) lo = mid; else hi = mid;
    }
    thr_k = lo;
  }

  // top-p: keep x iff the kept mass strictly above x is < top_p * Z
  float thr_p = -CUDART_INF_F;
  if (top_p > 0.f) {
    float e[PER];
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      e[j] = x[j] >= thr_k ? expf(x[j] - m) : 0.f;
      z += e[j];
    }
    const float pz = top_p * block_sum(z, red);
    float lo = lo0, hi = m + 1.0f;
    for (int it = 0; it < N_ITER; ++it) {
      const float mid = 0.5f * (lo + hi);
      float gm = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) gm += x[j] > mid ? e[j] : 0.f;
      if (block_sum(gm, red) >= pz) lo = mid; else hi = mid;
    }
    thr_p = lo;
  }

  // gumbel-max over the kept set; columns rise with j, so a strict > keeps
  // the smallest index among equal values
  float bv = -CUDART_INF_F;
  int bi = 0x7fffffff;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * THREADS + tid;
    if (c < V) {
      float g;
      if constexpr (PRNG) {
        const uint32_t bits = philox_x0((uint32_t)c, (uint32_t)row, s0, s1);
        const float u = ((float)(bits >> 9) + 0.5f) * (1.0f / 8388608.0f);
        g = -logf(-logf(u));
      } else {
        g = noise[(long long)row * V + c];
      }
      const float zv = (x[j] >= thr_k && x[j] > thr_p) ? x[j] + g : NEG_INF;
      if (zv > bv) { bv = zv; bi = c; }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  if (tid % 32 == 0) { best_v[tid / 32] = bv; best_i[tid / 32] = bi; }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < WARPS; ++w) {
      if (best_v[w] > bv || (best_v[w] == bv && best_i[w] < bi)) { bv = best_v[w]; bi = best_i[w]; }
    }
    out[row] = bi;
  }
}

}  // namespace

// noise == nullptr: in-kernel Philox seeded with (s0, s1). Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sample_bisect_f32(const void* logits, const void* noise, void* out,
                                 int n, int V, int top_k, float top_p,
                                 uint32_t s0, uint32_t s1, void* stream) {
  if (V > THREADS * PER) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (noise == nullptr) {
    sample_bisect_kernel<true><<<n, THREADS, 0, st>>>(
        (const float*)logits, nullptr, (long long*)out, V, top_k, top_p, s0, s1);
  } else {
    sample_bisect_kernel<false><<<n, THREADS, 0, st>>>(
        (const float*)logits, (const float*)noise, (long long*)out, V, top_k, top_p,
        s0, s1);
  }
  return (int)cudaGetLastError();
}

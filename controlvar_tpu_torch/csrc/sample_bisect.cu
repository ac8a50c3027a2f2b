// Sort-free top-k / top-p sampling for Hopper (sm_90a): per row, the
// bisection filter's two thresholds found by exact selections, then a
// gumbel-max draw over the kept set.
//
// Replaces the TPU kernel controlvar_tpu/ops/sample_kernel.py:
// sample_top_k_top_p_bisect (kept_mask, _sample_kernel with the noise as an
// input, _sample_kernel_prng with in-kernel random bits). Per row of fp32
// logits (V <= 4096), the kept set is the TPU kernel's:
//   top-k: 26 bisection steps on count(l >= mid) >= k       -> kept l >= lo
//   top-p: 26 steps on the strictly-greater kept exp(l - m) mass >= top_p*Z
//          (the crossing token is kept)                      -> kept l > lo2
//   entries more than 80 nats below the row max are never kept;
//   draw: argmax over the kept set of l + gumbel, ties to the smallest index.
//
// How the thresholds are reached. count(l >= mid) >= k holds exactly when
// v_k >= mid, v_k the row's k-th largest logit (counts are exact integers),
// so a selection finds v_k and every thread replays the 26 midpoints mid =
// 0.5 (lo + hi) from lo = m - 80, hi = m + 1 against it, in registers:
// thr_k is the bisection's bit for bit. The top-p mass of {l > mid} is
// summed as integers (exp(l - m) <= 1 in fixed point of 2^-39, exact and in
// no order), so it does not increase with mid, and mass >= top_p Z holds
// exactly when mid < y*, y* the largest logit whose mass at or above it
// reaches ceil(top_p Z): a second selection, weighted by the masses, finds
// y*, and a replay gives thr_p. A row where the fp32 sums of the plain
// version move the crossing may keep one token more or less, as any other
// summation order would. No float atomics: the same seed gives the same
// ids.
//
// A selection is one histogram pass over BINS bins of equal width of the
// value range ([m - 80, m + 1) for top-k, [thr_k, m + 1) for top-p: a
// larger value never takes a lower bin) by 32-bit integer shared-memory
// atomics, exact in any order, and a block scan of the bins from the
// highest down to the bin where the weight crosses the target (3 block
// barriers); then the entries of that bin, compacted into a list, are
// ranked by the first warp when they are at most 32 (the usual case: a
// bin is 81/2048 nats wide or less), else three radix passes over their
// order-preserving uint32 keys (11, 11 and 10 bits) find the key. 13 block
// barriers a row in the usual case, where the bisection took 108.
//
// The draw: the kept columns are compacted into shared memory, so Philox
// (and the two logs) run only for them, spread over all threads. Lists are
// appended with one shared atomic a warp, in an order that no result
// depends on.
//
// What bounds it on the H100: one read of the logits (12288 x 4096 fp32 =
// 201 MB at the serving path's final scale, 0.06 ms at 3.35 TB/s); the
// per-logit max, compares and exp, and Philox4x32-10 with two logs per
// kept logit, are below that at the int32 and fp32 rates (chip_smoke.py
// counts them). It does not reach that bound: each row is a chain of
// dependent steps (selection passes, replays, the draw) that keeps its
// block's 8 warps waiting on each other, and the card holds 4 such blocks
// an SM. Design: one block of 256 threads per row, 16 keys per thread held
// in registers throughout (64 registers, 24 bytes spilled, at 4 blocks an
// SM; 512- and 1024-thread blocks, and 2, 3 or 5 blocks an SM, measured
// slower or no faster, PERF.md). Noise is either read from an (n, V) fp32 input,
// or made by a Philox4x32-10 written into the kernel, counter (column,
// row), key (two seed words), with u = (x >> 9 + 0.5) * 2^-23 and g =
// -log(-log(u)) as the TPU kernel does.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;            // values per thread: V <= THREADS * PER
constexpr int MIN_BLOCKS = 4;      // blocks an SM that the registers must allow
constexpr int BINS = 2048;         // histogram bins of an 11-bit digit
constexpr float TAIL_NATS = 80.f;
constexpr int N_ITER = 26;         // bisection steps per filter
constexpr unsigned FULL_MASK = 0xffffffffu;
typedef unsigned long long u64;

// the order-preserving image of an fp32 value in uint32, and back
__device__ __forceinline__ uint32_t key_of(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Histograms of integer weights in shared memory, by 32-bit atomics (a
// 64-bit shared atomic add is a compare-and-swap loop). Counts: one array.
struct CountHist {
  typedef uint32_t W;
  uint32_t* c;
  __device__ __forceinline__ void add(int d, W w) const { atomicAdd(&c[d], w); }
  // bins [d, d + 4) (d a multiple of 4), read, then zeroed
  __device__ __forceinline__ void take4(int d, W (&v)[4]) const {
    uint4* p = reinterpret_cast<uint4*>(c + d);
    const uint4 x = *p;
    *p = make_uint4(0u, 0u, 0u, 0u);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};

// Masses in fixed point of 2^-39 (at most 2^39 each): the bits above 20 and
// the 20 below in two arrays, whose sums over at most 4096 entries stay
// below 2^31 and 2^32.
struct MassHist {
  typedef u64 W;
  uint32_t* hi;
  uint32_t* lo;
  __device__ __forceinline__ void add(int d, W w) const {
    atomicAdd(&hi[d], (uint32_t)(w >> 20));
    atomicAdd(&lo[d], (uint32_t)w & 0xfffffu);
  }
  __device__ __forceinline__ void take4(int d, W (&v)[4]) const {
    uint4* ph = reinterpret_cast<uint4*>(hi + d);
    uint4* pl = reinterpret_cast<uint4*>(lo + d);
    const uint4 h = *ph, l = *pl;
    *ph = *pl = make_uint4(0u, 0u, 0u, 0u);
    v[0] = ((W)h.x << 20) + l.x, v[1] = ((W)h.y << 20) + l.y;
    v[2] = ((W)h.z << 20) + l.z, v[3] = ((W)h.w << 20) + l.w;
  }
};

// what one select pass leaves for all threads
template <typename W>
struct Found {
  W wsum[WARPS];  // the warps' sums of bins
  uint32_t digit;
  W need;
};

// the key bits that a select has fixed once its pass of bits [SHIFT, SHIFT +
// BITS) is done with: those above it
template <int SHIFT, int BITS>
__host__ __device__ constexpr uint32_t known() {
  return SHIFT + BITS >= 32 ? 0u : ~0u << (SHIFT + BITS);
}

// Appends v(j) for each of this thread's entries j whose bit is set in sel
// to the list of length *len in shared memory: one atomic a warp. The
// order of the entries depends on the warps' timing; no result depends on
// it. Every lane of the warp calls this.
template <typename Val>
__device__ __forceinline__ void append(uint32_t* list, int* len, uint32_t sel, Val v) {
  const int lane = threadIdx.x % 32, n = __popc(sel);
  int incl = n;  // inclusive scan of the counts over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += t;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(len, incl);
  base = __shfl_sync(FULL_MASK, base, 31) + incl - n;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (sel >> j & 1u) list[base++] = v(j);
  }
}

// The end of one pass of a radix select, once the caller has added the
// weight of each entry whose key matches `prefix` above bit SHIFT + BITS to
// the bin of its digit, bits [SHIFT, SHIFT + BITS): the digit where the
// weight, counted from the highest key down, reaches `need`. Adds it to
// prefix and leaves in need what remains of the weight inside it. With frac
// >= 0 (first pass only) need is ceil(frac * total) instead. Returns false,
// the same in every thread, when the total is below need. The bins are zero
// again on return.
template <int SHIFT, int BITS, typename Hist>
__device__ __forceinline__ bool find_digit(uint32_t& prefix, typename Hist::W& need, float frac,
                                           const Hist& hist, Found<typename Hist::W>* fd) {
  typedef typename Hist::W W;
  constexpr int NB = 1 << BITS, PT = NB / THREADS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  __syncthreads();  // the histogram is whole
  // this thread's bins [base, base + PT), the highest at thread 0; read, then zeroed
  const int base = NB - PT * (tid + 1);
  W b[PT], s = 0;
#pragma unroll
  for (int q = 0; q < PT / 4; ++q) {
    W v[4];
    hist.take4(base + 4 * q, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[4 * q + i] = v[i];
      s += v[i];
    }
  }
  W incl = s;  // inclusive scan in thread order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const W n = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) fd->wsum[warp] = incl;
  __syncthreads();
  W above = incl - s, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const W v = fd->wsum[w];
    above += w < warp ? v : 0;
    total += v;
  }
  if (frac >= 0.f) need = (W)ceil((double)frac * (double)total);
  if (need > total) return false;
  if (above < need && need <= above + s) {  // the crossing lies in this thread's bins
    W cum = above;
    bool done = false;
#pragma unroll
    for (int i = PT - 1; i >= 0; --i) {
      if (!done) {
        if (cum + b[i] >= need) {
          done = true;
          fd->digit = (uint32_t)(base + i);
          fd->need = need - cum;
        } else {
          cum += b[i];
        }
      }
    }
  }
  __syncthreads();
  prefix |= fd->digit << SHIFT;
  need = fd->need;
  return true;
}

// One pass of a radix select over the keys list[0, n): the histogram of the
// entries that match prefix, weighted by weight(key), then find_digit.
template <int SHIFT, int BITS, typename Hist, typename Weight>
__device__ __forceinline__ bool list_pass(const uint32_t* list, int n, Weight weight,
                                          uint32_t& prefix, typename Hist::W& need, float frac,
                                          const Hist& hist, Found<typename Hist::W>* fd) {
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const uint32_t k = list[i];
    if ((k & known<SHIFT, BITS>()) == prefix) {
      const typename Hist::W w = weight(k);
      if (w != 0) hist.add((k >> SHIFT) & ((1u << BITS) - 1), w);
    }
  }
  return find_digit<SHIFT, BITS>(prefix, need, frac, hist, fd);
}

// The first pass's digit: BINS bins of equal width over [base, m + 1), for
// values >= base. A larger value never takes a lower bin, so the bins
// order the entries as their keys do, and the crossing bin of the values
// holds few entries where 11 bits of the key would hold a whole octave's.
struct Linear {
  float base, scale;
  __device__ __forceinline__ int operator()(float x) const {
    return min(BINS - 1, (int)((x - base) * scale));
  }
};

// The key among the n entries list[0, n) (weights weight(key)) at which the
// weight counted from the highest key down reaches need (1 <= need <= their
// total): for n <= 32 the first warp ranks them, lane i summing the weight
// above entry i's key and at it; else three radix passes over their keys.
template <typename Hist, typename Weight>
__device__ __forceinline__ uint32_t finish(const uint32_t* list, int n, typename Hist::W need,
                                           Weight weight, const Hist& hist,
                                           Found<typename Hist::W>* fd, uint32_t* found) {
  typedef typename Hist::W W;
  if (n <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const uint32_t k = lane < n ? list[lane] : 0u;
      const W w = lane < n ? weight(k) : (W)0;
      W gt = 0, ge = 0;
      for (int j = 0; j < n; ++j) {
        const uint32_t kj = __shfl_sync(FULL_MASK, k, j);
        const W wj = __shfl_sync(FULL_MASK, w, j);
        gt += kj > k ? wj : (W)0;
        ge += kj >= k ? wj : (W)0;
      }
      if (lane < n && gt < need && need <= ge) *found = k;  // the entries of one key
    }
    __syncthreads();
    return *found;
  }
  uint32_t prefix = 0;
  list_pass<21, 11>(list, n, weight, prefix, need, -1.f, hist, fd);
  list_pass<10, 11>(list, n, weight, prefix, need, -1.f, hist, fd);
  list_pass<0, 10>(list, n, weight, prefix, need, -1.f, hist, fd);
  return prefix;
}

// the 26 bisection steps from [m - 80, m + 1] against a threshold: `above`
// says whether the step's test holds at mid
template <typename Test>
__device__ __forceinline__ float replay(float m, Test above) {
  float lo = m - TAIL_NATS, hi = m + 1.0f;
#pragma unroll 1
  for (int it = 0; it < N_ITER; ++it) {
    const float mid = 0.5f * (lo + hi);
    if (above(mid)) lo = mid; else hi = mid;
  }
  return lo;
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
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sample_bisect_kernel(const float* __restrict__ logits, const float* __restrict__ noise,
                     long long* __restrict__ out, int V, int top_k, float top_p,
                     uint32_t s0, uint32_t s1) {
  __shared__ __align__(16) uint32_t bins[2 * BINS];  // two arrays (counts use the first)
  // the entries of a select (keys), then the kept columns; appended by
  // atomics in any order, since a histogram's integer sums and the draw's
  // argmax (ties to the smallest column) do not depend on it
  __shared__ uint32_t list[THREADS * PER];
  __shared__ int n_list[3];  // its length: top-k's bin, top-p's bin, the draw
  __shared__ uint32_t found[2];
  __shared__ Found<uint32_t> fk;
  __shared__ Found<u64> fp;
  __shared__ float red[WARPS];
  __shared__ float best_v[WARPS];
  __shared__ int best_i[WARPS];
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* lr = logits + (long long)row * V;

  // the row as keys, 16 a thread, columns j * THREADS + tid
  uint32_t key[PER];
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = j * THREADS + tid;
    float v = c < V ? lr[c] : -CUDART_INF_F;  // padding is never kept
    v = v == v ? v : -CUDART_INF_F;           // nor is NaN
    m = fmaxf(m, v);
    key[j] = key_of(v);
  }
#pragma unroll
  for (int i = 0; i < 2 * BINS / THREADS / 4; ++i) {
    reinterpret_cast<uint4*>(bins)[tid + i * THREADS] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < 3) n_list[tid] = 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();  // also orders the zeroed bins and lengths before their use
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = fmaxf(m, red[w]);
  const float lo0 = m - TAIL_NATS;

  // top-k: v_k, the k-th largest of the entries >= m - 80 (-inf when fewer
  // than k: then every test fails, as count(l >= mid) < k does). A pass of
  // linear bins over the registers, then the list of the entries in the
  // crossing bin.
  float thr_k = lo0;
  if (top_k > 0 && top_k < V) {
    const CountHist hist{bins};
    const Linear lin{lo0, BINS / (m + 1.0f - lo0)};
    uint32_t bin = 0, need = (uint32_t)top_k;
    float vk = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float v = value_of(key[j]);
      if (v >= lo0) hist.add(lin(v), 1u);
    }
    if (find_digit<0, 11>(bin, need, -1.f, hist, &fk)) {
      uint32_t sel = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float v = value_of(key[j]);
        sel |= (v >= lo0 && lin(v) == (int)bin ? 1u : 0u) << j;
      }
      append(list, &n_list[0], sel, [&](int j) { return key[j]; });
      __syncthreads();
      vk = value_of(finish(list, n_list[0], need, [](uint32_t) { return 1u; }, hist, &fk,
                           &found[0]));
    }
    thr_k = replay(m, [&](float mid) { return vk >= mid; });
  }

  // top-p: y*, the largest entry kept by top-k whose mass at or above it
  // reaches ceil(top_p Z) (-inf when none does: every test fails); a pass
  // of linear bins over [thr_k, m + 1), then the crossing bin's list
  float thr_p = -CUDART_INF_F;
  if (top_p > 0.f) {
    const MassHist hist{bins, bins + BINS};
    const Linear lin{thr_k, BINS / (m + 1.0f - thr_k)};
    const auto mass = [m](uint32_t k) {
      return (u64)__float2ull_rz(expf(value_of(k) - m) * 549755813888.0f);
    };
    uint32_t bin = 0;
    u64 need = 0;
    float ys = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float v = value_of(key[j]);
      const u64 w = mass(key[j]);  // for every entry: no branch around the exp
      if (v >= thr_k && w != 0) hist.add(lin(v), w);
    }
    if (find_digit<0, 11>(bin, need, top_p, hist, &fp)) {
      uint32_t sel = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float v = value_of(key[j]);
        sel |= (v >= thr_k && lin(v) == (int)bin ? 1u : 0u) << j;
      }
      append(list, &n_list[1], sel, [&](int j) { return key[j]; });
      __syncthreads();
      ys = value_of(finish(list, n_list[1], need, mass, hist, &fp, &found[1]));
    }
    thr_p = replay(m, [&](float mid) { return mid < ys; });
  }

  // the kept columns into the list (its last readers are behind a barrier)
  uint32_t sel = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float v = value_of(key[j]);
    sel |= (v >= thr_k && v > thr_p ? 1u : 0u) << j;
  }
  append(list, &n_list[2], sel, [&](int j) { return (uint32_t)(j * THREADS + tid); });
  __syncthreads();
  const int n_kept = n_list[2];

  // gumbel-max over the kept list, ties to the smallest column
  float bv = -CUDART_INF_F;
  int bi = 0x7fffffff;
  for (int i = tid; i < n_kept; i += THREADS) {
    const int c = (int)list[i];
    float g;
    if constexpr (PRNG) {
      const uint32_t bits = philox_x0((uint32_t)c, (uint32_t)row, s0, s1);
      const float u = ((float)(bits >> 9) + 0.5f) * (1.0f / 8388608.0f);
      g = -logf(-logf(u));
    } else {
      g = noise[(long long)row * V + c];
    }
    const float z = lr[c] + g;
    if (z > bv || (z == bv && c < bi)) { bv = z; bi = c; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, bv, o);
    const int oi = __shfl_xor_sync(FULL_MASK, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  if (lane == 0) { best_v[warp] = bv; best_i[warp] = bi; }
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

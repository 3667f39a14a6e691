// Sparse MCL column step, for NVIDIA Hopper (sm_90a).
//
// Replaces the jitted XLA column pass of haphic_tpu/cluster/sparse_mcl.py:
// _sweep_cols (:164), which vmaps _expand_col (:103), _dedupe_sorted (:62)
// and _inflate_cap_prune (:77) over the columns; the same routine serves
// _pre_expand (:380) and _first_iteration (:149). For every (b, column c)
// it computes the column's next iterate from its candidates:
//
//   1. candidates: with expand = 1 the Kc * KA products
//      (A_i[b, ci[s], t], A_v[b, ci[s], t] * cv[s]) in (s, t) order; with
//      expand = 0 the column's own Kc entries (ci[s], cv[s]);
//   2. ordered by (row id, candidate position): a stable sort by id, the
//      order in which lax.sort(num_keys=1) leaves them;
//   3. each run of equal ids summed in that order in f64 and rounded to
//      f32 once; the sentinel id n dropped;
//   4. inflated, p = exp(infl * log(v)) for v > 0, and normalized by the
//      column's sum, reduced in a fixed order;
//   5. capped to the K_out largest p, the lower id first among equal
//      values (lax.top_k's lower position first: after the dedupe,
//      positions follow ids);
//   6. pruned: p >= pruning, or p equal to the column max when that is
//      > 0, kept; renormalized;
//   7. written in ascending id, padded with (n, 0).
//
// The convergence statistic (_col_allclose_stat) stays in torch.
//
// What bounds it on the card: the function needs each input read once
// and each output written once (2 * B * N * K * 8 bytes for a whole
// sweep step) and one multiply a candidate, so its least time is set by
// the bytes, 197 MB at 3.35 TB/s = 0.06 ms at B = 4, N = 24,001, K = 128.
// What this first design spends instead is shared-memory traffic: one
// CTA of up to 1024 threads a column, the column's candidates in shared
// memory as 64-bit keys (id << 32 | position) beside their f32 values
// (192 KB at Kc * KA = 16,384, so one CTA an SM), a bitonic sort of the
// keys (105 passes of 8,192 compare-exchanges at 16,384), a run-sum pass,
// an in-place compaction of the runs, and a second bitonic sort over the
// distinct ids only, by (~bits(p), id), where the column has more than
// K_out of them. Past 16,384 candidates (K > 128) the same code runs on
// the CTA's slice of a global workspace the wrapper allocates.
//
// Each column depends on its own inputs only (no atomics, no reduction
// across CTAs), and the thread count depends only on the launch's
// shapes, so a column's bits do not depend on the chunk or the column
// block it is launched in.

#include <cuda_runtime.h>
#include <stdint.h>

#define SC_MAX_THREADS 1024
#define SC_SMEM_CANDIDATES 16384  // candidates kept in shared memory

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t key_id(u64 k) {
  return (uint32_t)(k >> 32);
}

// Block-wide reductions in a fixed order: a shuffle tree in each warp,
// then one over the warp totals. ``red`` holds 33 entries; every thread
// gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, T zero, Op op) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    T t = lane < nw ? red[lane] : zero;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      t = op(t, __shfl_down_sync(0xffffffffu, t, o));
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const T r = red[32];
  __syncthreads();
  return r;
}

struct AddD {
  __device__ double operator()(double a, double b) const { return a + b; }
};
struct AddI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Exclusive prefix of ``flag`` over the block, in thread order; the
// block's total in *total.
__device__ int block_scan(int flag, int* red, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  const int pre = __popc(m & ((1u << lane) - 1u));
  if (lane == 0) red[w] = __popc(m);
  __syncthreads();
  if (w == 0) {
    const int t = lane < nw ? red[lane] : 0;
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    red[lane] = incl - t;
    if (lane == 31) red[32] = incl;
  }
  __syncthreads();
  const int r = red[w] + pre;
  *total = red[32];
  __syncthreads();
  return r;
}

// Ascending bitonic sort of keys[0, P2), P2 a power of two.
__device__ void bitonic_sort(u64* keys, int P2) {
  const int half = P2 >> 1;
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo | j;
        const u64 a = keys[lo], b = keys[hi];
        const bool up = (lo & k) == 0;
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// One CTA per (column c = blockIdx.x, b = blockIdx.y). keys/vals are the
// CTA's P2 candidates: dynamic shared memory, or with GLOBAL its slice of
// the workspace.
template <bool GLOBAL>
__global__ void __launch_bounds__(SC_MAX_THREADS, 1) sparse_column_kernel(
    const int32_t* __restrict__ A_i, const float* __restrict__ A_v,
    const int32_t* __restrict__ ci, const float* __restrict__ cv,
    int64_t c_sb, const float* __restrict__ infl, int N, int KA, int C,
    int Kc, int n, int K_out, float pruning, int expand, int L, int P2,
    u64* __restrict__ ws_keys, float* __restrict__ ws_vals,
    int32_t* __restrict__ out_i, float* __restrict__ out_v) {
  __shared__ double red_d[33];
  __shared__ float red_f[33];
  __shared__ int red_i[33];
  extern __shared__ __align__(16) u64 dyn[];
  const int c = blockIdx.x, b = blockIdx.y;
  const int T = blockDim.x, tid = threadIdx.x;
  u64* keys;
  float* vals;
  if (GLOBAL) {
    const size_t slot = ((size_t)b * C + c) * (size_t)P2;
    keys = ws_keys + slot;
    vals = ws_vals + slot;
  } else {
    keys = dyn;
    vals = reinterpret_cast<float*>(dyn + P2);
  }
  const int32_t* cI = ci + (int64_t)b * c_sb + (int64_t)c * Kc;
  const float* cV = cv + (int64_t)b * c_sb + (int64_t)c * Kc;
  const float f = infl[b];
  const uint32_t un = (uint32_t)n;

  // 1. candidates: key (id << 32 | position), value at its position;
  // the padding keys (all ones) sort last
  for (int t = tid; t < P2; t += T) {
    u64 key = ~0ull;
    if (t < L) {
      int32_t id;
      float v;
      if (expand) {
        const int s = t / KA, u = t - s * KA;
        const int64_t at = ((int64_t)b * N + cI[s]) * KA + u;
        id = A_i[at];
        v = A_v[at] * cV[s];
      } else {
        id = cI[t];
        v = cV[t];
      }
      key = ((u64)(uint32_t)id << 32) | (uint32_t)t;
      vals[t] = v;
    }
    keys[t] = key;
  }
  __syncthreads();

  // 2. stable order by id
  bitonic_sort(keys, P2);

  // 3. the first member of each run of a real id sums the run in f64, in
  // position order, and stores the sum, rounded once, at its position
  for (int i = tid; i < L; i += T) {
    const u64 k = keys[i];
    const uint32_t id = key_id(k);
    if (id >= un || (i > 0 && key_id(keys[i - 1]) == id)) continue;
    double s = 0.0;
    for (int j = i; j < L && key_id(keys[j]) == id; ++j)
      s += (double)vals[(uint32_t)keys[j]];
    vals[(uint32_t)k] = (float)s;
  }
  __syncthreads();
  // the other members are marked (the values are >= 0)
  for (int i = tid; i < L; i += T) {
    const u64 k = keys[i];
    const uint32_t id = key_id(k);
    if (id < un && i > 0 && key_id(keys[i - 1]) == id)
      vals[(uint32_t)k] = -1.0f;
  }
  __syncthreads();

  // 4. compact the runs to the front of keys, in id order, as
  // (id << 32 | bits(sum)): round by round, every read of a round before
  // its writes, and a write never lands past the round's own elements
  int M = 0;
  for (int r0 = 0; r0 < L; r0 += T) {
    const int i = r0 + tid;
    int flag = 0;
    u64 ent = 0;
    if (i < L) {
      const u64 k = keys[i];
      const uint32_t id = key_id(k);
      if (id < un) {
        const float s = vals[(uint32_t)k];
        if (s >= 0.0f) {
          flag = 1;
          ent = ((u64)id << 32) | __float_as_uint(s);
        }
      }
    }
    int total;
    const int at = M + block_scan(flag, red_i, &total);
    if (flag) keys[at] = ent;
    M += total;
    __syncthreads();
  }

  // 5. inflate; the column's sum
  double part = 0.0;
  for (int m = tid; m < M; m += T) {
    const float v = __uint_as_float((uint32_t)keys[m]);
    const float p = v > 0.0f ? expf(f * logf(v)) : 0.0f;
    vals[m] = p;
    part += (double)p;
  }
  const float tot = (float)block_reduce(part, red_d, 0.0, AddD());
  const float inv = tot > 0.0f ? 1.0f / tot : 0.0f;

  // 6. normalize, as (~bits(p) << 32 | id): ascending is p descending,
  // then id ascending; sorted only where the cap cuts
  const bool cap = M > K_out;
  const int M2 = cap ? next_pow2(M) : M;
  for (int m = tid; m < M2; m += T) {
    u64 e = ~0ull;
    if (m < M) {
      const float p = vals[m] * inv;
      e = ((u64)(~__float_as_uint(p)) << 32) | (u64)key_id(keys[m]);
    }
    keys[m] = e;
  }
  __syncthreads();
  if (cap) bitonic_sort(keys, M2);
  const int nsel = cap ? K_out : M;

  // 7. prune against the column max, renormalize
  float mx = 0.0f;
  for (int j = tid; j < nsel; j += T)
    mx = fmaxf(mx, __uint_as_float(~key_id(keys[j])));
  mx = block_reduce(mx, red_f, 0.0f, MaxF());
  part = 0.0;
  for (int j = tid; j < nsel; j += T) {
    const float p = __uint_as_float(~key_id(keys[j]));
    const bool keep = p >= pruning || (p == mx && p > 0.0f);
    const float q = keep ? p : 0.0f;
    vals[j] = q;
    part += (double)q;
  }
  const float t2 = (float)block_reduce(part, red_d, 0.0, AddD());
  const float inv2 = t2 > 0.0f ? 1.0f / t2 : 0.0f;

  // 8. the kept entries in ascending id (slot = kept entries of lower
  // id), then the padding
  const int64_t base = ((int64_t)b * C + c) * K_out;
  int kept = 0;
  for (int j = tid; j < nsel; j += T) {
    const float q = vals[j] * inv2;
    if (q > 0.0f) {
      const uint32_t id = (uint32_t)keys[j];
      int slot = 0;
      for (int u = 0; u < nsel; ++u)
        slot += (vals[u] * inv2 > 0.0f) && ((uint32_t)keys[u] < id);
      out_i[base + slot] = (int32_t)id;
      out_v[base + slot] = q;
      ++kept;
    }
  }
  kept = block_reduce(kept, red_i, 0, AddI());
  for (int s = kept + tid; s < K_out; s += T) {
    out_i[base + s] = n;
    out_v[base + s] = 0.0f;
  }
}

// Launches the column step of ``C`` columns of each of ``B`` matrices on
// ``stream``. A_i/A_v: (B, N, KA) contiguous (unused with expand = 0);
// ci/cv: (B, C, Kc) with batch stride c_sb elements, rows contiguous;
// infl: (B,); out_i/out_v: (B, C, K_out) contiguous; ws_keys/ws_vals: a
// workspace of B * C * P2 entries each, P2 the power of two at or over
// the candidate count, needed past SC_SMEM_CANDIDATES. Returns the CUDA
// error code (0 on success).
extern "C" int sparse_column_launch(
    const void* A_i, const void* A_v, const void* ci, const void* cv,
    int64_t c_sb, const void* infl, int B, int N, int KA, int C, int Kc,
    int n, int K_out, float pruning, int expand, void* ws_keys,
    void* ws_vals, void* out_i, void* out_v, void* stream) {
  const int64_t L64 = expand ? (int64_t)Kc * KA : (int64_t)Kc;
  if (B < 1 || B > 65535 || C < 1 || Kc < 1 || K_out < 1 || n < 0 ||
      L64 > (1 << 30) || L64 < K_out || (expand && (KA < 1 || N <= n)))
    return (int)cudaErrorInvalidValue;
  const int L = (int)L64;
  const int P2 = next_pow2(L);
  int threads = P2 / 2;
  if (threads < 32) threads = 32;
  if (threads > SC_MAX_THREADS) threads = SC_MAX_THREADS;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)C, (unsigned)B);
  cudaError_t e;
  if (P2 <= SC_SMEM_CANDIDATES) {
    const size_t smem = (size_t)P2 * (sizeof(u64) + sizeof(float));
    e = cudaFuncSetAttribute(sparse_column_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    sparse_column_kernel<false><<<grid, threads, smem, st>>>(
        static_cast<const int32_t*>(A_i), static_cast<const float*>(A_v),
        static_cast<const int32_t*>(ci), static_cast<const float*>(cv), c_sb,
        static_cast<const float*>(infl), N, KA, C, Kc, n, K_out, pruning,
        expand, L, P2, nullptr, nullptr, static_cast<int32_t*>(out_i),
        static_cast<float*>(out_v));
  } else {
    if (ws_keys == nullptr || ws_vals == nullptr)
      return (int)cudaErrorInvalidValue;
    sparse_column_kernel<true><<<grid, threads, 0, st>>>(
        static_cast<const int32_t*>(A_i), static_cast<const float*>(A_v),
        static_cast<const int32_t*>(ci), static_cast<const float*>(cv), c_sb,
        static_cast<const float*>(infl), N, KA, C, Kc, n, K_out, pruning,
        expand, L, P2, static_cast<u64*>(ws_keys),
        static_cast<float*>(ws_vals), static_cast<int32_t*>(out_i),
        static_cast<float*>(out_v));
  }
  return (int)cudaGetLastError();
}

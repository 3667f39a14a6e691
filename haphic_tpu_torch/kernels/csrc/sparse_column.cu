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
//   2. each row id's candidates summed in f64 in that order and rounded
//      to f32 once (lax.sort(num_keys=1) is stable, so JAX's run sums add
//      in position order too); the sentinel id n dropped;
//   3. inflated, p = exp(infl * log(v)) for v > 0, and normalized by the
//      column's sum;
//   4. capped to the K_out largest p, the lower id first among equal
//      values (lax.top_k's lower position first: after the dedupe,
//      positions follow ids);
//   5. pruned: p >= pruning, or p equal to the column max when that is
//      > 0, kept; renormalized;
//   6. written in ascending id, padded with (n, 0).
//
// The convergence statistic (_col_allclose_stat) is a kernel of its own,
// csrc/col_allclose.cu.
//
// The kernel relies on the ELL layout every call site passes (the wrapper
// checks it): each column of ci, and with expand each column of A_i,
// holds ascending distinct real ids (< n), then only sentinels n.
//
// What bounds it on the card: the function needs each input read once
// and each output written once (2 * B * N * K * 8 bytes for a whole
// sweep step) and one multiply a candidate, so its least time is set by
// the bytes, 197 MB at 3.35 TB/s = 0.0587 ms at B = 4, N = 24,001,
// K = 128.
//
// The first design (one CTA of 1024 threads a column, all 16,384
// candidates in 192 KB of shared memory as 64-bit keys, a 105-pass
// bitonic sort) spent 72% of its cycles in that sort, at one CTA an SM
// (timed by its -DSC_PHASE_CLOCKS build). At the sparse smoke run's step
// a column has 4,286 real candidates (p50; 12,886 at most) but also 3,150
// distinct ids (p50; 7,327 p99, 8,436 at most), and every column is
// capped. So this design sorts neither:
//
//   - the dedupe is a shared-memory hash table of 8,192 slots (an f64 sum
//     and a key each, 96 KB: two CTAs an SM), probed four slots at a time
//     with one 16-byte load. A CTA of 4 * next_pow2(KA) threads (512 at
//     K = 128) walks the column's real sources in order, four at a time,
//     a thread an entry, its loads issued SC_PREFETCH steps ahead: the
//     four sources' ids claim their slots at once (atomicCAS), then
//     their values are added source by source, a barrier apart. So every
//     slot adds in source order, the first design's order, with no
//     atomics on values;
//   - the column's sum is a 64-bit fixed-point sum scaled to its largest
//     value, the same in any order, so the distinct ids need no order;
//   - the cap is a radix select of the K_out-th smallest key
//     (~bits(q) << 32 | id) over them, eight 8-bit digits (the last four
//     skipped when every entry tied at the cut is kept);
//   - only the <= K_out kept entries are sorted by id (bitonic), summed in
//     that order for the renormalization, and written by a block scan.
//
// A column whose distinct ids would pass 3/4 of the shared table
// continues in its CTA's slice of a global workspace (a table of
// next_pow2(2 * min(candidates, n)) slots) from the step at which that
// could happen; the ids already in shared memory stay there. The switch
// depends only on the column's data and the launch's shapes, and the
// arithmetic is the same either way. The CTAs are persistent (the
// occupancy times the SMs), so the workspace is one slice a CTA,
// whatever the column count. This path also serves every K: past K = 128
// (16,384 candidates) it replaces the first design's global workspace.
//
// Each column depends on its own inputs only (no reduction across CTAs;
// the atomics only claim slots and count), and the thread count depends
// only on the launch's shapes, so a column's bits do not depend on the
// chunk, the column block or the CTA it is computed in.

#include <cuda_runtime.h>
#include <stdint.h>

#define SC_MAX_THREADS 512
#define SC_TABLE_SLOTS 8192    // the shared-memory table's most slots
#define SC_PREFETCH 4          // sub-steps whose loads are in flight
#define SC_COMPACT 8           // table slots a thread a compaction round
#define SC_EMPTY 0xffffffffu
#define SC_HI 0xffffffff00000000ull

typedef unsigned long long u64;

// The timing build (-DSC_PHASE_CLOCKS, `python -m
// haphic_tpu_torch.kernels.sparse_column --phases`): thread 0 of every CTA
// adds the clock64() cycles of each phase of each column, after a barrier
// that ends it, to sc_phase_cycles; the main path never loads that build.
#define SC_NPHASE 8
#ifdef SC_PHASE_CLOCKS
__device__ u64 sc_phase_cycles[SC_NPHASE + 1];  // the last: columns
#define SC_PHASE_BEGIN long long sc_t0 = clock64();
#define SC_PHASE(k)                                                      \
  do {                                                                   \
    __syncthreads();                                                     \
    if (threadIdx.x == 0) {                                              \
      const long long sc_t = clock64();                                  \
      atomicAdd(&sc_phase_cycles[k], (u64)(sc_t - sc_t0));               \
      if ((k) == SC_NPHASE - 1)                                          \
        atomicAdd(&sc_phase_cycles[SC_NPHASE], 1ull);                    \
      sc_t0 = sc_t;                                                      \
    }                                                                    \
  } while (0)
static const char sc_phase_names[] =
    "stage,accumulate,compaction,inflate_sum,cap_select,gather,"
    "sort_kept,write";
// Copies the phase cycles (SC_NPHASE + 1 counters) to ``host`` and zeroes
// them; returns the CUDA error code.
extern "C" int sparse_column_phase_cycles(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, sc_phase_cycles,
                                       sizeof(sc_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  static const u64 zero[SC_NPHASE + 1] = {0};
  return (int)cudaMemcpyToSymbol(sc_phase_cycles, zero, sizeof(zero));
}
extern "C" const char* sparse_column_phase_names(void) {
  return sc_phase_names;
}
#else
#define SC_PHASE_BEGIN
#define SC_PHASE(k)
#endif

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
struct AddU {
  __device__ u64 operator()(u64 a, u64 b) const { return a + b; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Exclusive prefix sum of ``v`` over the block, in thread order; the
// block's total in *total.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) red[w] = incl;
  __syncthreads();
  if (w == 0) {
    const int t = lane < nw ? red[lane] : 0;
    int winc = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += y;
    }
    red[lane] = winc - t;
    if (lane == 31) red[32] = winc;
  }
  __syncthreads();
  const int r = red[w] + incl - v;
  *total = red[32];
  __syncthreads();
  return r;
}

// hist[d] += 1 for the lanes of a warp with d < 256, one atomic a digit
// (the radix select's counts crowd into a few digits). Every lane calls.
__device__ __forceinline__ void count_digit(int* hist, int d) {
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  if (d < 256 && __ffs(peers) - 1 == (int)(threadIdx.x & 31))
    atomicAdd(&hist[d], __popc(peers));
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

__host__ __device__ inline int log2_ceil(int x) {
  int b = 0;
  while ((1 << b) < x) ++b;
  return b;
}

// Open addressing over 2^bits slots, linear probing over buckets of four
// slots (Fibonacci hashing), each bucket read with one 16-byte load: a
// warp waits for its longest probe. The slot of ``id``, claimed with
// atomicCAS where it is absent, and then *added = 1. A claim lost to
// another thread's id moves on; one lost to the same id (from another
// source of the same step) finds it. Slots are never freed and the CAS is
// the authority, so a stale read costs a failed CAS, and no id is claimed
// twice.
__device__ int find_or_insert(uint32_t* keys, int bits, uint32_t id,
                              int* added) {
  const uint32_t mask = (1u << (bits - 2)) - 1u;
  uint32_t q = (id * 0x9E3779B1u) >> (34 - bits);
  for (;;) {
    const uint4 k4 = reinterpret_cast<const uint4*>(keys)[q];
    const uint32_t ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t k = ks[j];
      if (k == SC_EMPTY) k = atomicCAS(&keys[4 * q + j], SC_EMPTY, id);
      if (k == SC_EMPTY) {
        *added = 1;
        return (int)(4 * q + j);
      }
      if (k == id) return (int)(4 * q + j);
    }
    q = (q + 1) & mask;
  }
}

// The slot of ``id``, or -1 where it is absent (no claim; for a table no
// thread claims in at the time).
__device__ int find(const uint32_t* keys, int bits, uint32_t id) {
  const uint32_t mask = (1u << (bits - 2)) - 1u;
  uint32_t q = (id * 0x9E3779B1u) >> (34 - bits);
  for (;;) {
    const uint4 k4 = reinterpret_cast<const uint4*>(keys)[q];
    const uint32_t ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ks[j] == id) return (int)(4 * q + j);
      if (ks[j] == SC_EMPTY) return -1;
    }
    q = (q + 1) & mask;
  }
}

// The occupied slots of a table of H slots appended to S from at0 as
// (id << 32 | bits(f32(sum))), in no set order; returns the new count,
// after a barrier, and raises *vmax (this thread's) to their values. A
// round is SC_COMPACT slots a thread, T apart. S may be the table's own
// acc: every read of a round comes before its writes (the scan's
// barriers), and a round writes only below its own end.
__device__ int compact(const uint32_t* keys, const double* acc, int H,
                       u64* S, int at0, int* red, float* vmax) {
  const int T = blockDim.x;
  int M = at0;
  for (int r0 = 0; r0 < H; r0 += T * SC_COMPACT) {
    u64 e[SC_COMPACT];
    unsigned held = 0;
#pragma unroll
    for (int k = 0; k < SC_COMPACT; ++k) {
      const int h = r0 + k * T + threadIdx.x;
      if (h < H && keys[h] != SC_EMPTY) {
        const float v = (float)acc[h];
        e[k] = ((u64)keys[h] << 32) | __float_as_uint(v);
        held |= 1u << k;
        *vmax = fmaxf(*vmax, v);
      }
    }
    int total;
    int at = M + block_scan(__popc(held), red, &total);
#pragma unroll
    for (int k = 0; k < SC_COMPACT; ++k)
      if (held >> k & 1u) S[at++] = e[k];
    M += total;
  }
  __syncthreads();
  return M;
}

// One CTA walks the columns w = blockIdx.x, + gridDim.x, ... of the B * C
// (b, c) pairs. Dynamic shared memory: the table's f64 sums and keys
// (2^hbits slots; the sums hold the column's entries afterwards), the
// kept entries (next_pow2(K_out)), then with expand the staged sources.
// ws (with expand): the CTA's slice of the global workspace, a table of
// 2^gbits slots (sums, then keys).
__global__ void __launch_bounds__(SC_MAX_THREADS, 2) sparse_column_kernel(
    const int32_t* __restrict__ A_i, const float* __restrict__ A_v,
    const int32_t* __restrict__ ci, const float* __restrict__ cv,
    int64_t c_sb, const float* __restrict__ infl, int B, int N, int KA,
    int C, int Kc, int n, int K_out, float pruning, int expand, int hbits,
    int gbits, unsigned char* __restrict__ ws, int64_t ws_slice,
    int32_t* __restrict__ out_i, float* __restrict__ out_v) {
  __shared__ double red_d[33];
  __shared__ float red_f[33];
  __shared__ int red_i[33];
  __shared__ u64 red_u[33];
  __shared__ int hist[256];
  __shared__ int digit[3];
  __shared__ int nkept;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int H_s = 1 << hbits, H_g = 1 << gbits;
  const int P2K = next_pow2(K_out);
  double* acc_s = reinterpret_cast<double*>(dyn);
  uint32_t* keys_s = reinterpret_cast<uint32_t*>(acc_s + H_s);
  u64* kept = reinterpret_cast<u64*>(keys_s + H_s);
  int32_t* srcI = reinterpret_cast<int32_t*>(kept + P2K);
  float* srcV = reinterpret_cast<float*>(srcI + Kc);
  double* acc_g = reinterpret_cast<double*>(ws + blockIdx.x * ws_slice);
  uint32_t* keys_g = reinterpret_cast<uint32_t*>(acc_g + H_g);
  const uint32_t un = (uint32_t)n;
  // a sub-step: G sources of the column side by side, W threads each
  // (entry u of source g: thread g * W + u % W, sub-step u / W). It adds
  // at most T ids, and a column has at most dmax, so the shared-memory
  // table (3/4 of its slots at most) switches to the global one before a
  // sub-step could pass that
  const int W = expand ? (next_pow2(KA) < T ? next_pow2(KA) : T) : 1;
  const int G = T / W, g_me = tid / W, u_me = tid - g_me * W;
  const int nsub = expand ? (KA + W - 1) / W : 0;
  const int cap_s = H_s - H_s / 4;
  const int64_t L = (int64_t)Kc * KA;
  const int dmax = (int)(L < n ? L : n);

  for (int64_t w = blockIdx.x; w < (int64_t)B * C; w += gridDim.x) {
    SC_PHASE_BEGIN
    const int b = (int)(w / C), c = (int)(w - (int64_t)b * C);
    const int32_t* cI = ci + (int64_t)b * c_sb + (int64_t)c * Kc;
    const float* cV = cv + (int64_t)b * c_sb + (int64_t)c * Kc;
    const float f = infl[b];

    // 1. the real sources (ids < n, first in the column), staged; the
    // table emptied
    int cnt = 0;
    for (int s = tid; s < Kc; s += T) {
      const int32_t id = cI[s];
      cnt += (uint32_t)id < un;
      if (expand) {
        srcI[s] = id;
        srcV[s] = cV[s];
      }
    }
    if (expand)
      for (int h = tid; h < H_s; h += T) {
        keys_s[h] = SC_EMPTY;
        acc_s[h] = 0.0;
      }
    if (tid == 0) nkept = 0;
    const int nreal = block_reduce(cnt, red_i, 0, AddI());
    SC_PHASE(0);

    u64* S;  // the column's distinct ids, in no set order, as
             // (id << 32 | bits(value))
    int M;
    float vmax = 0.0f;  // their largest value
    if (expand) {
      // 2. the run sums. A sub-step claims the slots of its G sources'
      // ids at once, then adds the values source by source, a barrier
      // apart, so every slot adds in source order. Each thread's loads run
      // SC_PREFETCH sub-steps ahead, in registers as (bits(v) << 32 | id).
      const int groups = (nreal + G - 1) / G;
      const int iters = groups * nsub;
      const int64_t arow = (int64_t)b * N;
      int fq = 0, fsub = 0;  // the next sub-step to load: group, sub-step
      auto fetch = [&]() {
        u64 r = (u64)un;
        const int src = fq * G + g_me, u = fsub * W + u_me;
        if (fq < groups && src < nreal && u < KA) {
          const int64_t at = (arow + srcI[src]) * KA + u;
          r = ((u64)__float_as_uint(A_v[at]) << 32) | (uint32_t)A_i[at];
        }
        if (++fsub == nsub) {
          fsub = 0;
          ++fq;
        }
        return r;
      };
      u64 ring[SC_PREFETCH];
#pragma unroll
      for (int k = 0; k < SC_PREFETCH; ++k) ring[k] = fetch();
      bool spill = false;
      int occ = 0;  // ids in the shared-memory table
      int q = 0, sub = 0;  // this sub-step
      for (int it0 = 0; it0 < iters; it0 += SC_PREFETCH) {
#pragma unroll
        for (int k = 0; k < SC_PREFETCH; ++k) {
          if (it0 + k < iters) {
            const uint32_t id = (uint32_t)ring[k];
            const float a = __uint_as_float((uint32_t)(ring[k] >> 32));
            ring[k] = fetch();
            if (!spill && occ + min(T, dmax - occ) > cap_s) {
              spill = true;
              for (int h = tid; h < H_g; h += T) {
                keys_g[h] = SC_EMPTY;
                acc_g[h] = 0.0;
              }
              __syncthreads();
            }
            int added = 0, h = -1;
            double* acc = acc_s;
            if (id < un) {
              if (!spill) {
                h = find_or_insert(keys_s, hbits, id, &added);
              } else if ((h = find(keys_s, hbits, id)) < 0) {
                int claimed = 0;
                h = find_or_insert(keys_g, gbits, id, &claimed);
                acc = acc_g;
              }
            }
            occ += __syncthreads_count(added);
            const double v =
                h >= 0 ? (double)__fmul_rn(a, srcV[q * G + g_me]) : 0.0;
            for (int g = 0; g < G; ++g) {
              if (g) __syncthreads();
              if (g == g_me && h >= 0) acc[h] += v;
            }
            if (++sub == nsub) {
              sub = 0;
              ++q;
            }
          }
        }
      }
      __syncthreads();  // the last source's adds
      SC_PHASE(1);

      // 3. the distinct ids
      if (!spill) {
        S = reinterpret_cast<u64*>(acc_s);
        M = compact(keys_s, acc_s, H_s, S, 0, red_i, &vmax);
      } else {
        S = reinterpret_cast<u64*>(acc_g);
        M = compact(keys_g, acc_g, H_g, S, 0, red_i, &vmax);
        M = compact(keys_s, acc_s, H_s, S, M, red_i, &vmax);
      }
    } else {
      // the column itself: distinct already
      S = reinterpret_cast<u64*>(acc_s);
      M = nreal;
      for (int m = tid; m < M; m += T) {
        S[m] = ((u64)(uint32_t)cI[m] << 32) | __float_as_uint(cV[m]);
        vmax = fmaxf(vmax, cV[m]);
      }
      SC_PHASE(1);
    }
    vmax = block_reduce(vmax, red_f, 0.0f, MaxF());
    SC_PHASE(2);

    // 4. inflate; the column's sum, order-free: each p as floor(p * 2^sh)
    // in 64-bit fixed point, scaled so that M terms of up to twice the
    // largest p cannot overflow; integer sums do not depend on the order,
    // and the error is at most 2^(2 * bits(M) - 61) of the largest p. For
    // infl >= 0, p is monotone in v, so the largest p is p(vmax).
    const bool cap = M > K_out;
    float pbound = vmax > 0.0f ? expf(f * logf(vmax)) : 0.0f;
    if (f < 0.0f) {
      pbound = 0.0f;
      for (int m = tid; m < M; m += T) {
        const float v = __uint_as_float((uint32_t)S[m]);
        if (v > 0.0f) pbound = fmaxf(pbound, expf(f * logf(v)));
      }
      pbound = block_reduce(pbound, red_f, 0.0f, MaxF());
    }
    const int sh =
        pbound > 0.0f ? 61 - (32 - __clz(M)) - ilogbf(pbound) : 0;
    float pmax = 0.0f;
    u64 fixed = 0;
    for (int j = tid; j < 256; j += T) hist[j] = 0;
#pragma unroll 4
    for (int m = tid; m < M; m += T) {
      const u64 e = S[m];
      const float v = __uint_as_float((uint32_t)e);
      const float p = v > 0.0f ? expf(f * logf(v)) : 0.0f;
      S[m] = (e & SC_HI) | __float_as_uint(p);
      pmax = fmaxf(pmax, p);
      fixed += (u64)ldexp((double)p, sh);
    }
    pmax = block_reduce(pmax, red_f, 0.0f, MaxF());
    fixed = block_reduce(fixed, red_u, 0ull, AddU());
    const float tot = (float)ldexp((double)fixed, -sh);
    const float inv = tot > 0.0f ? 1.0f / tot : 0.0f;
    // normalize; with the cap, the radix select's first digits counted
    for (int r0 = 0; r0 < M; r0 += T) {
      const int m = r0 + tid;
      int d = 256;  // no count
      if (m < M) {
        const u64 e = S[m];
        const float q = __uint_as_float((uint32_t)e) * inv;
        S[m] = (e & SC_HI) | __float_as_uint(q);
        d = (int)(~__float_as_uint(q) >> 24);
      }
      if (cap) count_digit(hist, d);
    }
    // the largest q is the largest p times inv
    const float mx = pmax * inv;
    __syncthreads();
    SC_PHASE(3);

    // 5. the cap: kappa, the K_out-th smallest key (~bits(q) << 32 | id)
    // (bits(q) is monotone for q >= 0: q descending, then id ascending,
    // lax.top_k's order), by a radix select of eight 8-bit digits from
    // the top; the keys are distinct, so exactly K_out are <= kappa
    u64 kappa = ~0ull;
    if (cap) {
      u64 prefix = 0, pmask = 0;
      int need = K_out;
      for (int shift = 56; shift >= 0; shift -= 8) {
        if (shift < 56) {
          for (int j = tid; j < 256; j += T) hist[j] = 0;
          __syncthreads();
#pragma unroll 4
          for (int r0 = 0; r0 < M; r0 += T) {
            const int m = r0 + tid;
            int d = 256;
            if (m < M) {
              const u64 e = S[m];
              const u64 key = ((u64)(~(uint32_t)e) << 32) | (e >> 32);
              if ((key & pmask) == prefix) d = (int)(key >> shift) & 255;
            }
            count_digit(hist, d);
          }
          __syncthreads();
        }
        if (tid < 32) {
          // lane l: digits 8l to 8l + 7
          int cnt8[8], sum = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            cnt8[k] = hist[8 * tid + k];
            sum += cnt8[k];
          }
          int incl = sum;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (tid >= o) incl += y;
          }
          const int excl = incl - sum;
          if (excl < need && need <= incl) {
            int below = excl, at = -1;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              if (at < 0 && below + cnt8[k] >= need) at = k;
              if (at < 0) below += cnt8[k];
            }
            digit[0] = 8 * tid + at;
            digit[1] = need - below;
            digit[2] = cnt8[at];
          }
        }
        __syncthreads();
        prefix |= (u64)digit[0] << shift;
        pmask |= 255ull << shift;
        need = digit[1];
        const bool all_ties = shift == 32 && digit[2] == need;
        __syncthreads();
        if (all_ties) {
          // every entry whose q is the K_out-th largest's is kept
          prefix |= 0xffffffffull;
          break;
        }
      }
      kappa = prefix;
    }
    SC_PHASE(4);

    // 6. the kept entries (capped, then pruned against the column max),
    // gathered in no set order
#pragma unroll 4
    for (int m = tid; m < M; m += T) {
      const u64 e = S[m];
      const float q = __uint_as_float((uint32_t)e);
      const u64 key = ((u64)(~(uint32_t)e) << 32) | (e >> 32);
      if (key <= kappa && q > 0.0f &&
          (q >= pruning || q == mx))
        kept[atomicAdd(&nkept, 1)] = e;
    }
    __syncthreads();
    const int nk = nkept;
    SC_PHASE(5);

    // 7. sorted by id; renormalized in that order
    if (nk > 1) {
      const int P2 = next_pow2(nk);
      for (int m = nk + tid; m < P2; m += T) kept[m] = ~0ull;
      __syncthreads();
      bitonic_sort(kept, P2);
    }
    double part = 0.0;
    for (int m = tid; m < nk; m += T)
      part += (double)__uint_as_float((uint32_t)kept[m]);
    const float t2 = (float)block_reduce(part, red_d, 0.0, AddD());
    const float inv2 = t2 > 0.0f ? 1.0f / t2 : 0.0f;
    SC_PHASE(6);

    // 8. written in ascending id, then the padding
    const int64_t base = ((int64_t)b * C + c) * K_out;
    int slots = 0;
    for (int r0 = 0; r0 < nk; r0 += T) {
      const int m = r0 + tid;
      int flag = 0;
      uint32_t id = 0;
      float r = 0.0f;
      if (m < nk) {
        const u64 e = kept[m];
        id = (uint32_t)(e >> 32);
        r = __uint_as_float((uint32_t)e) * inv2;
        flag = r > 0.0f;
      }
      int total;
      const int at = slots + block_scan(flag, red_i, &total);
      if (flag) {
        out_i[base + at] = (int32_t)id;
        out_v[base + at] = r;
      }
      slots += total;
    }
    for (int s = slots + tid; s < K_out; s += T) {
      out_i[base + s] = n;
      out_v[base + s] = 0.0f;
    }
    SC_PHASE(7);
    __syncthreads();
  }
}

// A launch's plan, from its shapes alone.
struct Plan {
  int threads, hbits, gbits, ctas;
  size_t smem;    // dynamic shared memory a CTA
  int64_t slice;  // global workspace bytes a CTA
};

// Fills *p; returns the CUDA error code.
static int plan(int B, int N, int KA, int C, int Kc, int n, int K_out,
                int expand, Plan* p) {
  const int64_t L64 = expand ? (int64_t)Kc * KA : (int64_t)Kc;
  if (B < 1 || C < 1 || Kc < 1 || K_out < 1 || n < 0 || L64 > (1 << 30) ||
      L64 < K_out || (expand && (KA < 1 || N <= n)))
    return (int)cudaErrorInvalidValue;
  const int L = (int)L64;
  // with expand, four times the source width: the passes over a
  // column's distinct ids use them all, the sums one thread an entry of
  // four sources at once
  int threads = expand ? 4 * next_pow2(KA) : next_pow2(Kc);
  if (threads < 32) threads = 32;
  if (threads > SC_MAX_THREADS) threads = SC_MAX_THREADS;
  p->threads = threads;
  // a column has at most min(L, n) distinct ids; twice as many slots keep
  // its table at most half full. Without expand the table's sums hold the
  // column's Kc entries.
  const int distinct = L < n ? L : (n > 0 ? n : 1);
  const int want = expand ? 2 * distinct : Kc;
  if (!expand && Kc > SC_TABLE_SLOTS) return (int)cudaErrorInvalidValue;
  p->hbits = log2_ceil(want < 64 ? 64 : (want > SC_TABLE_SLOTS
                                              ? SC_TABLE_SLOTS : want));
  p->gbits = log2_ceil(want < 64 ? 64 : want);
  p->smem = ((size_t)1 << p->hbits) * (sizeof(double) + sizeof(uint32_t)) +
            (size_t)next_pow2(K_out) * sizeof(u64) +
            (expand ? (size_t)Kc * (sizeof(int32_t) + sizeof(float)) : 0);
  p->slice = expand ? ((int64_t)1 << p->gbits) *
                          (int64_t)(sizeof(double) + sizeof(uint32_t))
                    : 0;
  cudaError_t e = cudaFuncSetAttribute(
      sparse_column_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p->smem);
  if (e != cudaSuccess) return (int)e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sparse_column_kernel, threads, p->smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t cols = (int64_t)B * C, most = (int64_t)per_sm * sms;
  p->ctas = (int)(cols < most ? cols : most);
  return 0;
}

// The bytes of global workspace a launch of these shapes needs, or minus
// the CUDA error code.
extern "C" int64_t sparse_column_workspace(int B, int N, int KA, int C,
                                           int Kc, int n, int K_out,
                                           int expand) {
  Plan p;
  const int e = plan(B, N, KA, C, Kc, n, K_out, expand, &p);
  return e ? -(int64_t)e : p.slice * p.ctas;
}

// Launches the column step of ``C`` columns of each of ``B`` matrices on
// ``stream``. A_i/A_v: (B, N, KA) contiguous (unused with expand = 0);
// ci/cv: (B, C, Kc) with batch stride c_sb elements, rows contiguous;
// infl: (B,); out_i/out_v: (B, C, K_out) contiguous; ws: ws_bytes of
// device memory, at least sparse_column_workspace(...) of the same shapes
// (none without expand). Returns the CUDA error code (0 on success).
extern "C" int sparse_column_launch(
    const void* A_i, const void* A_v, const void* ci, const void* cv,
    int64_t c_sb, const void* infl, int B, int N, int KA, int C, int Kc,
    int n, int K_out, float pruning, int expand, void* ws, int64_t ws_bytes,
    void* out_i, void* out_v, void* stream) {
  Plan p;
  const int e = plan(B, N, KA, C, Kc, n, K_out, expand, &p);
  if (e) return e;
  if ((p.slice > 0 && ws == nullptr) || ws_bytes < p.slice * p.ctas)
    return (int)cudaErrorInvalidValue;
  sparse_column_kernel<<<p.ctas, p.threads, p.smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(A_i), static_cast<const float*>(A_v),
      static_cast<const int32_t*>(ci), static_cast<const float*>(cv), c_sb,
      static_cast<const float*>(infl), B, N, KA, C, Kc, n, K_out, pruning,
      expand, p.hbits, p.gbits, static_cast<unsigned char*>(ws), p.slice,
      static_cast<int32_t*>(out_i), static_cast<float*>(out_v));
  return (int)cudaGetLastError();
}

// The sparse MCL engine's input: the links' symmetric COO turned into the
// column-normalized top-K ELL, on the card, for NVIDIA Hopper (sm_90a).
//
// Replaces the host numpy of coo_to_ell (the JAX package's
// haphic_tpu/cluster/sparse_mcl.py:411, host numpy there too; the port's
// CPU route keeps it), bit for bit. Let p be an entry's position in that
// function's concatenation: the E given links (row i, column j, weight
// w), then each off-diagonal link mirrored (row j, column i, in link
// order), then the n self-loops (c, c, 1.0). The kernel names an entry by
// s: e for link e, E + e for its mirror, 2E + c for self-loop c. s orders
// the entries as p does, and fits 32 bits while 2E + n < 2^32. For each
// column c < n, numpy's order rules:
//
//   order   entries by row ascending, duplicates of one row in p order;
//   collapse each run of one row to v0 + pairwise(v1..), numpy's
//           np.add.reduceat in f64: the rest summed from 0.0 one by one
//           under 8 terms, by 8 accumulators up to 128, and split in two
//           (the first half a multiple of 8) past 128; a run of one is v0;
//   normalize by the column's sum, sequential in f64 from 0.0 over the
//           collapsed entries in row order (np.add.at), where it is > 0;
//   cap     where the column has U > K distinct rows (it counts in
//           ``overflow``): keep the K largest, ties to the lower row (NaN
//           last), and divide them by their own sum, sequential in f64
//           from 0.0 in that rank order, where it is > 0;
//   place   the kept entries in ascending row order in slots 0..kept-1,
//           each value cast once to f32; the other slots (n, 0). Column n,
//           the sentinel, has no entry and comes out (n, 0) throughout.
//
// Launches on the caller's stream, in two calls with one read of six
// numbers by the host between them (the entries' total, the scratch the
// wide columns need):
//
//   ell_build_count: eb_count counts each column's entries (atomics over
//     the links; a self-loop each column below n) and flags ids outside
//     [0, n); eb_scan (one CTA) turns the counts into each column's start
//     and cursor, the wide columns' scratch offsets and the numbers the
//     host reads.
//   ell_build_fill: eb_scatter writes each entry's s into its column's
//     bucket at an atomic cursor (any order: the next step sorts it);
//     eb_columns runs one CTA a column through the rules above. It sorts
//     the bucket by (row, s) with a bitonic sort, marks runs and scans
//     them, sums each run, then sums and divides the column on one
//     thread (the sums are sequential by definition), ranks the entries
//     of a capped column by a second bitonic sort and puts the kept ones
//     back in row order by a third, of K entries. A column of at most
//     EB_SMEM_MAX entries does it in shared memory (32 bytes an entry of
//     the launch's widest such column, rounded up to a power of two); a
//     wider one does the same in its own stretch of a global scratch
//     that the host sizes from eb_scan's numbers. The path is set by the
//     column's own width alone.
//
// What bounds it: bytes. The links are read twice (the count and the
// scatter: 24 bytes a link each), the bucket written once and read once
// (4 bytes an entry each), each entry's row and weight read once more by
// its column (12 bytes), and the ELL written (8 bytes a slot); the upload
// of the links over the host's link comes before it, apart. A column's
// sorts and sums are work in shared memory: 2,048 entries at most a
// column on tieguanyin_2x (widest 1,695), three CTAs an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#define EB_THREADS 256
#define EB_SCAN_THREADS 1024
#define EB_SMEM_MAX 4096                  // widest column in shared memory
#define EB_PW_BLOCK 128                   // numpy's PW_BLOCKSIZE
#define EB_NONE 0x7fffffff                // padding of the rank sorts
#define FULL 0xffffffffu

typedef unsigned long long u64;

// info, read by the host after ell_build_count
enum { EB_TOTAL, EB_WIDE, EB_SCRATCH, EB_PMAX, EB_BAD, EB_MAXW, EB_INFO };

struct EbLinks {
  const int64_t* i;
  const int64_t* j;
  const double* w;
  int64_t E;
};

__device__ __forceinline__ int64_t eb_row(const EbLinks& L, unsigned s) {
  const int64_t q = s;
  if (q < L.E) return L.i[q];
  if (q < 2 * L.E) return L.j[q - L.E];
  return q - 2 * L.E;
}

__device__ __forceinline__ double eb_weight(const EbLinks& L, unsigned s) {
  const int64_t q = s;
  if (q < L.E) return L.w[q];
  if (q < 2 * L.E) return L.w[q - L.E];
  return 1.0;
}

__device__ __forceinline__ int64_t eb_pow2(int64_t x) {
  int64_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// numpy's pairwise sum (numpy/_core/src/umath/loops_utils.h.src)
// ---------------------------------------------------------------------------

__device__ double eb_pw_block(const double* x, int n) {
  if (n < 8) {
    double r = 0.0;
    for (int t = 0; t < n; ++t) r += x[t];
    return r;
  }
  double r0 = x[0], r1 = x[1], r2 = x[2], r3 = x[3];
  double r4 = x[4], r5 = x[5], r6 = x[6], r7 = x[7];
  int t = 8;
  for (; t < n - (n % 8); t += 8) {
    r0 += x[t];
    r1 += x[t + 1];
    r2 += x[t + 2];
    r3 += x[t + 3];
    r4 += x[t + 4];
    r5 += x[t + 5];
    r6 += x[t + 6];
    r7 += x[t + 7];
  }
  double res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7));
  for (; t < n; ++t) res += x[t];
  return res;
}

// the recursion of numpy's pairwise sum, on an explicit stack: a node of
// more than 128 terms is its first h terms plus the rest, h = n / 2 less
// its remainder by 8
__device__ double eb_pairwise(const double* x, int64_t n) {
  if (n <= EB_PW_BLOCK) return eb_pw_block(x, (int)n);
  int64_t off[64], len[64];
  double left[64];
  bool right[64];
  int sp = 0;
  off[0] = 0;
  len[0] = n;
  for (;;) {
    while (len[sp] > EB_PW_BLOCK) {          // down the left children
      int64_t h = len[sp] / 2;
      h -= h % 8;
      right[sp] = false;
      off[sp + 1] = off[sp];
      len[sp + 1] = h;
      ++sp;
    }
    double r = eb_pw_block(x + off[sp], (int)len[sp]);
    for (--sp;; --sp) {                      // up, adding finished halves
      if (sp < 0) return r;
      if (!right[sp]) {
        int64_t h = len[sp] / 2;
        h -= h % 8;
        left[sp] = r;
        right[sp] = true;
        off[sp + 1] = off[sp] + h;
        len[sp + 1] = len[sp] - h;
        ++sp;
        break;
      }
      r = left[sp] + r;
    }
  }
}

// ---------------------------------------------------------------------------
// block helpers
// ---------------------------------------------------------------------------

// exclusive prefix of x over the block's threads; *total the block's sum.
// ``buf``: 32 words of shared memory. Every thread must call it.
template <typename T>
__device__ T eb_block_scan(T x, T* total, T* buf) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T v = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) buf[wid] = v;
  __syncthreads();
  if (wid == 0) {
    T s = lane < nw ? buf[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    buf[lane] = s;
  }
  __syncthreads();
  const T pre = (wid > 0 ? buf[wid - 1] : T(0)) + v - x;
  *total = buf[nw - 1];
  __syncthreads();  // buf is free again
  return pre;
}

// ascending bitonic sort of keys[0, P), P a power of two
__device__ void eb_sort_keys(u64* keys, int64_t P) {
  for (int64_t size = 2; size <= P; size <<= 1) {
    for (int64_t stride = size >> 1; stride > 0; stride >>= 1) {
      for (int64_t t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int64_t lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const u64 a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// the rank order of a capped column: value descending, NaN last, ties to
// the lower row (the lower u); the padding (u = EB_NONE) after all
__device__ __forceinline__ bool eb_before(double va, int ua, double vb,
                                          int ub) {
  if (ua == EB_NONE || ub == EB_NONE) return ua < ub;
  const bool na = va != va, nb = vb != vb;
  if (na != nb) return nb;
  if (!na && va != vb) return va > vb;
  return ua < ub;
}

// bitonic sort of the pairs (v[t], u[t]), t < P: by eb_before where
// ``by_rank``, else by u ascending
__device__ void eb_sort_pairs(double* v, int* u, int64_t P, bool by_rank) {
  for (int64_t size = 2; size <= P; size <<= 1) {
    for (int64_t stride = size >> 1; stride > 0; stride >>= 1) {
      for (int64_t t = threadIdx.x; t < P / 2; t += blockDim.x) {
        const int64_t lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const double va = v[lo], vb = v[hi];
        const int ua = u[lo], ub = u[hi];
        const bool b_first = by_rank ? eb_before(vb, ub, va, ua) : ub < ua;
        const bool a_first = by_rank ? eb_before(va, ua, vb, ub) : ua < ub;
        if (((lo & size) == 0) ? b_first : a_first) {
          v[lo] = vb;
          v[hi] = va;
          u[lo] = ub;
          u[hi] = ua;
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// ell_build_count
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EB_THREADS)
    eb_count(EbLinks L, int n, unsigned* __restrict__ cnt,
             long long* __restrict__ info) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < L.E;
       e += step) {
    const int64_t a = L.i[e], b = L.j[e];
    if (a < 0 || a >= n || b < 0 || b >= n) {
      info[EB_BAD] = 1;
      continue;
    }
    atomicAdd(cnt + b, 1u);
    if (a != b) atomicAdd(cnt + a, 1u);
  }
}

// one CTA: each column's width (its links and mirrors, and its self-loop
// below n), start and cursor; the wide columns' scratch offsets; info
__global__ void __launch_bounds__(EB_SCAN_THREADS)
    eb_scan(int n, unsigned* __restrict__ cnt, unsigned* __restrict__ start,
            long long* __restrict__ woff, long long* __restrict__ info) {
  __shared__ unsigned long long buf[32];
  __shared__ unsigned long long red[3][EB_SCAN_THREADS / 32];
  const int64_t n1 = (int64_t)n + 1;
  unsigned long long carry_s = 0, carry_w = 0;
  unsigned long long wide = 0, pmax = 1, maxw = 0;
  for (int64_t b0 = 0; b0 < n1; b0 += EB_SCAN_THREADS) {
    const int64_t c = b0 + threadIdx.x;
    unsigned long long wd = 0, ws = 0;
    if (c < n1) {
      wd = (unsigned long long)cnt[c] + (c < n ? 1 : 0);
      maxw = wd > maxw ? wd : maxw;
      if (wd > EB_SMEM_MAX) {
        ws = (unsigned long long)eb_pow2((int64_t)wd) + 1;
        ++wide;
      } else {
        const unsigned long long p = eb_pow2(wd > 0 ? (int64_t)wd : 1);
        pmax = p > pmax ? p : pmax;
      }
    }
    unsigned long long tot_s, tot_w;
    const unsigned long long ps = eb_block_scan(wd, &tot_s, buf);
    const unsigned long long pw = eb_block_scan(ws, &tot_w, buf);
    if (c < n1) {
      start[c] = (unsigned)(carry_s + ps);
      cnt[c] = (unsigned)(carry_s + ps);  // the scatter's cursor
      woff[c] = (long long)(carry_w + pw);
    }
    carry_s += tot_s;
    carry_w += tot_w;
  }
  // wide: a sum; pmax and maxw: maxima
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wide += __shfl_down_sync(FULL, wide, o);
    const unsigned long long p = __shfl_down_sync(FULL, pmax, o);
    const unsigned long long m = __shfl_down_sync(FULL, maxw, o);
    pmax = p > pmax ? p : pmax;
    maxw = m > maxw ? m : maxw;
  }
  if (lane == 0) {
    red[0][wid] = wide;
    red[1][wid] = pmax;
    red[2][wid] = maxw;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < EB_SCAN_THREADS / 32; ++k) {
      wide += red[0][k];
      pmax = red[1][k] > pmax ? red[1][k] : pmax;
      maxw = red[2][k] > maxw ? red[2][k] : maxw;
    }
    start[n1] = (unsigned)carry_s;
    info[EB_TOTAL] = (long long)carry_s;
    info[EB_WIDE] = (long long)wide;
    info[EB_SCRATCH] = (long long)carry_w;
    info[EB_PMAX] = (long long)pmax;
    info[EB_MAXW] = (long long)maxw;
  }
}

// ---------------------------------------------------------------------------
// ell_build_fill
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(EB_THREADS)
    eb_scatter(EbLinks L, int n, unsigned* __restrict__ cursor,
               unsigned* __restrict__ bucket) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < L.E + n; e += step) {
    if (e < L.E) {
      const int64_t a = L.i[e], b = L.j[e];
      bucket[atomicAdd(cursor + b, 1u)] = (unsigned)e;
      if (a != b) bucket[atomicAdd(cursor + a, 1u)] = (unsigned)(L.E + e);
    } else {
      const int64_t c = e - L.E;
      bucket[atomicAdd(cursor + c, 1u)] = (unsigned)(2 * L.E + c);
    }
  }
}

struct EbCols {
  EbLinks L;
  int n, K;
  int64_t pmax;                      // the narrow columns' layout stride
  const unsigned* start;             // (n + 2)
  const unsigned* bucket;            // start[n + 1]
  const long long* woff;             // (n + 1) wide columns' offsets
  u64* gkeys;                        // the wide columns' scratch
  double* gvals;
  double* gseg;
  int* gust;
  int* grow;
  int* idx;                          // (n + 1, K)
  float* val;
  int* overflow;
};

__global__ void __launch_bounds__(EB_THREADS) eb_columns(EbCols a) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int ibuf[32];
  __shared__ double s_div;
  const int c = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const unsigned s0 = a.start[c];
  const int64_t m = (int64_t)(a.start[c + 1] - s0);
  const int64_t P = eb_pow2(m > 0 ? m : 1);
  // keys (row << 32 | s), the entries' weights then the rank sorts'
  // values, the runs' sums, the runs' starts then the rank sorts' u, the
  // runs' rows
  u64* keys;
  double *vals, *seg;
  int *ust, *rowu;
  if (m > EB_SMEM_MAX) {
    const int64_t o = a.woff[c];
    keys = a.gkeys + o;
    vals = a.gvals + o;
    seg = a.gseg + o;
    ust = a.gust + o;
    rowu = a.grow + o;
  } else {
    keys = reinterpret_cast<u64*>(sm);
    vals = reinterpret_cast<double*>(sm + 8 * a.pmax);
    seg = reinterpret_cast<double*>(sm + 16 * a.pmax);
    ust = reinterpret_cast<int*>(sm + 24 * a.pmax);
    rowu = ust + a.pmax + 1;
  }

  // 1. the bucket by (row, s)
  for (int64_t k = tid; k < P; k += T) {
    u64 key = ~0ull;
    if (k < m) {
      const unsigned s = a.bucket[s0 + k];
      key = ((u64)eb_row(a.L, s) << 32) | s;
    }
    keys[k] = key;
  }
  __syncthreads();
  eb_sort_keys(keys, P);

  // 2. weights, and the runs of one row: their starts
  for (int64_t k = tid; k < m; k += T)
    vals[k] = eb_weight(a.L, (unsigned)(keys[k] & 0xffffffffu));
  const int64_t per = (m + T - 1) / T;
  const int64_t k0 = tid * per < m ? tid * per : m;
  const int64_t k1 = k0 + per < m ? k0 + per : m;
  int mine = 0;
  for (int64_t k = k0; k < k1; ++k)
    mine += k == 0 || (keys[k] >> 32) != (keys[k - 1] >> 32);
  int U;
  int at = eb_block_scan(mine, &U, ibuf);
  for (int64_t k = k0; k < k1; ++k)
    if (k == 0 || (keys[k] >> 32) != (keys[k - 1] >> 32)) ust[at++] = (int)k;
  if (tid == 0) ust[U] = (int)m;
  __syncthreads();

  // 3. each run's sum, as np.add.reduceat
  for (int u = tid; u < U; u += T) {
    const int r0 = ust[u], r1 = ust[u + 1];
    rowu[u] = (int)(keys[r0] >> 32);
    seg[u] = r1 - r0 == 1 ? vals[r0]
                          : vals[r0] + eb_pairwise(vals + r0 + 1, r1 - r0 - 1);
  }
  __syncthreads();

  // 4. the column's sum, one by one from 0.0, and the division
  if (tid == 0) {
    double s = 0.0;
    for (int u = 0; u < U; ++u) s += seg[u];
    s_div = s > 0.0 ? s : 1.0;
  }
  __syncthreads();
  for (int u = tid; u < U; u += T) seg[u] = seg[u] / s_div;
  __syncthreads();

  int* orow = a.idx + (int64_t)c * a.K;
  float* oval = a.val + (int64_t)c * a.K;
  if (U <= a.K) {
    // 5. every entry kept, in row order
    for (int t = tid; t < a.K; t += T) {
      orow[t] = t < U ? rowu[t] : a.n;
      oval[t] = t < U ? (float)seg[t] : 0.f;
    }
    return;
  }
  // 5'. capped: rank, keep K, their sum in rank order, back to row order
  const int64_t P2 = eb_pow2(U);
  for (int64_t t = tid; t < P2; t += T) {
    vals[t] = t < U ? seg[t] : 0.0;
    ust[t] = t < U ? (int)t : EB_NONE;
  }
  __syncthreads();
  eb_sort_pairs(vals, ust, P2, true);
  if (tid == 0) {
    double s = 0.0;
    for (int t = 0; t < a.K; ++t) s += vals[t];
    s_div = s > 0.0 ? s : 1.0;
    atomicAdd(a.overflow, 1);
  }
  __syncthreads();
  const int64_t P3 = eb_pow2(a.K);
  for (int64_t t = tid; t < P3; t += T) {
    if (t < a.K) vals[t] = vals[t] / s_div;
    else ust[t] = EB_NONE;
  }
  __syncthreads();
  eb_sort_pairs(vals, ust, P3, false);
  for (int t = tid; t < a.K; t += T) {
    orow[t] = rowu[ust[t]];
    oval[t] = (float)vals[t];
  }
}

static int eb_grid(int64_t items) {
  int64_t g = (items + EB_THREADS - 1) / EB_THREADS;
  if (g > 132 * 16) g = 132 * 16;          // grid-stride past 16 CTAs an SM
  return g < 1 ? 1 : (int)g;
}

// Counts each column's entries of the E links ``i``, ``j`` (int64) for a
// matrix of n columns and writes, on ``stream``: ``cnt`` (n + 1) uint32,
// each column's cursor; ``start`` (n + 2) uint32; ``woff`` (n + 1) int64,
// the wide columns' scratch offsets; ``info`` (EB_INFO) int64: the
// entries' total, the wide columns, their scratch (entries), the narrow
// columns' stride (a power of two), whether an id lies outside [0, n),
// the widest column. The caller keeps 2E + n < 2^32. Returns the CUDA
// error code (0 on success).
extern "C" int ell_build_count(const void* i, const void* j, long long E,
                               int n, void* cnt, void* start, void* woff,
                               void* info, void* stream) {
  if (E < 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = cudaMemsetAsync(cnt, 0, sizeof(unsigned) * ((size_t)n + 1),
                             st)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(info, 0, sizeof(long long) * EB_INFO, st)) !=
      cudaSuccess)
    return (int)err;
  EbLinks L{static_cast<const int64_t*>(i), static_cast<const int64_t*>(j),
            nullptr, E};
  if (E > 0) {
    eb_count<<<eb_grid(E), EB_THREADS, 0, st>>>(
        L, n, static_cast<unsigned*>(cnt), static_cast<long long*>(info));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  eb_scan<<<1, EB_SCAN_THREADS, 0, st>>>(
      n, static_cast<unsigned*>(cnt), static_cast<unsigned*>(start),
      static_cast<long long*>(woff), static_cast<long long*>(info));
  return (int)cudaGetLastError();
}

// Fills the (n + 1, K) ELL ``idx`` int32 / ``val`` f32 from the links (i,
// j int64, w f64) and ell_build_count's ``cursor`` (its ``cnt``),
// ``start`` and ``woff``, on ``stream``. ``bucket``: start[n + 1] uint32;
// ``gkeys`` .. ``grow``: the wide columns' scratch, info[EB_SCRATCH]
// entries each (none where it is 0); ``pmax``: info[EB_PMAX];
// ``overflow``: one int32, zeroed by the caller, counts the capped
// columns. Returns the CUDA error code (0 on success).
extern "C" int ell_build_fill(const void* i, const void* j, const void* w,
                              long long E, int n, int K, long long pmax,
                              const void* start, void* cursor, void* bucket,
                              const void* woff, void* gkeys, void* gvals,
                              void* gseg, void* gust, void* grow, void* idx,
                              void* val, void* overflow, void* stream) {
  if (E < 0 || n < 0 || K < 1 || pmax < 1 || pmax > EB_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  EbLinks L{static_cast<const int64_t*>(i), static_cast<const int64_t*>(j),
            static_cast<const double*>(w), E};
  if (E + n > 0) {
    eb_scatter<<<eb_grid(E + n), EB_THREADS, 0, st>>>(
        L, n, static_cast<unsigned*>(cursor), static_cast<unsigned*>(bucket));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t smem = 32 * (size_t)pmax + 4;
  if ((err = cudaFuncSetAttribute(
           eb_columns, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)smem)) != cudaSuccess)
    return (int)err;
  EbCols a{L,
           n,
           K,
           pmax,
           static_cast<const unsigned*>(start),
           static_cast<const unsigned*>(bucket),
           static_cast<const long long*>(woff),
           static_cast<u64*>(gkeys),
           static_cast<double*>(gvals),
           static_cast<double*>(gseg),
           static_cast<int*>(gust),
           static_cast<int*>(grow),
           static_cast<int*>(idx),
           static_cast<float*>(val),
           static_cast<int*>(overflow)};
  eb_columns<<<n + 1, EB_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

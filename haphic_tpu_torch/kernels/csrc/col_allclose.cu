// Sparse MCL convergence statistic, for NVIDIA Hopper (sm_90a).
//
// Replaces _col_allclose_stat (haphic_tpu/cluster/sparse_mcl.py:114),
// which JAX vmaps over the columns of each chunk in _sweep_cols
// (:199-201): a concatenation of the old and the new column, a stable
// sort by row id, f32 prefix sums and cummax scans to recover each id's
// run sums. For every (b, column c) this kernel computes
//
//   max over the real row ids r (r < n) of either column of
//       |new[r] - old[r]| - 1e-5 * old[r]
//
// where a side that lacks r counts as 0, or -inf where neither column
// has a real id (the sentinel column n, a mesh's padding columns). It
// computes in f64 from the f32 inputs and rounds to f32 once, as the
// plain version (kernels/col_allclose.py) does with its f64 prefix sums.
//
// The kernel relies on the ELL order every call site passes: each column
// holds ascending distinct real ids, then only sentinels n. So an id
// occurs at most once a column, and one merge of the two sorted columns
// replaces the sort and the run sums. The design, one launch for a
// whole sweep step:
//
//   - A group of LG lanes (8, 16 or 32, from Ko + Kn, so that at K = 16
//     no lane idles) takes one column pair. It stages both columns' ids,
//     and the values of their real ids, in shared memory with coalesced
//     loads, counting each column's real ids.
//   - Each lane takes an equal share of the merged sequence of the real
//     ids: one merge-path search (a binary search along its diagonal,
//     in shared memory) finds where its share starts, then a short
//     sequential merge, the two columns' heads held in registers, visits
//     its ids. On equal ids the old column's entry comes first; it pairs
//     itself with the new entry of the same id, which the new side then
//     skips. This replaces a binary search of the other column for every
//     entry.
//   - The group takes the max by shuffles. A max is exact in any order,
//     so a column's bits do not depend on the launch's B, C, the group
//     width or the lane that took an entry.
//   - The kernel checks the ELL order on every slot of both columns and
//     writes 1 to ``bad`` where a column breaks it (that column's result
//     is then meaningless, but every read stays inside the column); the
//     wrapper or its caller reads the flag and raises.
//   - Columns too wide to stage (Ko + Kn > CA_STAGE_MAX) are merged from
//     device memory in place, by the same code.
//
// What bounds it on the card: the function needs each real entry of
// both columns (8 bytes), the first sentinel id of a column that has one
// (4 bytes) and the f32 it writes: at most (Ko + Kn) * 8 + 4 bytes a
// column, and at the sparse smoke run's step (B = 4, N = 24,001,
// Ko = Kn = 128) far less, since most columns hold fewer than K real
// entries (the smoke computes the bound from the step's ids). Its f64
// arithmetic, a few operations an entry, is two orders of magnitude
// below that. The order check reads the sentinels' ids too (4 bytes a
// slot); the values of sentinel slots are not read.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define CA_THREADS 256       // threads a CTA at most
#define CA_STAGE_BYTES (32 * 1024)  // shared memory a CTA stages into
#define CA_STAGE_MAX (CA_STAGE_BYTES / 8)  // widest Ko + Kn staged

// torch's amax: a NaN on either side wins.
__device__ __forceinline__ double nan_max(double a, double b) {
  return (b != b || b > a) ? b : a;
}

// |nv - ov| - 1e-5 * ov in f64, each operation rounded (no contraction
// into an fma), as torch computes it.
__device__ __forceinline__ double entry_stat(float nv, float ov) {
  const double d = __dsub_rn((double)nv, (double)ov);
  return __dsub_rn(fabs(d), __dmul_rn(1e-5, (double)ov));
}

// Whether any slot of ``ids[0, len)`` taken by this lane (k = lane,
// lane + LG, ...) breaks the ELL order: an id outside [0, n], or a next
// slot that is a real id not above this one (so also a real id after a
// sentinel).
template <int LG>
__device__ __forceinline__ bool out_of_order(const int32_t* ids, int len,
                                             int lane, int n) {
  bool bad = false;
  for (int k = lane; k < len; k += LG) {
    const int32_t id = ids[k];
    const int32_t next = k + 1 < len ? ids[k + 1] : n;
    bad |= id < 0 || id > n || (next != n && next <= id);
  }
  return bad;
}

// How many of the first d merged ids come from ``a`` (ascending, la of
// them) when merged with ``b`` (lb), equal ids taking a's first.
__device__ __forceinline__ int merge_path(const int32_t* a, int la,
                                          const int32_t* b, int lb, int d) {
  int lo = d > lb ? d - lb : 0, hi = d < la ? d : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Stages ``len`` slots of a column (ids, and the values of its real
// ids) from device memory into shared memory with the LG lanes of a
// group (coalesced); returns this lane's count of real ids (< n).
template <int LG>
__device__ __forceinline__ int stage_column(const int32_t* __restrict__ gi,
                                            const float* __restrict__ gv,
                                            int32_t* si, float* sv, int len,
                                            int lane, int n) {
  int real = 0;
  for (int k = lane; k < len; k += LG) {
    const int32_t id = __ldg(gi + k);
    si[k] = id;
    if (id < n) {
      sv[k] = __ldg(gv + k);
      ++real;
    }
  }
  return real;
}

template <int LG, bool STAGE>
__global__ void __launch_bounds__(CA_THREADS)
    col_allclose_kernel(const int32_t* __restrict__ old_i,
                        const float* __restrict__ old_v, int64_t o_sb,
                        const int32_t* __restrict__ new_i,
                        const float* __restrict__ new_v, int64_t n_sb,
                        int B, int C, int Ko, int Kn, int n,
                        float* __restrict__ out, int32_t* __restrict__ bad) {
  extern __shared__ __align__(16) int32_t stage[];
  const int groups = blockDim.x / LG;
  const int gi = threadIdx.x / LG;
  const int lane = threadIdx.x % LG;
  const int64_t col = (int64_t)blockIdx.x * groups + gi;
  const bool live = col < (int64_t)B * C;
  const int64_t b = live ? col / C : 0, c = live ? col - b * C : 0;
  const int32_t* gOi = old_i + b * o_sb + c * Ko;
  const float* gOv = old_v + b * o_sb + c * Ko;
  const int32_t* gNi = new_i + b * n_sb + c * Kn;
  const float* gNv = new_v + b * n_sb + c * Kn;

  // the pair's columns: staged (ids, then the real ids' values), or in
  // place; and each column's count of real ids
  const int32_t *oi = gOi, *ni = gNi;
  const float *ov = gOv, *nv = gNv;
  int lo = 0, ln = 0;
  if (STAGE) {
    int32_t* s = stage + (int64_t)gi * 2 * (Ko + Kn);
    int32_t* sOi = s;
    float* sOv = reinterpret_cast<float*>(s + Ko);
    int32_t* sNi = s + 2 * Ko;
    float* sNv = reinterpret_cast<float*>(s + 2 * Ko + Kn);
    if (live) {
      lo = stage_column<LG>(gOi, gOv, sOi, sOv, Ko, lane, n);
      ln = stage_column<LG>(gNi, gNv, sNi, sNv, Kn, lane, n);
    }
    __syncwarp();
    oi = sOi;
    ov = sOv;
    ni = sNi;
    nv = sNv;
  } else if (live) {
    for (int k = lane; k < Ko; k += LG) lo += __ldg(gOi + k) < n;
    for (int k = lane; k < Kn; k += LG) ln += __ldg(gNi + k) < n;
  }
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, off);
    ln += __shfl_xor_sync(0xffffffffu, ln, off);
  }

  bool unordered = false;
  double best = -INFINITY;
  if (live) {
    unordered = out_of_order<LG>(oi, Ko, lane, n) ||
                out_of_order<LG>(ni, Kn, lane, n);
    // this lane's share [d0, d1) of the lo + ln merged real ids
    const int total = lo + ln, per = (total + LG - 1) / LG;
    const int d0 = min(lane * per, total), d1 = min(d0 + per, total);
    int a = merge_path(oi, lo, ni, ln, d0);
    int e = d0 - a;
    // the two heads (INT_MAX past a column's end) and the last old id
    int32_t ha = a < lo ? oi[a] : INT_MAX;
    int32_t he = e < ln ? ni[e] : INT_MAX;
    int32_t prev = a > 0 ? oi[a - 1] : -1;
    for (int d = d0; d < d1; ++d) {
      if (a < lo && ha <= he) {
        // an id of old: new's value where new has it, else 0
        const bool both = ha == he && e < ln;
        best = nan_max(best, entry_stat(both ? nv[e] : 0.0f, ov[a]));
        prev = ha;
        ++a;
        ha = a < lo ? oi[a] : INT_MAX;
      } else if (e < ln) {
        // an id of new: counted from old's side where old has it
        if (prev != he) best = nan_max(best, entry_stat(nv[e], 0.0f));
        ++e;
        he = e < ln ? ni[e] : INT_MAX;
      }
    }
  }
#pragma unroll
  for (int off = LG / 2; off > 0; off >>= 1)
    best = nan_max(best, __shfl_xor_sync(0xffffffffu, best, off));
  const unsigned mine = (LG == 32 ? 0xffffffffu : ((1u << LG) - 1u))
                        << ((threadIdx.x & 31) / LG * LG);
  const unsigned any = __ballot_sync(0xffffffffu, unordered) & mine;
  if (live && lane == 0) {
    if (any) *bad = 1;
    out[col] = __double2float_rn(best);
  }
}

typedef void (*CaKernel)(const int32_t*, const float*, int64_t,
                         const int32_t*, const float*, int64_t, int, int,
                         int, int, int, float*, int32_t*);

template <int LG>
static CaKernel ca_kernel(bool stage) {
  return stage ? col_allclose_kernel<LG, true> : col_allclose_kernel<LG, false>;
}

// Launches the statistic of ``C`` column pairs of each of ``B`` matrices
// on ``stream``. old_i/old_v: (B, C, Ko), new_i/new_v: (B, C, Kn), each
// (C, K) block row-major, batch strides o_sb and n_sb elements (shared
// by ids and values); out: (B, C) contiguous; bad: one int32 on the
// card, set to 1 (never cleared) where a column is out of ELL order.
// Returns the CUDA error code (0 on success).
extern "C" int col_allclose_launch(const void* old_i, const void* old_v,
                                   int64_t o_sb, const void* new_i,
                                   const void* new_v, int64_t n_sb, int B,
                                   int C, int Ko, int Kn, int n, void* out,
                                   void* bad, void* stream) {
  if (B < 1 || C < 1 || Ko < 1 || Kn < 1 || n < 0 || Ko > (1 << 28) ||
      Kn > (1 << 28))
    return (int)cudaErrorInvalidValue;
  // lanes a pair: about four merged entries a lane, 8 to 32
  const int width = Ko + Kn;
  const int LG = width > 64 ? 32 : width > 32 ? 16 : 8;
  const bool stage = width <= CA_STAGE_MAX;
  int groups = CA_THREADS / LG;
  if (stage) {
    const int fit = CA_STAGE_BYTES / (width * 8);
    if (fit < groups) groups = fit < 32 / LG ? 32 / LG : fit;
    groups -= groups % (32 / LG);  // whole warps
  }
  const int64_t pairs = (int64_t)B * C;
  const int64_t blocks = (pairs + groups - 1) / groups;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = stage ? (size_t)groups * width * 8 : 0;
  CaKernel kern = LG == 32 ? ca_kernel<32>(stage)
                  : LG == 16 ? ca_kernel<16>(stage)
                             : ca_kernel<8>(stage);
  kern<<<(unsigned)blocks, groups * LG, smem,
         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(old_i), static_cast<const float*>(old_v),
      o_sb, static_cast<const int32_t*>(new_i),
      static_cast<const float*>(new_v), n_sb, B, C, Ko, Kn, n,
      static_cast<float*>(out), static_cast<int32_t*>(bad));
  return (int)cudaGetLastError();
}

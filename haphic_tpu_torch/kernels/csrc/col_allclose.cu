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
// occurs at most once a column, and a binary search of the other
// column's sorted ids replaces the sort and the run sums: one warp a
// column, each lane takes entries of new and searches old, then entries
// of old and searches new (an id found in new was counted from new's
// side), and the warp takes the max by shuffles. A max is exact in any
// order, so a column's bits do not depend on the launch's B, C or
// chunking, nor on the lane that took an entry. The kernel checks that
// order as it reads the ids, every slot of both columns, and writes 1 to
// ``bad`` where a column breaks it (that column's result is then
// meaningless); the wrapper or its caller reads the flag and raises.
//
// What bounds it on the card: the function needs each real entry of
// both columns (8 bytes), the first sentinel id of a column that has one
// (4 bytes) and the f32 it writes: at most (Ko + Kn) * 8 + 4 bytes a
// column, and at the sparse smoke run's step (B = 4, N = 24,001,
// Ko = Kn = 128) far less, since most columns hold fewer than K real
// entries (the smoke computes the bound from the step's ids). Its f64
// arithmetic, a few operations an entry, is two orders of magnitude
// below that. The order check reads the sentinels' ids too (4 bytes a
// slot), and the searches read a column's ids again through the L1
// cache (512 bytes a column at K = 128), not from memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CA_WARPS 8    // columns a CTA, one warp each

// The first position of ``ids[0, len)`` whose id is not below ``key``;
// the ids ascend, then the sentinels n, above every real key.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ ids,
                                           int len, int32_t key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Whether slot k of ``ids[0, len)`` (holding ``id``) breaks the ELL
// order: an id outside [0, n], or a next slot that is a real id not
// above this one (so also a real id after a sentinel).
__device__ __forceinline__ bool out_of_order(const int32_t* __restrict__ ids,
                                             int len, int k, int32_t id,
                                             int n) {
  const int32_t next = k + 1 < len ? __ldg(ids + k + 1) : n;
  return id < 0 || id > n || (next != n && next <= id);
}

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

__global__ void __launch_bounds__(CA_WARPS * 32)
    col_allclose_kernel(const int32_t* __restrict__ old_i,
                        const float* __restrict__ old_v, int64_t o_sb,
                        const int32_t* __restrict__ new_i,
                        const float* __restrict__ new_v, int64_t n_sb,
                        int B, int C, int Ko, int Kn, int n,
                        float* __restrict__ out, int32_t* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const int64_t col =
      (int64_t)blockIdx.x * CA_WARPS + (int64_t)(threadIdx.x >> 5);
  if (col >= (int64_t)B * C) return;     // a whole warp at once
  const int64_t b = col / C, c = col - b * C;
  const int32_t* oi = old_i + b * o_sb + c * Ko;
  const float* ov = old_v + b * o_sb + c * Ko;
  const int32_t* ni = new_i + b * n_sb + c * Kn;
  const float* nv = new_v + b * n_sb + c * Kn;
  double best = -INFINITY;
  bool unordered = false;
  // the ids of new: old's value where old has the id, else 0
  for (int k = lane; k < Kn; k += 32) {
    const int32_t id = __ldg(ni + k);
    unordered |= out_of_order(ni, Kn, k, id, n);
    if (id >= n) continue;               // a sentinel
    const int p = lower_bound(oi, Ko, id);
    const float o = (p < Ko && __ldg(oi + p) == id) ? __ldg(ov + p) : 0.0f;
    best = nan_max(best, entry_stat(__ldg(nv + k), o));
  }
  // the ids of old that new lacks: new's value 0
  for (int k = lane; k < Ko; k += 32) {
    const int32_t id = __ldg(oi + k);
    unordered |= out_of_order(oi, Ko, k, id, n);
    if (id >= n) continue;
    const int p = lower_bound(ni, Kn, id);
    if (p < Kn && __ldg(ni + p) == id) continue;
    best = nan_max(best, entry_stat(0.0f, __ldg(ov + k)));
  }
  for (int off = 16; off > 0; off >>= 1)
    best = nan_max(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (__any_sync(0xffffffffu, unordered) && lane == 0) *bad = 1;
  if (lane == 0) out[col] = __double2float_rn(best);
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
  if (B < 1 || C < 1 || Ko < 1 || Kn < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)B * C + CA_WARPS - 1) / CA_WARPS;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  col_allclose_kernel<<<(unsigned)blocks, CA_WARPS * 32, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(old_i), static_cast<const float*>(old_v),
      o_sb, static_cast<const int32_t*>(new_i),
      static_cast<const float*>(new_v), n_sb, B, C, Ko, Kn, n,
      static_cast<float*>(out), static_cast<int32_t*>(bad));
  return (int)cudaGetLastError();
}

// Dense MCL column pass, for NVIDIA Hopper (sm_90a).
//
// Replaces the jitted XLA column pass of haphic_tpu/cluster/mcl.py
// _mcl_batched (:86): the inline inflate (:99), _prune (:70) with its
// _colnorm (:57), and the convergence statistic of _allclose (:79). The
// expansion product before it stays a cuBLAS matmul (torch.matmul), as
// the JAX package left it to XLA (_matpower, :62). For every (b, column c)
// of a (B, n, n) f32 matrix e it computes:
//
//   1. p = x > 0 ? expf(infl[b] * logf(x)) : 0 for every entry x, and the
//      column sum s1 of p;
//   2. q = p * (s1 > 0 ? 1 / s1 : 0), multiplied by the f32 reciprocal as
//      _colnorm does; the first (lowest) row of the column's largest q
//      (jnp.argmax / torch.argmax: an all-zero column keeps row 0, and so
//      stays zero); the sum s2 of the kept q: q >= pruning, or that row;
//   3. new = kept ? q * (s2 > 0 ? 1 / s2 : 0) : 0, written; with old, the
//      largest |new - old| - 1e-5 * |old| over the CTA's entries, one
//      partial a CTA (the wrapper takes the max over a matrix's partials
//      in torch: a max is exact in any order, so no atomics on floats).
//
// The sums are taken in f64 and rounded once to f32, in one fixed order
// that depends only on n: each thread adds its rows in ascending order,
// then the eight warps' partials are added in warp order. A column's bits
// therefore depend on its own entries only, not on B, on its place in the
// batch or on which inflations are still active (the mesh's sharded sweep
// stays bit-equal to the meshless one).
//
// What bounds it on the card: each input read once and each output
// written once, e and new (8 * B * n * n bytes; 12 with old), at 3.35 TB/s
// (0.92 ms at B = 6, n = 8000; 1.37 ms with old), against one logf and one
// expf an entry (2 * B * n * n operations, 0.011 ms at 67 TFLOP/s): the
// bytes. A strip of 32 columns of 8000 rows is 1 MB, past a CTA's shared
// memory, so this simple design reads e three times (one pass a step
// above, recomputing p) and moves 20 bytes an entry with old, 16 without.
//
// Layout: one CTA of 256 threads covers one matrix b and a strip of 32
// columns. A lane owns a column, so a warp reads 128 contiguous bytes of a
// row, and the 8 warps stride over the rows, four rows a step in flight.
// Offsets are 64-bit (B * n * n reaches 3.84e8 at the pipeline's shape).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MC_COLS 32
#define MC_WARPS 8
#define MC_THREADS (MC_COLS * MC_WARPS)

__device__ __forceinline__ float inflate1(float x, float a) {
  return x > 0.f ? expf(__fmul_rn(a, logf(x))) : 0.f;
}

// One pass over the thread's rows r = w, w + 8, ... < n in ascending
// order, four rows a step with their loads issued first; f(row, x).
template <typename F>
__device__ __forceinline__ void rows(const float* __restrict__ col,
                                     int64_t n, int w, F f) {
  int64_t r = w;
  for (; r + 3 * MC_WARPS < n; r += 4 * MC_WARPS) {
    const float x0 = col[r * n];
    const float x1 = col[(r + MC_WARPS) * n];
    const float x2 = col[(r + 2 * MC_WARPS) * n];
    const float x3 = col[(r + 3 * MC_WARPS) * n];
    f(r, x0);
    f(r + MC_WARPS, x1);
    f(r + 2 * MC_WARPS, x2);
    f(r + 3 * MC_WARPS, x3);
  }
  for (; r < n; r += MC_WARPS) f(r, col[r * n]);
}

__global__ void __launch_bounds__(MC_THREADS)
    mcl_column_kernel(const float* __restrict__ e, int64_t e_sb,
                      const float* __restrict__ infl,
                      const float* __restrict__ old, int n_, int strips,
                      float pruning, float* __restrict__ out,
                      float* __restrict__ stat_part) {
  __shared__ double s_sum[MC_WARPS][MC_COLS];
  __shared__ float s_max[MC_WARPS][MC_COLS];
  __shared__ int s_row[MC_WARPS][MC_COLS];
  __shared__ float s_inv[MC_COLS];
  __shared__ int s_arg[MC_COLS];
  __shared__ float s_stat[MC_WARPS];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t b = blockIdx.x / strips;
  const int64_t n = n_;
  const int c = (int)(blockIdx.x % strips) * MC_COLS + lane;
  const bool live = c < n_;
  const float a = infl[b];
  const float* ecol = e + b * e_sb + c;

  // 1. the column sum of p
  double s = 0.0;
  if (live) rows(ecol, n, w, [&](int64_t, float x) { s += inflate1(x, a); });
  s_sum[w][lane] = s;
  __syncthreads();
  if (w == 0) {
    double t = 0.0;
#pragma unroll
    for (int k = 0; k < MC_WARPS; ++k) t += s_sum[k][lane];
    const float s1 = (float)t;
    s_inv[lane] = s1 > 0.f ? 1.f / s1 : 0.f;
  }
  __syncthreads();
  const float inv1 = s_inv[lane];

  // 2. the first argmax of q and the sum of the q >= pruning
  float mx = -1.f;
  int arg = 0;
  s = 0.0;
  if (live)
    rows(ecol, n, w, [&](int64_t r, float x) {
      const float q = __fmul_rn(inflate1(x, a), inv1);
      if (q > mx) {
        mx = q;
        arg = (int)r;
      }
      if (q >= pruning) s += q;
    });
  s_sum[w][lane] = s;
  s_max[w][lane] = mx;
  s_row[w][lane] = arg;
  __syncthreads();
  if (w == 0) {
    double t = 0.0;
    float best = s_max[0][lane];
    int brow = s_row[0][lane];
#pragma unroll
    for (int k = 0; k < MC_WARPS; ++k) {
      t += s_sum[k][lane];
      const float m = s_max[k][lane];
      const int rk = s_row[k][lane];
      if (m > best || (m == best && rk < brow)) {
        best = m;
        brow = rk;
      }
    }
    // the argmax row is kept whatever its value
    if (!(best >= pruning)) t += best;
    const float s2 = (float)t;
    s_inv[lane] = s2 > 0.f ? 1.f / s2 : 0.f;
    s_arg[lane] = brow;
  }
  __syncthreads();
  const float inv2 = s_inv[lane];
  const int argrow = s_arg[lane];

  // 3. write new; with old, the largest |new - old| - 1e-5 |old|
  const int64_t off = b * n * n + c;
  float* ocol = out + off;
  const float* pcol = old ? old + off : nullptr;
  float d = -INFINITY;
  if (live)
    rows(ecol, n, w, [&](int64_t r, float x) {
      const float q = __fmul_rn(inflate1(x, a), inv1);
      const float v =
          (q >= pruning || r == argrow) ? __fmul_rn(q, inv2) : 0.f;
      ocol[r * n] = v;
      if (pcol) {
        const float o = pcol[r * n];
        // rounded as torch's (new - old).abs() - 1e-5 * old.abs()
        d = fmaxf(d, __fsub_rn(fabsf(__fsub_rn(v, o)),
                               __fmul_rn(1e-5f, fabsf(o))));
      }
    });
  if (old) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      d = fmaxf(d, __shfl_down_sync(0xffffffffu, d, o));
    if (lane == 0) s_stat[w] = d;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = s_stat[0];
#pragma unroll
      for (int k = 1; k < MC_WARPS; ++k) t = fmaxf(t, s_stat[k]);
      stat_part[blockIdx.x] = t;
    }
  }
}

// Column strips a matrix of n columns is cut into: the statistic's
// partials are (B, mcl_column_strips(n)).
extern "C" int mcl_column_strips(int n) {
  return (n + MC_COLS - 1) / MC_COLS;
}

// Launches the column pass of ``B`` (n, n) matrices on ``stream``. e: batch
// stride e_sb elements (0: one matrix for every b), each matrix
// row-major; infl: (B,); old: (B, n, n) contiguous, or null; out: (B, n, n)
// contiguous; stat_part: (B, mcl_column_strips(n)), needed with old.
// Returns the CUDA error code (0 on success).
extern "C" int mcl_column_launch(const void* e, int64_t e_sb,
                                 const void* infl, const void* old, int B,
                                 int n, float pruning, void* out,
                                 void* stat_part, void* stream) {
  if (B < 1 || n < 1 || (old != nullptr && stat_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int strips = mcl_column_strips(n);
  const int64_t ctas = (int64_t)B * strips;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  mcl_column_kernel<<<(unsigned)ctas, MC_THREADS, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), e_sb, static_cast<const float*>(infl),
      static_cast<const float*>(old), n, strips, pruning,
      static_cast<float*>(out), static_cast<float*>(stat_part));
  return (int)cudaGetLastError();
}

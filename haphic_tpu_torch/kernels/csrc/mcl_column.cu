// Dense MCL column pass, for NVIDIA Hopper (sm_90a): e read once, one
// strip of columns a thread-block cluster.
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
//      stays zero; a NaN, where 1 / s1 overflows, counts as the largest);
//      the sum s2 of the kept q: q >= pruning, or that row;
//   3. new = kept ? q * (s2 > 0 ? 1 / s2 : 0) : 0, written; with old, the
//      largest |new - old| - 1e-5 * |old| over the CTA's entries (a NaN
//      kept, as torch's amax keeps it), one partial a CTA (the wrapper
//      takes the max over a matrix's partials in torch: a max is exact in
//      any order, so no atomics on floats).
//
// What bounds it on the card: each input read once and each output
// written once, e and new (8 * B * n * n bytes; 12 with old), at 3.35
// TB/s: 0.92 ms at B = 6, n = 8000, 1.376 ms with old. One logf and one
// expf an entry (2 * B * n * n operations) take 0.011 ms at 67 TFLOP/s.
// So the bytes bound it, and only fewer bytes move it: a column of 8000
// floats is past what one CTA holds next to its neighbours, and a design
// of one CTA a strip reads e three times (20 bytes an entry with old).
//
// This design reads e once. One cluster of C CTAs covers one matrix b
// and a strip of W columns (W = 32, 16 or 8: a row's segment is 128, 64
// or 32 bytes, whole sectors). CTA rank k stages the contiguous slab of
// rows [k * rows, (k + 1) * rows) of the strip in its shared memory with
// 4-byte cp.async (rows are 4n bytes apart, so for odd n no segment is
// 16-byte aligned: one load path for every n), in four commit groups, and
// inflates each group in place while the next ones are in flight: p is
// kept, never recomputed. Each copy asks the L2 for the 256-byte block
// around it, which the neighbouring strips' clusters read next. The
// column sums, then the (largest q, its first row) and the kept sums,
// are exchanged through distributed shared memory: each CTA writes its W
// partials into its own shared memory, and after a cluster barrier every
// CTA reads all C ranks' partials in rank order, so all hold the same
// bits; a tie of the largest q goes to the lower row, so to the lower
// rank. The write pass first sends every row of old it will read to the
// L2, then reads old once, writes new once and leaves one statistic
// partial a CTA. A last cluster barrier (arrived at once the partials
// are read, waited on before exit) keeps every CTA's shared memory alive
// while a peer may still read it. On an H100 (700 W) at B = 6, n = 8000
// with old it takes 2.22 ms against the three-pass design's 3.59 ms,
// 62% of the bound; what holds it back is in PERF.md.
//
// The plan (W, C, rows, shared bytes) is a function of n alone, made by
// the wrapper (kernels/mcl_column.py plan) and checked here. The sums are
// taken in f64 and rounded once to f32 in one fixed order that depends
// only on the plan: each thread adds its rows in ascending order, then a
// CTA's row groups are added in order, then the ranks in order. A
// column's bits therefore depend on its own entries and on n only, not on
// B, on its place in the batch or on which inflations are still active
// (the mesh's sharded sweeps stay bit-equal to the meshless ones).
//
// Layout: 256 threads a CTA; thread t owns column t % W of the strip and
// the rows t / W, t / W + 256 / W, ... of the slab, so a warp covers
// 32 / W whole row segments, contiguous in device and in shared memory.
// Offsets into e, old and new are 64-bit (B * n * n reaches 3.84e8 at the
// pipeline's shape, n * n 4.9e9 at the plan's largest n).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define MC_THREADS 256
#define MC_WARPS (MC_THREADS / 32)
#define MC_STAGES 4         // cp.async commit groups of the staging
#define MC_MAX_CLUSTER 16   // past 8 the launch allows non-portable sizes
#define MC_HEAD 6144        // bytes of Head, before the slab

struct Head {
  double tsum[MC_THREADS];   // a thread's partial sum
  float tmax[MC_THREADS];    // a thread's largest q ...
  int trow[MC_THREADS];      // ... and its first row
  double xsum1[32];          // the CTA's partials, read by the cluster
  double xsum2[32];
  float xmax[32];
  int xrow[32];
  float inv1[32];            // the cluster's reciprocals and argmax rows
  float inv2[32];
  int arg[32];
  float stat[MC_WARPS];
};
static_assert(sizeof(Head) <= MC_HEAD, "Head outgrew MC_HEAD");

struct Args {
  const float* e;
  int64_t e_sb;
  const float* infl;
  const float* old;
  float* out;
  float* stat_part;
  int n, C, rows, strips;
  float pruning;
};

__device__ __forceinline__ float inflate1(float x, float a) {
  return x > 0.f ? expf(__fmul_rn(a, logf(x))) : 0.f;
}

// 4 bytes into shared memory, asynchronously; the L2 fetches the whole
// 256-byte block around them, so the strips beside this one find their
// segments of the row there
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], 4;\n" ::"r"(
                   s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most ``pending`` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// the cluster barrier in two halves (cluster.sync() is both at once)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// (m, r) over (best, brow) in torch.argmax's order: NaN above every
// number, then the larger value, then the lower row
__device__ __forceinline__ void take_max(float m, int r, float& best,
                                         int& brow) {
  const bool mn = isnan(m), bn = isnan(best);
  if (mn != bn ? mn : (!mn && m != best ? m > best : r < brow)) {
    best = m;
    brow = r;
  }
}

// max that keeps a NaN, as torch's amax does: one instruction
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int W>
__global__ void __launch_bounds__(MC_THREADS)
    mcl_column_kernel(const Args a) {
  constexpr int G = MC_THREADS / W;  // row groups
  extern __shared__ __align__(16) unsigned char mc_smem[];
  Head& h = *reinterpret_cast<Head*>(mc_smem);
  float* slab = reinterpret_cast<float*>(mc_smem + MC_HEAD);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = a.C;
  const int tid = threadIdx.x, lane = tid & 31, c = tid % W, g = tid / W;
  const int64_t cl = blockIdx.x / C;
  const int64_t b = cl / a.strips;
  const int col = (int)(cl % a.strips) * W + c;
  const bool live = col < a.n;
  const int64_t n = a.n;
  const int row0 = rank * a.rows;
  const int nrows = max(0, min(a.rows, a.n - row0));
  // this thread's rows of the slab: g + k * G for k < kmax
  const int kmax = live && nrows > g ? (nrows - g + G - 1) / G : 0;
  const float infl = a.infl[b];
  float* mine = slab + g * W + c;  // its k-th entry at mine[k * G * W]
  const int64_t gstep = (int64_t)G * n;

  // 1. stage the slab, MC_STAGES groups of `chunk` rows a thread, and
  //    inflate each group in place once it has landed: the sum of p
  const int chunk = (kmax + MC_STAGES - 1) / MC_STAGES;
  {
    const float* src = a.e + b * a.e_sb + (int64_t)(row0 + g) * n + col;
    for (int s = 0; s < MC_STAGES; ++s) {
      const int k1 = min(kmax, (s + 1) * chunk);
      for (int k = s * chunk; k < k1; ++k)
        cp_async4(mine + k * G * W, src + k * gstep);
      cp_async_commit();
    }
  }
  double s = 0.0;
  for (int st = 0; st < MC_STAGES; ++st) {
    cp_async_wait(MC_STAGES - 1 - st);
    const int k1 = min(kmax, (st + 1) * chunk);
    for (int k = st * chunk; k < k1; ++k) {
      const float p = inflate1(mine[k * G * W], infl);
      mine[k * G * W] = p;
      s += p;
    }
  }
  h.tsum[tid] = s;
  __syncthreads();
  if (tid < W) {
    double t = 0.0;
    for (int k = 0; k < G; ++k) t += h.tsum[k * W + tid];
    h.xsum1[tid] = t;
  }
  cluster.sync();
  if (tid < W) {
    double t = 0.0;
    for (int r = 0; r < C; ++r)
      t += *cluster.map_shared_rank(&h.xsum1[tid], (unsigned)r);
    const float s1 = (float)t;
    h.inv1[tid] = s1 > 0.f ? 1.f / s1 : 0.f;
  }
  __syncthreads();
  const float inv1 = h.inv1[c];

  // 2. the first argmax of q and the sum of the q >= pruning
  float mx = -1.f;
  int arg = INT_MAX;
  s = 0.0;
  for (int k = 0; k < kmax; ++k) {
    const float q = __fmul_rn(mine[k * G * W], inv1);
    // q above mx, or the first NaN (rows ascend)
    if (!(q <= mx) && !isnan(mx)) {
      mx = q;
      arg = row0 + g + k * G;
    }
    if (q >= a.pruning) s += q;
  }
  h.tsum[tid] = s;  // read of the first sums ended at cluster.sync()
  h.tmax[tid] = mx;
  h.trow[tid] = arg;
  __syncthreads();
  if (tid < W) {
    double t = 0.0;
    float best = -1.f;
    int brow = INT_MAX;
    for (int k = 0; k < G; ++k) {
      t += h.tsum[k * W + tid];
      take_max(h.tmax[k * W + tid], h.trow[k * W + tid], best, brow);
    }
    h.xsum2[tid] = t;
    h.xmax[tid] = best;
    h.xrow[tid] = brow;
  }
  cluster.sync();
  if (tid < W) {
    double t = 0.0;
    float best = -1.f;
    int brow = INT_MAX;
    for (int r = 0; r < C; ++r) {
      t += *cluster.map_shared_rank(&h.xsum2[tid], (unsigned)r);
      take_max(*cluster.map_shared_rank(&h.xmax[tid], (unsigned)r),
               *cluster.map_shared_rank(&h.xrow[tid], (unsigned)r), best,
               brow);
    }
    // the argmax row is kept whatever its value
    if (!(best >= a.pruning)) t += best;
    const float s2 = (float)t;
    h.inv2[tid] = s2 > 0.f ? 1.f / s2 : 0.f;
    h.arg[tid] = brow;
  }
  cluster_arrive();  // this CTA reads no peer's shared memory from here
  __syncthreads();
  const float inv2 = h.inv2[c];
  const int argrow = h.arg[c] - row0 - g;  // in this thread's rows

  // 3. write new; with old, the largest |new - old| - 1e-5 |old|
  const int64_t off = b * n * n + (int64_t)(row0 + g) * n + col;
  float* dst = a.out + off;
  const float* po = a.old ? a.old + off : nullptr;
  float d = -INFINITY;
  // all of old's rows on their way to the L2 at once; the loads below
  // take eight at a time from there
  if (po)
    for (int k = 0; k < kmax; ++k) prefetch_l2(po + k * gstep);
  for (int k0 = 0; k0 < kmax; k0 += 8) {
    float o[8];
    const int m = min(8, kmax - k0);
    if (po) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < m) o[j] = __ldcs(po + (k0 + j) * gstep);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < m) {
        const int k = k0 + j;
        const float q = __fmul_rn(mine[k * G * W], inv1);
        const float v = (q >= a.pruning || k * G == argrow)
                            ? __fmul_rn(q, inv2)
                            : 0.f;
        __stcs(dst + k * gstep, v);
        if (po)
          // rounded as torch's (new - old).abs() - 1e-5 * old.abs()
          d = nan_max(d, __fsub_rn(fabsf(__fsub_rn(v, o[j])),
                                   __fmul_rn(1e-5f, fabsf(o[j]))));
      }
    }
  }
  if (a.old) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      d = nan_max(d, __shfl_down_sync(0xffffffffu, d, o));
    if (lane == 0) h.stat[tid >> 5] = d;
    __syncthreads();
    if (tid == 0) {
      float t = h.stat[0];
#pragma unroll
      for (int k = 1; k < MC_WARPS; ++k) t = nan_max(t, h.stat[k]);
      a.stat_part[blockIdx.x] = t;
    }
  }
  cluster_wait();
}

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The launch configuration of a plan's C and bytes, its cluster
// attribute in *attr.
static cudaLaunchConfig_t config(int C, int bytes, int64_t ctas,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(MC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes for a plan: the dynamic shared memory past
// 48 KB, and cluster sizes past the portable 8.
template <int W>
static cudaError_t set_attributes(int C, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      mcl_column_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(mcl_column_kernel<W>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  return err;
}

template <int W>
static int launch_w(const Args& a, int bytes, int64_t ctas,
                    cudaStream_t stream) {
  cudaError_t err = set_attributes<W>(a.C, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(a.C, bytes, ctas, stream, &attr);
  if (a.C > 8) {  // a non-portable size may find no SMs that hold it
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, mcl_column_kernel<W>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (count < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&cfg, mcl_column_kernel<W>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Whether (W, C, rows, bytes) is a plan for n on this card: W of 8, 16
// or 32, 1 <= C <= 16, rows = ceil(n / C), bytes = MC_HEAD + the slab,
// within the card's shared memory a block may opt into.
static bool valid_plan(int n, int W, int C, int rows, int bytes) {
  if (n < 1 || (W != 8 && W != 16 && W != 32) || C < 1 ||
      C > MC_MAX_CLUSTER || rows != ceil_div(n, C) ||
      (int64_t)bytes != MC_HEAD + (int64_t)rows * W * 4)
    return false;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return bytes <= optin;
}

// Launches the column pass of ``B`` (n, n) matrices on ``stream`` with the
// plan (W, C, rows, bytes). e: batch stride e_sb elements (0: one matrix
// for every b), each matrix row-major; infl: (B,); old: (B, n, n)
// contiguous, or null; out: (B, n, n) contiguous; stat_part: (B,
// ceil(n / W) * C), needed with old. Returns the CUDA error code (0 on
// success; cudaErrorInvalidValue for a plan that is not one).
extern "C" int mcl_column_launch(const void* e, int64_t e_sb,
                                 const void* infl, const void* old, int B,
                                 int n, int W, int C, int rows, int bytes,
                                 float pruning, void* out, void* stat_part,
                                 void* stream) {
  if (B < 1 || !valid_plan(n, W, C, rows, bytes) ||
      (old != nullptr && stat_part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.e = static_cast<const float*>(e);
  a.e_sb = e_sb;
  a.infl = static_cast<const float*>(infl);
  a.old = static_cast<const float*>(old);
  a.out = static_cast<float*>(out);
  a.stat_part = static_cast<float*>(stat_part);
  a.n = n;
  a.C = C;
  a.rows = rows;
  a.strips = ceil_div(n, W);
  a.pruning = pruning;
  const int64_t ctas = (int64_t)B * a.strips * C;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (W) {
    case 8: return launch_w<8>(a, bytes, ctas, st);
    case 16: return launch_w<16>(a, bytes, ctas, st);
    default: return launch_w<32>(a, bytes, ctas, st);
  }
}

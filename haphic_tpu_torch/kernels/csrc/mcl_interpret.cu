// Cluster labels of the dense MCL sweep's final matrices, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the JAX package's _pack_nz (haphic_tpu/cluster/mcl.py:283),
// which packs each final matrix's nonzero pattern into bits on the device
// for the host's interpret_result (:376) to read, and that interpretation
// itself: the (B, n, n) f32 matrices stay on the card and only (B, n)
// int32 labels leave it. For one matrix m, with nz = (m != 0) (so -0.0
// is zero and NaN nonzero, as numpy has it) and the attractors the rows a
// with nz[a][a]:
//
//   L(j) = the least attractor a with nz[a][j], the label of column j;
//
// and the matrix is a partition (interpret_result returns a list) if and
// only if every column has a label and, for every attractor a and every
// column j, nz[a][j] == (L(j) == L(a)). Then the clusters are the level
// sets of L. Where either condition fails the matrix's row of labels is
// all -1 (interpret_result returns None).
//
// What bounds it on the card: bytes. The diagonal, then each attractor's
// row at most twice (once while the columns look for their labels, once
// for the check), so at most 2 * B * A * n * 4 bytes for A attractors a
// matrix; the check alone must read the A rows once. At B = 6, n = 7,705
// that is at most 2.85 GB (0.85 ms at 3.35 TB/s, A = n), and a few MB at
// the tens to hundreds of attractors a converged matrix has. There the
// walk of step 2 is a chain of load latencies, not bytes: on an H100 (700
// W) at B = 6, n = 8000 the four launches take 0.27 ms on a seeded
// sweep's final matrices (8 to 2,701 attractors; 0.03 ms of bytes) and
// 1.05 ms on identity matrices (A = n; 0.46 ms of bytes).
//
// Four launches on the caller's stream, no host sync, no allocation (the
// wrapper allocates the (B, n) buffers):
//
//   1. mi_attractors: one CTA of 1024 threads a matrix reads the diagonal
//      and compacts the attractors' rows, ascending, by warp ballots and a
//      prefix over the warps' counts; it clears the matrix's flag.
//   2. mi_labels: one warp a strip of 32 columns, a lane a column. The
//      warp walks the attractor list upward, 32 ids at a time, loaded by
//      the lanes at once and handed round by shuffles, with all 32 rows'
//      loads in flight (each a 128-byte segment of one row: a walk is a
//      chain of latencies, so the rounds are what cost), and stops as soon
//      as every lane has met a nonzero entry: the first one is L(j). A
//      column with none flags the matrix.
//   3. mi_check: warps spread over (attractor, chunk of 1024 columns)
//      items; each reads its chunk of the attractor's row once, coalesced,
//      32 loads in flight a lane, with the labels of those columns, against
//      L(a), and flags the matrix at a mismatch. A matrix already flagged
//      is skipped.
//   4. mi_fold: writes -1 over the labels of every flagged matrix.
//
// Offsets into m are 64-bit (B * n * n passes 2^31 at n = 70,000).

#include <cuda_runtime.h>
#include <stdint.h>

#define MI_ATT_THREADS 1024
#define MI_THREADS 256
#define MI_WARPS (MI_THREADS / 32)
#define MI_LOADS 32                        // check loads in flight a lane
#define MI_CHUNK (32 * MI_LOADS)           // columns of a check item
#define MI_CHECK_CTAS 128                  // check CTAs a matrix
#define FULL 0xffffffffu

// 1. the attractors of matrix blockIdx.x, ascending, and their count
__global__ void __launch_bounds__(MI_ATT_THREADS)
    mi_attractors(const float* __restrict__ m, int n, int* __restrict__ att,
                  int* __restrict__ cnt, int* __restrict__ flag) {
  __shared__ int wsum[MI_ATT_THREADS / 32];
  const int64_t b = blockIdx.x;
  const int64_t nn = n;
  const float* mb = m + b * nn * nn;
  int* ab = att + b * nn;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += MI_ATT_THREADS) {
    const int i = i0 + tid;
    const bool is = i < n && mb[(int64_t)i * (nn + 1)] != 0.f;
    const unsigned bal = __ballot_sync(FULL, is);
    if (lane == 0) wsum[w] = __popc(bal);
    __syncthreads();
    int off = base, total = 0;
    for (int k = 0; k < MI_ATT_THREADS / 32; ++k) {
      if (k < w) off += wsum[k];
      total += wsum[k];
    }
    if (is) ab[off + __popc(bal & ((1u << lane) - 1u))] = i;
    base += total;
    __syncthreads();  // every count read before the next round writes
  }
  if (tid == 0) {
    cnt[b] = base;
    flag[b] = 0;
  }
}

// 2. the label of each column: the first attractor, in ascending order,
//    whose row is nonzero there
__global__ void __launch_bounds__(MI_THREADS)
    mi_labels(const float* __restrict__ m, int n, int strips,
              const int* __restrict__ att, const int* __restrict__ cnt,
              int* __restrict__ flag, int* __restrict__ labels) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * MI_WARPS + (threadIdx.x >> 5);
  if (s >= strips) return;  // a whole warp: no shuffle is left waiting
  const int64_t b = blockIdx.y;
  const int64_t nn = n;
  const int j = s * 32 + lane;
  const bool live = j < n;
  const float* col = m + b * nn * nn + (live ? j : 0);
  const int* ab = att + b * nn;
  const int A = cnt[b];
  int L = -1;
  for (int k0 = 0; k0 < A; k0 += 32) {
    const int kn = min(32, A - k0);
    const int mine = lane < kn ? ab[k0 + lane] : 0;
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int r = __shfl_sync(FULL, mine, u);
      v[u] = (live && u < kn) ? col[(int64_t)r * nn] : 0.f;
    }
    int first = 32;  // the first of the 32 rows nonzero in this column
#pragma unroll
    for (int u = 31; u >= 0; --u)
      if (v[u] != 0.f) first = u;
    const int hit = __shfl_sync(FULL, mine, first & 31);
    if (L < 0 && first < 32) L = hit;
    if (__all_sync(FULL, L >= 0 || !live)) break;
  }
  if (live) {
    labels[b * nn + j] = L;
    if (L < 0) flag[b] = 1;
  }
}

// 3. every attractor's row against the labels: nz[a][j] == (L(j) == L(a))
__global__ void __launch_bounds__(MI_THREADS)
    mi_check(const float* __restrict__ m, int n, const int* __restrict__ att,
             const int* __restrict__ cnt, int* __restrict__ flag,
             const int* __restrict__ labels) {
  const int64_t b = blockIdx.y;
  if (*(volatile int*)(flag + b)) return;  // flagged by the labels
  const int64_t nn = n;
  const int lane = threadIdx.x & 31;
  const int chunks = (n + MI_CHUNK - 1) / MI_CHUNK;
  const int64_t items = (int64_t)cnt[b] * chunks;
  const int64_t step = (int64_t)gridDim.x * MI_WARPS;
  const int* lb = labels + b * nn;
  bool bad = false;
  for (int64_t it = (int64_t)blockIdx.x * MI_WARPS + (threadIdx.x >> 5);
       it < items; it += step) {
    const int a = att[b * nn + it / chunks];
    const int la = lb[a];
    const float* row = m + (b * nn + a) * nn;
    const int c0 = (int)(it % chunks) * MI_CHUNK + lane;
    float v[MI_LOADS];
    int l[MI_LOADS];
#pragma unroll
    for (int u = 0; u < MI_LOADS; ++u) {
      const int j = c0 + 32 * u;
      v[u] = j < n ? row[j] : 0.f;
      l[u] = j < n ? __ldg(lb + j) : la + 1;  // past n: agrees
    }
#pragma unroll
    for (int u = 0; u < MI_LOADS; ++u)
      bad |= (v[u] != 0.f) != (l[u] == la);
  }
  if (__any_sync(FULL, bad) && lane == 0) flag[b] = 1;
}

// 4. a flagged matrix's labels become -1
__global__ void __launch_bounds__(MI_THREADS)
    mi_fold(int n, const int* __restrict__ flag, int* __restrict__ labels) {
  const int64_t b = blockIdx.y;
  const int j = blockIdx.x * MI_THREADS + threadIdx.x;
  if (j < n && flag[b]) labels[b * (int64_t)n + j] = -1;
}

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Labels of the B (n, n) f32 matrices of ``m`` (contiguous, row-major)
// into ``labels`` (B, n) int32, on ``stream``: L(j) for each column of a
// partition, a row of -1 for a matrix that is none. Scratch, all (B, n)
// or (B,) int32, written before it is read: ``att`` (B, n), ``cnt`` and
// ``flag`` (B,). Returns the CUDA error code (0 on success).
extern "C" int mcl_interpret_launch(const void* m, int B, int n, void* att,
                                    void* cnt, void* flag, void* labels,
                                    void* stream) {
  if (B < 1 || B > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const float* mf = static_cast<const float*>(m);
  int* ap = static_cast<int*>(att);
  int* cp = static_cast<int*>(cnt);
  int* fp = static_cast<int*>(flag);
  int* lp = static_cast<int*>(labels);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  mi_attractors<<<B, MI_ATT_THREADS, 0, st>>>(mf, n, ap, cp, fp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int strips = ceil_div(n, 32);
  mi_labels<<<dim3(ceil_div(strips, MI_WARPS), B), MI_THREADS, 0, st>>>(
      mf, n, strips, ap, cp, fp, lp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mi_check<<<dim3(MI_CHECK_CTAS, B), MI_THREADS, 0, st>>>(mf, n, ap, cp, fp,
                                                         lp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mi_fold<<<dim3(ceil_div(n, MI_THREADS), B), MI_THREADS, 0, st>>>(n, fp,
                                                                  lp);
  return (int)cudaGetLastError();
}

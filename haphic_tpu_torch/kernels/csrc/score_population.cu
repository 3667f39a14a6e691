// Tour score of a GA population, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel _score_kernel / _score_stacked_pallas in
// haphic_tpu/order/optimize.py (and computes the same function as the
// XLA scorer _score_population / _score_batched there): for every
// (group g, individual p)
//
//     score[g, p] = sum_r w[r] / max(gap_r + d[combo_r, r], 1)
//
// where gap_r and combo_r follow from the slot, start offset and
// orientation of the record's two contigs in tour p. The per-contig
// tables (slot of contig, start offset, orientation) are built by torch
// ops before the launch, as the JAX package builds them outside the
// Pallas body (_build_tables).
//
// What bounds it on the card: per (record, individual) pair it does
// about 25 FP32 operations on 6 table reads, while each record (28
// bytes) is reused by all P individuals, so the least time is set by
// operations (25 * G * P * R against the FP32 rate), not by the bytes
// (G * R * 28 + G * P * k * 12). The design keeps those table reads
// out of device memory: a block holds the tables of a tile of
// individuals in shared memory (when tile * k * 12 bytes fits; else it
// reads them from global memory, where they sit in L2), streams a chunk
// of records with coalesced loads, and keeps one running sum per
// individual of the tile in registers. Blocks write per-chunk partial
// sums; a second kernel adds them in chunk order, so the result does
// not depend on block scheduling (no float atomics).
//
// Grid: x = record chunk, y = individual tile, z = group.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCORE_THREADS 256
#define SCORE_TILE_MAX 16

__global__ void __launch_bounds__(SCORE_THREADS)
score_partial_kernel(const int32_t* __restrict__ pos_of,
                     const float* __restrict__ start_of,
                     const int32_t* __restrict__ ori_of,
                     const float* __restrict__ lengths,
                     const int32_t* __restrict__ pa,
                     const int32_t* __restrict__ pb,
                     const float* __restrict__ d,
                     const float* __restrict__ w,
                     float* __restrict__ partial,
                     int P, int k, int64_t R, int tile, int64_t chunk,
                     int nchunks, int use_smem) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[SCORE_THREADS / 32][SCORE_TILE_MAX];

  const int c = blockIdx.x;
  const int p0 = blockIdx.y * tile;
  const int g = blockIdx.z;
  const int np = min(tile, P - p0);
  const size_t tab = ((size_t)g * P + p0) * (size_t)k;

  const int32_t* tpos = pos_of + tab;
  const float* tstart = start_of + tab;
  const int32_t* tori = ori_of + tab;
  if (use_smem) {
    int32_t* spos = reinterpret_cast<int32_t*>(smem_raw);
    float* sstart = reinterpret_cast<float*>(spos + (size_t)tile * k);
    int32_t* sori = reinterpret_cast<int32_t*>(sstart + (size_t)tile * k);
    const int n = np * k;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      spos[e] = tpos[e];
      sstart[e] = tstart[e];
      sori[e] = tori[e];
    }
    __syncthreads();
    tpos = spos;
    tstart = sstart;
    tori = sori;
  }

  const float* len = lengths + (size_t)g * k;
  const size_t rec = (size_t)g * (size_t)R;
  const float* d0 = d + (size_t)g * 4 * (size_t)R;
  const float* d1 = d0 + R;
  const float* d2 = d1 + R;
  const float* d3 = d2 + R;

  float acc[SCORE_TILE_MAX];
#pragma unroll
  for (int q = 0; q < SCORE_TILE_MAX; ++q) acc[q] = 0.0f;

  const int64_t r0 = (int64_t)c * chunk;
  const int64_t r1 = min(R, r0 + chunk);
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int a = pa[rec + r];
    const int b = pb[rec + r];
    const float la = len[a];
    const float lb = len[b];
    const float dv0 = d0[r], dv1 = d1[r], dv2 = d2[r], dv3 = d3[r];
    const float wr = w[rec + r];
#pragma unroll
    for (int q = 0; q < SCORE_TILE_MAX; ++q) {
      if (q < np) {
        const int ia = q * k + a;
        const int ib = q * k + b;
        const bool a_first = tpos[ia] < tpos[ib];
        const float sa = tstart[ia];
        const float sb = tstart[ib];
        const float gap = a_first ? sb - (sa + la) : sa - (sb + lb);
        int combo = 2 * tori[ia] + tori[ib];
        if (!a_first) combo = 3 - combo;
        const float dv = combo == 0 ? dv0
                         : combo == 1 ? dv1
                         : combo == 2 ? dv2 : dv3;
        const float dist = fmaxf(gap + dv, 1.0f);
        acc[q] += wr / dist;
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < SCORE_TILE_MAX; ++q) {
    float v = acc[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < np) {
    float s = 0.0f;
    for (int wi = 0; wi < SCORE_THREADS / 32; ++wi) s += red[wi][threadIdx.x];
    partial[((size_t)g * P + p0 + threadIdx.x) * nchunks + c] = s;
  }
}

__global__ void score_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int64_t n,
                                    int nchunks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = partial + (size_t)i * nchunks;
  float s = 0.0f;
  for (int c = 0; c < nchunks; ++c) s += row[c];
  out[i] = s;
}

extern "C" int score_population_launch(
    const void* pos_of, const void* start_of, const void* ori_of,
    const void* lengths, const void* pa, const void* pb, const void* d,
    const void* w, void* partial, void* out, int G, int P, int k,
    int64_t R, int tile, int64_t chunk, int nchunks, int use_smem,
    void* stream) {
  if (tile < 1 || tile > SCORE_TILE_MAX || nchunks < 1 || G < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = use_smem ? (size_t)tile * k * 12 : 0;
  cudaError_t e = cudaFuncSetAttribute(
      score_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nchunks, (unsigned)((P + tile - 1) / tile),
            (unsigned)G);
  score_partial_kernel<<<grid, SCORE_THREADS, smem, st>>>(
      static_cast<const int32_t*>(pos_of),
      static_cast<const float*>(start_of),
      static_cast<const int32_t*>(ori_of),
      static_cast<const float*>(lengths), static_cast<const int32_t*>(pa),
      static_cast<const int32_t*>(pb), static_cast<const float*>(d),
      static_cast<const float*>(w), static_cast<float*>(partial), P, k, R,
      tile, chunk, nchunks, use_smem);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)G * P;
  score_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n,
      nchunks);
  return (int)cudaGetLastError();
}

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
// orientation of the record's two contigs in tour p.
//
// What bounds it on the card: per (record, individual) pair it does
// about 25 FP32 operations on 2 table reads, while each record (28
// bytes) is reused by all P individuals, so the least time is set by
// operations (25 * G * P * R against the FP32 rate), not by the bytes
// (G * R * 28 + G * P * k * 8). The design keeps everything but that
// arithmetic off the critical path:
//
//   - One 8-byte table entry per (contig, tour), {slot << 2 | 3 *
//     orientation, f32 start}, laid out contig-major over a tile of
//     tours padded to a multiple of 4: one 16-byte shared-memory load
//     brings a record endpoint in two tours, at a constant offset, and
//     each group of 4 tours is 4 independent chains. Records are sorted
//     by contig, so a warp's A endpoints mostly broadcast.
//   - The tables are built by a kernel of their own, score_table_kernel
//     (one warp per tour: a gather of the slot lengths, an exact int64
//     warp scan for the starts, rounded once to f32, and a scatter by
//     contig); no torch ops run before the launch. The plain version
//     computes the same starts.
//   - Wide tiles: a block holds the tables of up to SCORE_TILE_MAX tours
//     (20 at k = 1024, in 160 KB) and streams a long record range, so
//     each table is copied in once per ~10^4 records and each record
//     chunk is read a few times per group.
//   - The tile's tables (one bulk copy: they are contiguous) and the
//     records are staged into shared memory by Hopper's bulk
//     asynchronous copies (cp.async.bulk, completion on an mbarrier);
//     the records double-buffered, one stage loading while the block
//     computes on the other.
//   - d[combo] is read from the staged record by index (the four arrays
//     lie SCORE_STAGE apart: no bank conflict), and w / dist is w times
//     the hardware's approximate reciprocal (1 ulp).
//   - Blocks write per-chunk partial sums; a second kernel adds them in
//     chunk order, so the result does not depend on block scheduling
//     (no float atomics).
//
// Tables too large for shared memory (k past ~5,000 at 4 tours) are
// read from device memory (L2) instead.
//
// Grid: x = record chunk, y = tour tile, z = group.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCORE_THREADS 1024
#define SCORE_TILE_MAX 32
#define SCORE_STAGE 1024  // records per staged chunk (28 KB)
#define SCORE_ARRAYS 7    // pa, pb, d0..d3, w

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__host__ __device__ __forceinline__ int tile_pad(int tile) { return (tile + 3) & ~3; }

// Table of tour p, built by one warp (one per tour): for each contig c,
// tab[(tile block of p) + c * pad + p % tile] = {slot << 2 | 3 * ori, f32
// bits of the exact int64 start of the slot, rounded once}. The loads
// of SCORE_BUILD_UNROLL rounds of 32 slots are issued together (slot ->
// contig -> length is a chain of two dependent loads).
#define SCORE_BUILD_UNROLL 32
__global__ void score_table_kernel(const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ ori,
                                   const int64_t* __restrict__ lengths,
                                   int2* __restrict__ tab, int G, int P,
                                   int k, int tile) {
  const int warps = blockDim.x / 32;
  const int64_t tour = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5);
  if (tour >= (int64_t)G * P) return;
  const int g = (int)(tour / P);
  const int p = (int)(tour % P);
  const int pad = tile_pad(tile);
  const int ntiles = (P + tile - 1) / tile;
  const int32_t* row = order + tour * k;
  const int32_t* orow = ori + tour * k;
  const int64_t* len = lengths + (int64_t)g * k;
  int2* dst = tab + ((int64_t)g * ntiles + p / tile) * k * pad + p % tile;

  const int lane = threadIdx.x & 31;
  long long carry = 0;
  for (int s0 = 0; s0 < k; s0 += 32 * SCORE_BUILD_UNROLL) {
    int c[SCORE_BUILD_UNROLL], o[SCORE_BUILD_UNROLL];
    long long L[SCORE_BUILD_UNROLL];
#pragma unroll
    for (int u = 0; u < SCORE_BUILD_UNROLL; ++u) {
      const int s = s0 + u * 32 + lane;
      c[u] = s < k ? __ldg(row + s) : -1;
      o[u] = s < k ? __ldg(orow + s) : 0;
    }
#pragma unroll
    for (int u = 0; u < SCORE_BUILD_UNROLL; ++u)
      L[u] = c[u] >= 0 ? __ldg(len + c[u]) : 0;
#pragma unroll
    for (int u = 0; u < SCORE_BUILD_UNROLL; ++u) {
      long long incl = L[u];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (c[u] >= 0)
        dst[(int64_t)c[u] * pad] = make_int2(
            ((s0 + u * 32 + lane) << 2) | (o[u] & 1) * 3,
            __float_as_int(__ll2float_rn(carry + incl - L[u])));
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// 1 / x by the hardware's approximation (rcp.approx: within 1 ulp; the
// distances are >= 1, so flushing denormals changes nothing)
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// w / max(gap + d[combo], 1) of one record in one tour, from its two
// table entries {slot << 2 | 3 * ori, start bits}; buf_i points at the
// record's d0 in the staged chunk.
__device__ __forceinline__ float pair_term(int ax, int ay, int bx, int by,
                                           float la, float lb, float wr,
                                           const float* buf_i) {
  const bool a_first = ax < bx;  // slots differ: a != b
  const float sa = __int_as_float(ay);
  const float sb = __int_as_float(by);
  const float gap = a_first ? sb - (sa + la) : sa - (sb + lb);
  // (ax & 2) | (bx & 1) = 2 oA + oB; seen from the first contig:
  // 3 - combo = combo ^ 3
  const int combo = ((ax & 2) | (bx & 1)) ^ (a_first ? 0 : 3);
  const float dv = buf_i[combo * SCORE_STAGE];
  return wr * rcp_approx(fmaxf(gap + dv, 1.0f));
}

template <bool SMEM_TABLE>
__global__ void __launch_bounds__(SCORE_THREADS, 1)
score_partial_kernel(const int2* __restrict__ gtab,
                     const int64_t* __restrict__ lengths,
                     const int32_t* __restrict__ pa,
                     const int32_t* __restrict__ pb,
                     const float* __restrict__ d,
                     const float* __restrict__ w,
                     float* __restrict__ partial, int P, int k, int64_t R,
                     int tile, int64_t chunk, int nchunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[SCORE_THREADS / 32][SCORE_TILE_MAX];
  __shared__ __align__(8) uint64_t bars[3];  // two record stages, the table

  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int g = blockIdx.z;
  const int ntiles = gridDim.y;
  const int p0 = t * tile;
  const int np = min(tile, P - p0);
  const int pad = tile_pad(tile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float* stage = reinterpret_cast<float*>(smem_raw);  // [2][7][STAGE]
  int2* stab = reinterpret_cast<int2*>(stage + 2 * SCORE_ARRAYS * SCORE_STAGE);
  const int2* grow = gtab + ((size_t)g * ntiles + t) * (size_t)k * pad;

  const int64_t r0 = (int64_t)c * chunk;
  const int64_t r1 = min(R, r0 + chunk);
  const int nstages = r1 > r0 ? (int)((r1 - r0 + SCORE_STAGE - 1) / SCORE_STAGE)
                              : 0;
  const size_t rec = (size_t)g * (size_t)R;
  const float* drow = d + (size_t)g * 4 * (size_t)R;

  // one thread issues the 7 bulk copies of a stage into buffer b
  auto issue = [&](int s, int b) {
    const int64_t a0 = r0 + (int64_t)s * SCORE_STAGE;
    const int n = (int)min((int64_t)SCORE_STAGE, r1 - a0);
    const uint32_t bytes = (uint32_t)n * 4u;
    float* dst = stage + (size_t)b * SCORE_ARRAYS * SCORE_STAGE;
    mbar_expect_tx(&bars[b], bytes * SCORE_ARRAYS);
    bulk_load(dst, pa + rec + a0, bytes, &bars[b]);
    bulk_load(dst + SCORE_STAGE, pb + rec + a0, bytes, &bars[b]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bulk_load(dst + (2 + q) * SCORE_STAGE, drow + (size_t)q * R + a0, bytes,
                &bars[b]);
    bulk_load(dst + 6 * SCORE_STAGE, w + rec + a0, bytes, &bars[b]);
  };

  if (threadIdx.x == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool table_copy = SMEM_TABLE && nstages > 0;
  if (threadIdx.x == 0) {
    if (table_copy) {
      const uint32_t tbytes = (uint32_t)k * (uint32_t)pad * 8u;
      mbar_expect_tx(&bars[2], tbytes);
      bulk_load(stab, grow, tbytes, &bars[2]);
    }
    for (int s = 0; s < 2 && s < nstages; ++s) issue(s, s);
  }
  if (table_copy) mbar_wait(&bars[2], 0);
  const int2* tab = SMEM_TABLE ? stab : grow;

  const int64_t* len = lengths + (size_t)g * k;
  float acc[SCORE_TILE_MAX];
#pragma unroll
  for (int q = 0; q < SCORE_TILE_MAX; ++q) acc[q] = 0.0f;

  for (int s = 0; s < nstages; ++s) {
    const int b = s & 1;
    mbar_wait(&bars[b], (uint32_t)((s >> 1) & 1));
    const float* buf = stage + (size_t)b * SCORE_ARRAYS * SCORE_STAGE;
    const int* spa = reinterpret_cast<const int*>(buf);
    const int* spb = reinterpret_cast<const int*>(buf + SCORE_STAGE);
    const int n = (int)min((int64_t)SCORE_STAGE,
                           r1 - (r0 + (int64_t)s * SCORE_STAGE));
    for (int i = threadIdx.x; i < n; i += SCORE_THREADS) {
      const int a = spa[i];
      const int bb = spb[i];
      const float la = __ll2float_rn(__ldg(len + a));
      const float lb = __ll2float_rn(__ldg(len + bb));
      const float wr = buf[6 * SCORE_STAGE + i];
      const float* buf_i = buf + 2 * SCORE_STAGE + i;
      const int4* ta = reinterpret_cast<const int4*>(tab + (size_t)a * pad);
      const int4* tb = reinterpret_cast<const int4*>(tab + (size_t)bb * pad);
#pragma unroll
      for (int q4 = 0; q4 < SCORE_TILE_MAX / 4; ++q4) {
        if (4 * q4 < np) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int4 A = SMEM_TABLE ? ta[2 * q4 + h] : __ldg(ta + 2 * q4 + h);
            const int4 B = SMEM_TABLE ? tb[2 * q4 + h] : __ldg(tb + 2 * q4 + h);
            acc[4 * q4 + 2 * h] += pair_term(A.x, A.y, B.x, B.y, la, lb, wr,
                                             buf_i);
            acc[4 * q4 + 2 * h + 1] += pair_term(A.z, A.w, B.z, B.w, la, lb,
                                                 wr, buf_i);
          }
        }
      }
    }
    __syncthreads();  // buffer b is free again
    if (threadIdx.x == 0 && s + 2 < nstages) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s + 2, b);
    }
  }

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

// Record chunk length (a multiple of SCORE_STAGE) that finishes the
// grid soonest: waves of resident blocks times the per-block work (its
// stages plus about one stage for the table copy and the epilogue).
static int64_t pick_chunk(int64_t R, int G, int ntiles, int resident) {
  const int64_t nst = (R + SCORE_STAGE - 1) / SCORE_STAGE;
  if (nst <= 1) return SCORE_STAGE;
  int64_t best = nst, best_cost = -1;
  for (int64_t per = 1; per <= nst; ++per) {
    const int64_t n = (nst + per - 1) / per;
    const int64_t blocks = (int64_t)G * ntiles * n;
    const int64_t waves = (blocks + resident - 1) / resident;
    const int64_t cost = waves * (per + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return best * SCORE_STAGE;
}

// gtab: int2 scratch of G * ceil(P / tile) * k * pad(tile) entries.
extern "C" int score_population_launch(
    const void* order, const void* ori, const void* lengths, void* gtab,
    const void* pa, const void* pb, const void* d, const void* w,
    void* partial, int64_t max_chunks, void* out, int G, int P, int k,
    int64_t R, int tile, int smem_table, void* stream) {
  if (tile < 1 || tile > SCORE_TILE_MAX || G < 1 || P < 1 || k < 1 ||
      (R % 4) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t stage_bytes = (size_t)2 * SCORE_ARRAYS * SCORE_STAGE * 4;
  const size_t smem =
      stage_bytes + (smem_table ? (size_t)k * tile_pad(tile) * 8 : 0);
  auto kern = smem_table ? score_partial_kernel<true>
                         : score_partial_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, SCORE_THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (P + tile - 1) / tile;
  const int64_t chunk = pick_chunk(R, G, ntiles, nsm * per_sm);
  const int nchunks = R > 0 ? (int)((R + chunk - 1) / chunk) : 1;
  if (nchunks > max_chunks) return (int)cudaErrorInvalidValue;

  const int warps = 8;
  const int64_t tours = (int64_t)G * P;
  score_table_kernel<<<(unsigned)((tours + warps - 1) / warps), warps * 32, 0,
                       st>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(ori),
      static_cast<const int64_t*>(lengths), static_cast<int2*>(gtab), G, P, k,
      tile);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dim3 grid((unsigned)nchunks, (unsigned)ntiles, (unsigned)G);
  kern<<<grid, SCORE_THREADS, smem, st>>>(
      static_cast<const int2*>(gtab), static_cast<const int64_t*>(lengths),
      static_cast<const int32_t*>(pa), static_cast<const int32_t*>(pb),
      static_cast<const float*>(d), static_cast<const float*>(w),
      static_cast<float*>(partial), P, k, R, tile, chunk, nchunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)G * P;
  score_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n,
      nchunks);
  return (int)cudaGetLastError();
}

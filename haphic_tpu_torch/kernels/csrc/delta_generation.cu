// Delta generation of the device GA, for NVIDIA Hopper (sm_90a).
//
// Replaces dgen in _evolve_delta_impl, haphic_tpu/order/optimize.py:824
// (jitted XLA there, ~40 elementwise ops over (G, P, R) tensors per
// generation). For every (group g, individual p) with its move (do, op,
// i, j, t and the slot scalars Sx, Sy, Lx, Ly, Et), every CLM record r:
//
//   - both cached endpoints (slot, exact int32 start, orientation) are
//     updated in closed form (_endpoint_update, optimize.py:709);
//   - the record's new contribution w / max(gap + d[combo], 1) is formed
//     (_contrib_from_cache, optimize.py:659);
//   - delta[g, p] = sum_r (new - old), old being the carried contrib.
//
// Then, in a second kernel, the rows whose delta passed the acceptance
// test (done by torch between the two launches) write their updated
// caches and contributions in place, visiting only the record chunks in
// which the first kernel found a touched record (a local move touches
// a few chunks: records are sorted by contig).
//
// Bit-identical contributions. The carried contrib comes from torch's
// _contrib_from_cache at every cycle start, and records a move does not
// touch must give exactly 0.0 (optimize.py:837-845: reduction noise turns
// neutral block moves into an accepted random walk). So the arithmetic
// is torch's, operation for operation: the exact int32 gap rounded once
// (__int2float_rn), __fadd_rn, fmaxf, and an IEEE division (__fdiv_rn;
// no fast math). That makes contrib == formula(caches) an invariant, so
// a record whose two endpoints lie outside the move's slot range
// [i, j] (or [i, t) for a rotation) is skipped: its (new - old) is 0.0.
//
// What bounds it on the card: bytes. Every (individual, record) pair
// reads its two slots (8 bytes, coalesced, 16-byte loads); only the
// records a move touches read the rest of their state and the record
// data (which stay in L2: 28 bytes a record). The sums are per block
// and reduced in a fixed order by a second small kernel (no float
// atomics), so GA runs are repeatable.
//
// Grid: x = record chunk, y = individual, z = group.

#include <cuda_runtime.h>
#include <stdint.h>

#define DELTA_THREADS 256

struct Move {
  int do_, op, i, j, t, Sx, Sy, Lx, Ly, Et;
};

__device__ __forceinline__ Move load_move(const int32_t* m) {
  Move v;
  v.do_ = m[0]; v.op = m[1]; v.i = m[2]; v.j = m[3]; v.t = m[4];
  v.Sx = m[5]; v.Sy = m[6]; v.Lx = m[7]; v.Ly = m[8]; v.Et = m[9];
  return v;
}

// slots whose endpoint state the move may change: [lo, hi]
__device__ __forceinline__ void move_range(const Move& m, int& lo, int& hi) {
  lo = m.i;
  hi = m.op == 2 ? m.t - 1 : (m.op <= 3 && m.op >= 0 ? m.j : m.i - 1);
  if (!m.do_) hi = lo - 1;
}

__device__ __forceinline__ void endpoint_update(int& pos, int& s, int& o,
                                                int le, const Move& m) {
  if (!m.do_) return;
  const int dL = m.Ly - m.Lx;
  if (m.op == 0) {
    if (pos == m.i) {
      pos = m.j;
      s = m.Sy + dL;
    } else if (pos == m.j) {
      pos = m.i;
      s = m.Sx;
    } else if (pos > m.i && pos < m.j) {
      s = s + dL;
    }
  } else if (m.op == 1) {
    if (pos >= m.i && pos <= m.j) {
      pos = m.i + m.j - pos;
      s = m.Sx + (m.Sy + m.Ly) - s - le;
      o = 1 - o;
    }
  } else if (m.op == 2) {
    if (pos >= m.i && pos < m.j) {
      pos = pos + (m.t - m.j);
      s = s + (m.Et - m.Sy);
    } else if (pos >= m.i && pos < m.t) {
      pos = pos - (m.j - m.i);
      s = s - (m.Sy - m.Sx);
    }
  } else if (m.op == 3) {
    if (pos >= m.i && pos <= m.j) o = 1 - o;
  }
}

__device__ __forceinline__ float contribution(int posA, int sA, int oA,
                                              int posB, int sB, int oB,
                                              int la, int lb, float d0,
                                              float d1, float d2, float d3,
                                              float w) {
  const bool a_first = posA < posB;
  const int gap = a_first ? sB - (sA + la) : sA - (sB + lb);
  int combo = 2 * oA + oB;
  if (!a_first) combo = 3 - combo;
  const float dv = combo == 0 ? d0 : combo == 1 ? d1 : combo == 2 ? d2 : d3;
  const float dist = fmaxf(__fadd_rn(__int2float_rn(gap), dv), 1.0f);
  return __fdiv_rn(w, dist);
}

struct Ptrs {
  int32_t* posA; int32_t* sA; int32_t* oA;
  int32_t* posB; int32_t* sB; int32_t* oB;
  float* contrib;
  const int32_t* la; const int32_t* lb;
  const float* d; const float* w;
};

// new state and contribution of record r (row offset base, record
// offset rbase) under move m
struct Updated {
  int posA, sA, oA, posB, sB, oB;
  float c;
};

__device__ __forceinline__ Updated update_record(const Ptrs& q, const Move& m,
                                                 size_t base, size_t rbase,
                                                 int64_t R, int64_t r,
                                                 int pA, int pB) {
  Updated u;
  const size_t e = base + r;
  u.posA = pA; u.sA = q.sA[e]; u.oA = q.oA[e];
  u.posB = pB; u.sB = q.sB[e]; u.oB = q.oB[e];
  const int la = __ldg(q.la + rbase + r);
  const int lb = __ldg(q.lb + rbase + r);
  endpoint_update(u.posA, u.sA, u.oA, la, m);
  endpoint_update(u.posB, u.sB, u.oB, lb, m);
  const float* dr = q.d + 4 * rbase + r;
  u.c = contribution(u.posA, u.sA, u.oA, u.posB, u.sB, u.oB, la, lb,
                     __ldg(dr), __ldg(dr + R), __ldg(dr + 2 * R),
                     __ldg(dr + 3 * R), __ldg(q.w + rbase + r));
  return u;
}

// Calls f(r, posA[r], posB[r]) for every record of [r0, r1) this thread
// owns whose endpoints may have moved; 16-byte slot loads when vec.
template <typename F>
__device__ __forceinline__ void for_affected(const Ptrs& q, size_t base,
                                             int64_t r0, int64_t r1, int lo,
                                             int hi, int vec, F f) {
  if (hi < lo) return;
  if (vec) {
    const int4* pa4 = reinterpret_cast<const int4*>(q.posA + base);
    const int4* pb4 = reinterpret_cast<const int4*>(q.posB + base);
    for (int64_t v = r0 / 4 + threadIdx.x; v < r1 / 4; v += blockDim.x) {
      const int4 a = pa4[v];
      const int4 b = pb4[v];
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((av[u] >= lo && av[u] <= hi) || (bv[u] >= lo && bv[u] <= hi))
          f(4 * v + u, av[u], bv[u]);
      }
    }
  } else {
    for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const int a = q.posA[base + r];
      const int b = q.posB[base + r];
      if ((a >= lo && a <= hi) || (b >= lo && b <= hi)) f(r, a, b);
    }
  }
}

__global__ void __launch_bounds__(DELTA_THREADS)
delta_partial_kernel(const int32_t* __restrict__ moves, Ptrs q,
                     float* __restrict__ partial,
                     uint8_t* __restrict__ touched, int P, int64_t R,
                     int64_t chunk, int nchunks, int vec) {
  __shared__ float red[DELTA_THREADS / 32];
  const int c = blockIdx.x;
  const int p = blockIdx.y;
  const int g = blockIdx.z;
  const size_t row = (size_t)g * P + p;
  const Move m = load_move(moves + row * 10);
  int lo, hi;
  move_range(m, lo, hi);
  const size_t base = row * (size_t)R;
  const size_t rbase = (size_t)g * (size_t)R;
  const int64_t r0 = (int64_t)c * chunk;
  const int64_t r1 = min(R, r0 + chunk);

  float acc = 0.0f;
  int any = 0;
  for_affected(q, base, r0, r1, lo, hi, vec,
               [&](int64_t r, int pA, int pB) {
                 const Updated u = update_record(q, m, base, rbase, R, r,
                                                 pA, pB);
                 acc += u.c - q.contrib[base + r];
                 any = 1;
               });
  any = __syncthreads_or(any);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int wi = 0; wi < DELTA_THREADS / 32; ++wi) s += red[wi];
    partial[row * nchunks + c] = s;
    touched[row * nchunks + c] = (uint8_t)any;
  }
}

__global__ void delta_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int64_t n,
                                    int nchunks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = partial + (size_t)i * nchunks;
  float s = 0.0f;
  for (int c = 0; c < nchunks; ++c) s += row[c];
  out[i] = s;
}

__global__ void __launch_bounds__(DELTA_THREADS)
delta_commit_kernel(const int32_t* __restrict__ moves,
                    const uint8_t* __restrict__ accept,
                    const uint8_t* __restrict__ touched, Ptrs q, int P,
                    int64_t R, int64_t chunk, int nchunks, int vec) {
  const int c = blockIdx.x;
  const int p = blockIdx.y;
  const int g = blockIdx.z;
  const size_t row = (size_t)g * P + p;
  // only accepted rows, and only the chunks the delta pass found touched
  if (!accept[row] || !touched[row * nchunks + c]) return;
  const Move m = load_move(moves + row * 10);
  int lo, hi;
  move_range(m, lo, hi);
  const size_t base = row * (size_t)R;
  const size_t rbase = (size_t)g * (size_t)R;
  const int64_t r0 = (int64_t)c * chunk;
  const int64_t r1 = min(R, r0 + chunk);
  for_affected(q, base, r0, r1, lo, hi, vec,
               [&](int64_t r, int pA, int pB) {
                 const Updated u = update_record(q, m, base, rbase, R, r,
                                                 pA, pB);
                 const size_t e = base + r;
                 q.posA[e] = u.posA; q.sA[e] = u.sA; q.oA[e] = u.oA;
                 q.posB[e] = u.posB; q.sB[e] = u.sB; q.oB[e] = u.oB;
                 q.contrib[e] = u.c;
               });
}

static Ptrs make_ptrs(void* posA, void* sA, void* oA, void* posB, void* sB,
                      void* oB, void* contrib, const void* la,
                      const void* lb, const void* d, const void* w) {
  Ptrs q;
  q.posA = static_cast<int32_t*>(posA);
  q.sA = static_cast<int32_t*>(sA);
  q.oA = static_cast<int32_t*>(oA);
  q.posB = static_cast<int32_t*>(posB);
  q.sB = static_cast<int32_t*>(sB);
  q.oB = static_cast<int32_t*>(oB);
  q.contrib = static_cast<float*>(contrib);
  q.la = static_cast<const int32_t*>(la);
  q.lb = static_cast<const int32_t*>(lb);
  q.d = static_cast<const float*>(d);
  q.w = static_cast<const float*>(w);
  return q;
}

// touched: uint8 (G, P, nchunks) scratch the commit reads back
extern "C" int delta_scores_launch(
    const void* moves, void* posA, void* sA, void* oA, void* posB, void* sB,
    void* oB, void* contrib, const void* la, const void* lb, const void* d,
    const void* w, void* partial, void* touched, void* delta, int G, int P,
    int64_t R, int64_t chunk, int nchunks, int vec, void* stream) {
  if (G < 1 || P < 1 || nchunks < 1 || chunk < 1 || (vec && chunk % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Ptrs q = make_ptrs(posA, sA, oA, posB, sB, oB, contrib, la, lb, d, w);
  dim3 grid((unsigned)nchunks, (unsigned)P, (unsigned)G);
  delta_partial_kernel<<<grid, DELTA_THREADS, 0, st>>>(
      static_cast<const int32_t*>(moves), q, static_cast<float*>(partial),
      static_cast<uint8_t*>(touched), P, R, chunk, nchunks, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)G * P;
  delta_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(delta), n,
      nchunks);
  return (int)cudaGetLastError();
}

extern "C" int delta_commit_launch(
    const void* moves, const void* accept, const void* touched, void* posA,
    void* sA, void* oA, void* posB, void* sB, void* oB, void* contrib,
    const void* la, const void* lb, const void* d, const void* w, int G,
    int P, int64_t R, int64_t chunk, int nchunks, int vec, void* stream) {
  if (G < 1 || P < 1 || nchunks < 1 || chunk < 1 || (vec && chunk % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Ptrs q = make_ptrs(posA, sA, oA, posB, sB, oB, contrib, la, lb, d, w);
  dim3 grid((unsigned)nchunks, (unsigned)P, (unsigned)G);
  delta_commit_kernel<<<grid, DELTA_THREADS, 0, st>>>(
      static_cast<const int32_t*>(moves),
      static_cast<const uint8_t*>(accept),
      static_cast<const uint8_t*>(touched), q, P, R, chunk, nchunks, vec);
  return (int)cudaGetLastError();
}

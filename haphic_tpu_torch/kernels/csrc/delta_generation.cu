// Delta generation of the device GA, for NVIDIA Hopper (sm_90a): one
// launch per generation.
//
// Replaces dgen in _evolve_delta_impl, haphic_tpu/order/optimize.py:
// 824-894 (jitted XLA there, ~40 elementwise ops over (G, P, R) tensors
// per generation), all of it but the random draws. For every (group g,
// individual p) row:
//
//   - in draws mode (the GA's), the move (do, op, i, j, t) is made from
//     the row's seven draws as _sample_moves makes it (optimize.py:
//     515-537), in torch's f32 arithmetic: logf, an IEEE division by the
//     f32 log(0.75), floorf, then integer min/max/where. Every CTA of
//     the row's cluster makes the same move from the same draws. In move
//     mode the move is read as given;
//   - the move scalars Sx, Sy, Lx, Ly, Et are read from startsx
//     (_move_scalars, optimize.py:774);
//   - every CLM record r with an endpoint on a slot of the move's range
//     [i, j] ([i, t) for a rotation) has both endpoints (slot, exact
//     int32 start, orientation) updated in closed form
//     (_endpoint_update, optimize.py:709) and its new contribution
//     w / max(gap + d[combo], 1) formed (_contrib_from_cache, :659);
//   - delta = sum_r (new - old), and the row accepts when delta > thr,
//     thr = score * (min_gain + span_gain * span) (:859-861), or by a
//     given mask;
//   - an accepted row writes the new caches and contributions of its
//     touched records in place, applies the move to order, ori and
//     L_slot (the _move_src rule, :541), rebuilds startsx over the span
//     and adds delta to its score.
//
// Bit-identical contributions. The carried contrib comes from torch's
// _contrib_from_cache at every cycle start, and records a move does not
// touch must give exactly 0.0 (optimize.py:837-845: reduction noise turns
// neutral block moves into an accepted random walk). So the arithmetic
// is torch's, operation for operation: the exact int32 gap rounded once
// (__int2float_rn), __fadd_rn, fmaxf, and an IEEE division (__fdiv_rn;
// no fast math). That makes contrib == formula(caches) an invariant, so
// a record whose two endpoints lie outside the move's range is skipped:
// its (new - old) is 0.0. The threshold is rounded as torch rounds it
// (__fmul_rn, __fadd_rn: no contraction into an FMA).
//
// What bounds it on the card: bytes. The function's least work is the
// state of the (individual, record) pairs whose contribution the move
// may change (28 B each), the other touched pairs of an accepted row
// (28 B read, and 28 B written for every touched pair), the records
// (28 B, once per group) and the span of the slot tables. This design
// still finds those pairs by reading the two slots of every pair (8 B,
// 16-byte loads); the rest it does once, in one launch:
//
//   - One cluster of DG_CLUSTER CTAs per row (cudaLaunchKernelEx with a
//     cluster-dimension attribute). Each CTA owns a contiguous range of
//     the row's records and handles its ragged tail itself.
//   - Only the records whose contribution may change are computed for
//     the delta. A record whose two endpoints move with one block (the
//     middle of a swap, the span of an inversion, either block of a
//     rotation) keeps its gap and its orientation combination seen from
//     the first contig, so its (new - old) is exactly 0.0: a move over
//     much of the tour changes the contributions of the few records
//     that cross its edges. Their state still changes; an accepted row
//     writes it at the commit.
//   - Compact, then compute densely, warp by warp. Each warp scans
//     steps of DG_STEP records with 16-byte slot loads (the next two
//     steps' in flight while it works on one), compacts the selected
//     records into its list in shared memory (in record order, by a
//     ballot count and a warp prefix sum), then walks the list with
//     every lane busy. No block barrier stalls the scan: warps run
//     freely, DG_MIN_CTAS CTAs to an SM, so the other warps' loads hide
//     the latency of one warp's scattered state and record loads.
//   - The new states of the records computed for the delta stay in
//     shared memory (DG_KEEP entries): an accepted row writes them back
//     without reading anything again. The commit scans the slots once
//     more for the touched records whose contribution stays, and for
//     every touched record of the steps past that capacity.
//   - The f32 terms (new - old, rounded as torch rounds them) are
//     summed in FP64 and delta is rounded to f32 once, so it lies
//     within half an ulp of the exact sum of the terms whatever order
//     the threads take them in. Each CTA writes its partial sum into
//     every CTA's shared memory (distributed shared memory), and after
//     one cluster barrier every CTA adds them in rank order: all hold
//     the same bits of delta and decide acceptance themselves. No float
//     atomics, no second kernel, no scratch in device memory; GA runs
//     are repeatable.
//   - Rank 0 applies an accepted move to the slot tables in place (a
//     swap, one reversal, or three for a rotation) and rebuilds startsx
//     over the span by a block prefix sum of exact int32 lengths. Every
//     CTA reads its move scalars before the cluster barrier that
//     precedes those writes.
//
// Grid: x = DG_CLUSTER * row + rank, row = g * P + p. The draws mode
// adds no launch: the generation is the draws' launches and this one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DG_THREADS 256
#define DG_WARPS (DG_THREADS / 32)
#define DG_CLUSTER 8
#define DG_STEP 128     // records a warp scans per step (16 B a lane)
#define DG_KEEP 1024    // new states kept per CTA
#define DG_MIN_CTAS 4   // CTAs resident per SM

struct Args {
  int32_t* order; int32_t* ori; int32_t* L; int32_t* startsx;
  int32_t* posA; int32_t* sA; int32_t* oA;
  int32_t* posB; int32_t* sB; int32_t* oB;
  float* contrib; float* scores;
  const uint8_t* mdo; const int32_t* mop; const int32_t* mi;
  const int32_t* mj; const int32_t* mt;
  const int32_t* la; const int32_t* lb; const float* d; const float* w;
  const uint8_t* accept; float* delta; uint8_t* acc;
  // draws mode (u_do != nullptr): the seven draws of each row, and the
  // optional outputs of its move (each nullptr or all five set)
  const float* u_do; const int32_t* dop; const int32_t* e1;
  const int32_t* e2; const int32_t* e3; const float* u_local;
  const float* u_span;
  uint8_t* odo; int32_t* oop; int32_t* oi; int32_t* oj; int32_t* ot;
  int P, k;
  int64_t R, per;  // records, records per CTA (a multiple of 4)
  float min_gain, span_gain, mutprob, local_frac, log_075;
  int vec;
};

// dynamic shared memory: each warp's list of a step's selected records
// (record, slot of A, slot of B) and the kept new states
struct Smem {
  int lidx[DG_WARPS][DG_STEP], lpa[DG_WARPS][DG_STEP],
      lpb[DG_WARPS][DG_STEP];
  int kidx[DG_KEEP], kposA[DG_KEEP], ksA[DG_KEEP], kposB[DG_KEEP],
      ksB[DG_KEEP], ko[DG_KEEP];  // ko = oA | oB << 1
  float kc[DG_KEEP];
};

struct Move {
  int do_, op, i, j, t, Sx, Sy, Lx, Ly, Et;
};

// The move of a row from its draws, operation for operation as the plain
// version (delta.moves_from_draws) makes it: do = u_do < mutprob; a local
// move (u_local < local_frac) spans [e1, min(e1 + span, k - 1)] with the
// geometric span 1 + floor(log(1 - u_span) / log(0.75)), else [min(e1, e2),
// max(e1, e2)]; t = max(j, e3), e3 = j for a local move. 1 - u_span is
// exact or rounded once either way; the quotient is an IEEE division (not
// a multiply by the reciprocal), so floorf sees torch's bits.
__device__ __forceinline__ void move_from_draws(const Args& a, int64_t row,
                                                Move& m) {
  const int e1 = a.e1[row], e2 = a.e2[row];
  int e3 = a.e3[row];
  m.do_ = a.u_do[row] < a.mutprob;
  m.op = a.dop[row];
  m.i = min(e1, e2);
  m.j = max(e1, e2);
  if (a.u_local[row] < a.local_frac) {
    const float q = __fdiv_rn(logf(__fsub_rn(1.0f, a.u_span[row])),
                              a.log_075);
    const int span = 1 + (int)floorf(q);
    m.i = e1;
    m.j = max(min(e1 + span, a.k - 1), e1);
    e3 = m.j;
  }
  m.t = max(m.j, e3);
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

__device__ __forceinline__ bool in_range(int pos, int lo, int hi) {
  return pos >= lo && pos <= hi;
}

// The block of slots an endpoint moves with (0: the move leaves it
// alone). A record whose two endpoints move with one block keeps its
// gap and its orientation combination seen from the first contig, so
// its contribution is bit-identical: the middle of a swap, the span of
// an inversion, either block of a rotation. A flip changes the
// orientation combination of every record it touches.
__device__ __forceinline__ int block_of(int pos, const Move& m, int lo,
                                        int hi) {
  if (!in_range(pos, lo, hi)) return 0;
  if (m.op == 0) return pos == m.i ? 3 : (pos == m.j ? 4 : 1);
  if (m.op == 2) return pos < m.j ? 1 : 2;
  return 1;
}

// whether the record's contribution may change under the move
__device__ __forceinline__ bool changes(int pa, int pb, const Move& m, int lo,
                                        int hi) {
  const int ca = block_of(pa, m, lo, hi);
  const int cb = block_of(pb, m, lo, hi);
  return (ca | cb) != 0 && (m.op == 3 || ca != cb);
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// The slots of 4 records of a step in one lane (16-byte loads when the
// rows are 16-byte aligned); -1, never in a move's range, past r1.
struct Slots {
  int a[4], b[4];
};

__device__ __forceinline__ void load_slots(const Args& a, size_t base,
                                           int64_t r, int64_t r1, Slots& v) {
  if (a.vec) {
    int4 A = make_int4(-1, -1, -1, -1), B = A;
    if (r < r1) {  // r1 is a multiple of 4 here
      A = *reinterpret_cast<const int4*>(a.posA + base + r);
      B = *reinterpret_cast<const int4*>(a.posB + base + r);
    }
    v.a[0] = A.x; v.a[1] = A.y; v.a[2] = A.z; v.a[3] = A.w;
    v.b[0] = B.x; v.b[1] = B.y; v.b[2] = B.z; v.b[3] = B.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = r + e < r1;
      v.a[e] = ok ? a.posA[base + r + e] : -1;
      v.b[e] = ok ? a.posB[base + r + e] : -1;
    }
  }
}

// One listed record: its cached state, its record data, and (after
// update()) its new state and contribution.
struct Rec {
  int r, posA, sA, oA, posB, sB, oB, la, lb;
  float old, d0, d1, d2, d3, w, c;
};

__device__ __forceinline__ void load_rec(const Args& a, const Smem& sm,
                                         int warp, size_t base, size_t rbase,
                                         int n, Rec& x) {
  const int r = sm.lidx[warp][n];
  const size_t e = base + r;
  const size_t q = rbase + r;
  x.r = r;
  x.posA = sm.lpa[warp][n]; x.posB = sm.lpb[warp][n];
  x.sA = a.sA[e]; x.oA = a.oA[e]; x.sB = a.sB[e]; x.oB = a.oB[e];
  x.old = a.contrib[e];
  x.la = __ldg(a.la + q); x.lb = __ldg(a.lb + q);
  const float* dr = a.d + 4 * rbase + r;
  x.d0 = __ldg(dr); x.d1 = __ldg(dr + a.R); x.d2 = __ldg(dr + 2 * a.R);
  x.d3 = __ldg(dr + 3 * a.R);
  x.w = __ldg(a.w + q);
}

__device__ __forceinline__ void update(const Move& m, Rec& x) {
  endpoint_update(x.posA, x.sA, x.oA, x.la, m);
  endpoint_update(x.posB, x.sB, x.oB, x.lb, m);
  x.c = contribution(x.posA, x.sA, x.oA, x.posB, x.sB, x.oB, x.la, x.lb,
                     x.d0, x.d1, x.d2, x.d3, x.w);
}

__device__ __forceinline__ void store_rec(const Args& a, size_t base,
                                          const Rec& x) {
  const size_t e = base + x.r;
  a.posA[e] = x.posA; a.sA[e] = x.sA; a.oA[e] = x.oA;
  a.posB[e] = x.posB; a.sB[e] = x.sB; a.oB[e] = x.oB;
  a.contrib[e] = x.c;
}

// Walks the warp's list of cnt records, one entry a lane at a time.
// COMMIT: writes every new state to device memory. Otherwise adds
// (new - old) to acc, in a fixed order, and keeps the new states in
// shared memory from entry keep_at on (keep_at < 0: not kept).
template <bool COMMIT>
__device__ __forceinline__ double walk(const Args& a, Smem& sm, const Move& m,
                                       int warp, size_t base, size_t rbase,
                                       int cnt, int keep_at, double acc) {
  for (int n = threadIdx.x & 31; n < cnt; n += 32) {
    Rec x;
    load_rec(a, sm, warp, base, rbase, n, x);
    update(m, x);
    if (COMMIT) {
      store_rec(a, base, x);
      continue;
    }
    acc += (double)(x.c - x.old);
    if (keep_at >= 0) {
      const int s = keep_at + n;
      sm.kidx[s] = x.r;
      sm.kposA[s] = x.posA; sm.ksA[s] = x.sA;
      sm.kposB[s] = x.posB; sm.ksB[s] = x.sB;
      sm.ko[s] = x.oA | (x.oB << 1);
      sm.kc[s] = x.c;
    }
  }
  return acc;
}

// Reserves cnt entries of the kept new states (lane 0 of a warp): their
// first index, or -1 when they do not fit.
__device__ __forceinline__ int reserve_keep(int* kcount, int cnt) {
  int old = *reinterpret_cast<volatile int*>(kcount);
  while (old + cnt <= DG_KEEP) {
    const int prev = atomicCAS(kcount, old, old + cnt);
    if (prev == old) return old;
    old = prev;
  }
  return -1;
}

// The steps of DG_STEP records of the CTA's range [r0, r1), from step
// first on, each warp taking every DG_WARPS-th step (the slots of its
// next two steps in flight while it works on one): the records selected are
// compacted into the warp's list in record order (a ballot count and a
// warp prefix sum; no block barrier), then walked with every lane busy.
// Pass 1 (COMMIT false) selects the records whose contribution may
// change, adds their deltas to acc and keeps their new states while
// they fit; a step whose states were not kept lowers *resume to its
// index. The commit (COMMIT true) selects the touched records pass 1
// did not keep (all of them from step *resume on) and writes them.
template <bool COMMIT>
__device__ __forceinline__ double warp_steps(const Args& a, Smem& sm,
                                             const Move& m, size_t base,
                                             size_t rbase, int64_t r0,
                                             int64_t r1, int first, int lo,
                                             int hi, int* kcount, int* resume,
                                             double acc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nsteps = r1 > r0 ? (int)((r1 - r0 + DG_STEP - 1) / DG_STEP) : 0;
  int s = first + ((warp - first % DG_WARPS) + DG_WARPS) % DG_WARPS;
  const int64_t stride = (int64_t)DG_WARPS * DG_STEP;
  const int64_t rs = r0 + (int64_t)s * DG_STEP + 4 * lane;
  Slots cur, nx1, nx2;
  if (s < nsteps) load_slots(a, base, rs, r1, cur);
  if (s + DG_WARPS < nsteps) load_slots(a, base, rs + stride, r1, nx1);
  for (; s < nsteps; s += DG_WARPS) {
    const int64_t r = r0 + (int64_t)s * DG_STEP + 4 * lane;
    if (s + 2 * DG_WARPS < nsteps)
      load_slots(a, base, r + 2 * stride, r1, nx2);
    const bool all = COMMIT && s >= *resume;
    unsigned bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ch = changes(cur.a[e], cur.b[e], m, lo, hi);
      const bool touched =
          in_range(cur.a[e], lo, hi) || in_range(cur.b[e], lo, hi);
      if (COMMIT ? touched && (all || !ch) : ch) bits |= 1u << e;
    }
    const int cnt = __popc(bits);
    const int incl = warp_incl_scan(cnt);
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int o = incl - cnt;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((bits >> e) & 1u) {
        sm.lidx[warp][o] = (int)(r + e);
        sm.lpa[warp][o] = cur.a[e];
        sm.lpb[warp][o] = cur.b[e];
        ++o;
      }
    }
    __syncwarp();
    if (COMMIT) {
      walk<true>(a, sm, m, warp, base, rbase, total, -1, 0.0);
    } else if (total > 0) {
      int keep_at = 0;
      if (lane == 0) {
        keep_at = reserve_keep(kcount, total);
        if (keep_at < 0) atomicMin(resume, s);
      }
      keep_at = __shfl_sync(0xffffffffu, keep_at, 0);
      acc = walk<false>(a, sm, m, warp, base, rbase, total, keep_at, acc);
    }
    __syncwarp();  // the list is free again
    cur = nx1;
    nx1 = nx2;
  }
  return acc;
}

// Reverses slots [p0, q0] of order, ori and L_slot in place (flipping
// the orientations when flip), one pair of slots a thread.
__device__ __forceinline__ void reverse_slots(int32_t* ord, int32_t* ori,
                                              int32_t* L, int p0, int q0,
                                              bool flip) {
  const int n = q0 - p0 + 1;
  for (int x = threadIdx.x; x < (n + 1) / 2; x += DG_THREADS) {
    const int p = p0 + x, q = q0 - x;
    const int cp = ord[p], cq = ord[q], rp = ori[p], rq = ori[q];
    const int lp = L[p], lq = L[q];
    ord[p] = cq; ord[q] = cp;
    L[p] = lq; L[q] = lp;
    ori[p] = flip ? 1 - rq : rq;
    ori[q] = flip ? 1 - rp : rp;
  }
}

// The accepted move applied to the row's slot tables in place (rank 0,
// every thread): new[idx] = old[src[idx]] as _move_src gives src, the
// span's orientations flipped for an inversion or a flip, and
// startsx[i+1 .. hi+1] rebuilt as startsx[i] plus the exact int32
// prefix sums of the new lengths (slots outside the span keep theirs).
__device__ void permute_slots(const Args& a, int64_t row, const Move& m,
                              int* wtot) {
  int32_t* ord = a.order + row * a.k;
  int32_t* ori = a.ori + row * a.k;
  int32_t* L = a.L + row * a.k;
  int32_t* S = a.startsx + row * (a.k + 1);
  int hi;
  if (m.op == 0) {
    if (threadIdx.x == 0 && m.i != m.j) {
      const int ci = ord[m.i], ri = ori[m.i], li = L[m.i];
      ord[m.i] = ord[m.j]; ori[m.i] = ori[m.j]; L[m.i] = L[m.j];
      ord[m.j] = ci; ori[m.j] = ri; L[m.j] = li;
    }
    hi = m.j;
  } else if (m.op == 1) {
    reverse_slots(ord, ori, L, m.i, m.j, true);
    hi = m.j;
  } else if (m.op == 2) {
    // left rotation of [i, t) by j - i: reverse [i, j) and [j, t), then
    // [i, t)
    reverse_slots(ord, ori, L, m.i, m.j - 1, false);
    reverse_slots(ord, ori, L, m.j, m.t - 1, false);
    __syncthreads();
    reverse_slots(ord, ori, L, m.i, m.t - 1, false);
    hi = m.t - 1;
  } else {
    if (m.op == 3)
      for (int x = m.i + threadIdx.x; x <= m.j; x += DG_THREADS)
        ori[x] = 1 - ori[x];
    return;  // lengths unchanged
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = S[m.i];
  for (int c0 = m.i; c0 <= hi; c0 += DG_THREADS) {
    const int x = c0 + threadIdx.x;
    const int incl = warp_incl_scan(x <= hi ? L[x] : 0);
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();
    int before = 0, tot = 0;
#pragma unroll
    for (int w2 = 0; w2 < DG_WARPS; ++w2) {
      const int s = wtot[w2];
      tot += s;
      if (w2 < warp) before += s;
    }
    if (x <= hi) S[x + 1] = carry + before + incl;
    carry += tot;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(DG_THREADS, DG_MIN_CTAS)
delta_generation_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dg_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dg_smem);
  __shared__ int wtot[DG_WARPS];
  __shared__ int kcount, resume;
  __shared__ double red[DG_WARPS];
  __shared__ double parts[DG_CLUSTER];  // the cluster's partial sums
  __shared__ double s_part;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / DG_CLUSTER;
  const int64_t g = row / a.P;
  const int tid = threadIdx.x;
  if (tid == 0) {
    kcount = 0;
    resume = INT_MAX;  // first step whose new states were not kept
  }
  __syncthreads();

  Move m;
  if (a.u_do) {
    move_from_draws(a, row, m);
  } else {
    m.do_ = a.mdo[row] != 0;
    m.op = a.mop[row]; m.i = a.mi[row]; m.j = a.mj[row]; m.t = a.mt[row];
  }
  m.Sx = m.Sy = m.Lx = m.Ly = m.Et = 0;
  if (m.do_) {
    const int32_t* S = a.startsx + row * (a.k + 1);
    m.Sx = S[m.i];
    m.Lx = S[m.i + 1] - m.Sx;
    m.Sy = S[m.j];
    m.Ly = S[m.j + 1] - m.Sy;
    m.Et = S[m.t];
  }
  const float score = a.scores[row];
  int lo, hi;
  move_range(m, lo, hi);
  const size_t base = (size_t)row * (size_t)a.R;
  const size_t rbase = (size_t)g * (size_t)a.R;
  const int64_t r0 = (int64_t)rank * a.per;
  const int64_t r1 = min(a.R, r0 + a.per);

  // pass 1: the delta of this CTA's records
  double acc = 0.0;
  if (hi >= lo)
    acc = warp_steps<false>(a, sm, m, base, rbase, r0, r1, 0, lo, hi,
                            &kcount, &resume, acc);
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w2 = 0; w2 < DG_WARPS; ++w2) s += red[w2];
    s_part = s;
  }
  float delta = 0.0f;
  if (hi >= lo) {  // the same for every CTA of the cluster
    __syncthreads();
    // each CTA writes its partial into every CTA's shared memory; after
    // the barrier no CTA touches another's, so none waits to leave.
    // The barrier also follows every CTA's reads of its move scalars
    // and score.
    if (tid < DG_CLUSTER)
      *cluster.map_shared_rank(&parts[rank], (unsigned)tid) = s_part;
    cluster.sync();
    double s = 0.0;
    for (int r = 0; r < DG_CLUSTER; ++r) s += parts[r];
    delta = __double2float_rn(s);
  }
  const float spanv = __int2float_rn(m.op == 2 ? m.t - m.i : m.j - m.i);
  const float thr = __fmul_rn(
      score, __fadd_rn(__fmul_rn(spanv, a.span_gain), a.min_gain));
  const bool accepted = a.accept ? a.accept[row] != 0 : delta > thr;

  // pass 2: the commit of an accepted row. The touched records pass 1
  // did not keep (those whose contribution stays, and every one from
  // step resume on) are computed from their unchanged state and
  // written; then the kept states of the steps before resume go back
  // as they are (after a barrier: the scan must read the old slots).
  if (accepted && hi >= lo) {
    // a flip's delta pass computed every touched record
    const int first = m.op == 3 ? resume : 0;
    if (first != INT_MAX)
      warp_steps<true>(a, sm, m, base, rbase, r0, r1, first, lo, hi,
                       &kcount, &resume, 0.0);
    __syncthreads();
    for (int n = tid; n < kcount; n += DG_THREADS) {
      const int r = sm.kidx[n];
      if ((r - r0) / DG_STEP >= resume) continue;
      const size_t e = base + r;
      a.posA[e] = sm.kposA[n]; a.sA[e] = sm.ksA[n]; a.oA[e] = sm.ko[n] & 1;
      a.posB[e] = sm.kposB[n]; a.sB[e] = sm.ksB[n]; a.oB[e] = sm.ko[n] >> 1;
      a.contrib[e] = sm.kc[n];
    }
  }
  if (rank == 0) {
    if (accepted && m.do_) permute_slots(a, row, m, wtot);
    if (tid == 0) {
      a.delta[row] = delta;
      a.acc[row] = accepted ? 1 : 0;
      if (accepted) a.scores[row] = __fadd_rn(score, delta);
      if (a.odo) {
        a.odo[row] = m.do_ ? 1 : 0;
        a.oop[row] = m.op; a.oi[row] = m.i; a.oj[row] = m.j; a.ot[row] = m.t;
      }
    }
  }
}

// The state's pointers, shapes and settings common to both modes; the
// move (or the draws) and the outputs are set by the caller.
static int fill_args(Args& a, void* order, void* ori, void* L, void* startsx,
                     void* posA, void* sA, void* oA, void* posB, void* sB,
                     void* oB, void* contrib, void* scores, const void* la,
                     const void* lb, const void* d, const void* w,
                     void* delta, void* acc, int G, int P, int k, int64_t R,
                     float min_gain, float span_gain, int vec) {
  const int64_t rows = (int64_t)G * P;
  if (G < 1 || P < 1 || k < 1 || R < 0 || R > INT_MAX || (vec && R % 4) ||
      rows * DG_CLUSTER > INT_MAX)
    return (int)cudaErrorInvalidValue;
  a = Args{};
  a.order = static_cast<int32_t*>(order);
  a.ori = static_cast<int32_t*>(ori);
  a.L = static_cast<int32_t*>(L);
  a.startsx = static_cast<int32_t*>(startsx);
  a.posA = static_cast<int32_t*>(posA);
  a.sA = static_cast<int32_t*>(sA);
  a.oA = static_cast<int32_t*>(oA);
  a.posB = static_cast<int32_t*>(posB);
  a.sB = static_cast<int32_t*>(sB);
  a.oB = static_cast<int32_t*>(oB);
  a.contrib = static_cast<float*>(contrib);
  a.scores = static_cast<float*>(scores);
  a.la = static_cast<const int32_t*>(la);
  a.lb = static_cast<const int32_t*>(lb);
  a.d = static_cast<const float*>(d);
  a.w = static_cast<const float*>(w);
  a.delta = static_cast<float*>(delta);
  a.acc = static_cast<uint8_t*>(acc);
  a.P = P;
  a.k = k;
  a.R = R;
  a.per = ((R + DG_CLUSTER - 1) / DG_CLUSTER + 3) / 4 * 4;
  a.min_gain = min_gain;
  a.span_gain = span_gain;
  a.vec = vec;
  return 0;
}

static int launch(const Args& a, int G, void* stream) {
  const int64_t rows = (int64_t)G * a.P;
  const size_t smem = sizeof(Smem);
  static bool smem_attr_set = false;
  cudaError_t e;
  if (!smem_attr_set) {
    e = cudaFuncSetAttribute(delta_generation_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DG_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * DG_CLUSTER), 1, 1);
  cfg.blockDim = dim3(DG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, delta_generation_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Move mode: the move (do, op, i, j, t) given; accept optional.
extern "C" int delta_generation_launch(
    void* order, void* ori, void* L, void* startsx, void* posA, void* sA,
    void* oA, void* posB, void* sB, void* oB, void* contrib, void* scores,
    const void* mdo, const void* mop, const void* mi, const void* mj,
    const void* mt, const void* la, const void* lb, const void* d,
    const void* w, const void* accept, void* delta, void* acc, int G, int P,
    int k, int64_t R, float min_gain, float span_gain, int vec,
    void* stream) {
  Args a;
  const int err = fill_args(a, order, ori, L, startsx, posA, sA, oA, posB,
                            sB, oB, contrib, scores, la, lb, d, w, delta,
                            acc, G, P, k, R, min_gain, span_gain, vec);
  if (err) return err;
  a.mdo = static_cast<const uint8_t*>(mdo);
  a.mop = static_cast<const int32_t*>(mop);
  a.mi = static_cast<const int32_t*>(mi);
  a.mj = static_cast<const int32_t*>(mj);
  a.mt = static_cast<const int32_t*>(mt);
  a.accept = static_cast<const uint8_t*>(accept);
  return launch(a, G, stream);
}

// Draws mode: the seven draws u_do, op, e1, e2, e3, u_local, u_span of
// each row; the move written to odo, oop, oi, oj, ot where odo is set.
extern "C" int delta_generation_draws_launch(
    void* order, void* ori, void* L, void* startsx, void* posA, void* sA,
    void* oA, void* posB, void* sB, void* oB, void* contrib, void* scores,
    const void* u_do, const void* dop, const void* e1, const void* e2,
    const void* e3, const void* u_local, const void* u_span, const void* la,
    const void* lb, const void* d, const void* w, void* delta, void* acc,
    void* odo, void* oop, void* oi, void* oj, void* ot, int G, int P, int k,
    int64_t R, float min_gain, float span_gain, float mutprob,
    float local_frac, float log_075, int vec, void* stream) {
  Args a;
  const int err = fill_args(a, order, ori, L, startsx, posA, sA, oA, posB,
                            sB, oB, contrib, scores, la, lb, d, w, delta,
                            acc, G, P, k, R, min_gain, span_gain, vec);
  if (err) return err;
  if (!u_do || !dop || !e1 || !e2 || !e3 || !u_local || !u_span ||
      (odo && (!oop || !oi || !oj || !ot)))
    return (int)cudaErrorInvalidValue;
  a.u_do = static_cast<const float*>(u_do);
  a.dop = static_cast<const int32_t*>(dop);
  a.e1 = static_cast<const int32_t*>(e1);
  a.e2 = static_cast<const int32_t*>(e2);
  a.e3 = static_cast<const int32_t*>(e3);
  a.u_local = static_cast<const float*>(u_local);
  a.u_span = static_cast<const float*>(u_span);
  a.odo = static_cast<uint8_t*>(odo);
  a.oop = static_cast<int32_t*>(oop);
  a.oi = static_cast<int32_t*>(oi);
  a.oj = static_cast<int32_t*>(oj);
  a.ot = static_cast<int32_t*>(ot);
  a.mutprob = mutprob;
  a.local_frac = local_frac;
  a.log_075 = log_075;
  return launch(a, G, stream);
}

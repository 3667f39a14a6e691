"""Delta generation of the device GA: the per-record work of one greedy
generation, as the CUDA kernel's wrapper and its plain torch version.

Counterpart of ``dgen`` in ``_evolve_delta_impl``
(haphic_tpu/order/optimize.py:824), which is jitted XLA, not Pallas.
One generation proposes one move per (group, individual); this module
scores every move as an explicit delta over the CLM records and commits
the accepted ones. Move sampling, the move scalars and the slot tables
(order, ori, L_slot, startsx) stay in ``order/optimize.py``: they are
(G, P) or (G, P, k) work. Shapes, batched over groups G:

    caches   int32 (G, P, R) x6  posA, sA, oA, posB, sB, oB: slot, exact
                                 start offset and orientation of each
                                 record's two contigs in each tour
    contrib  f32   (G, P, R)     carried per-record score contributions
    move     int32 (G, P) x10    do, op, i, j, t, Sx, Sy, Lx, Ly, Et
    thr      f32   (G, P)        acceptance threshold of each move
    la, lb   int32 (G, R)        record endpoint lengths
    d        f32   (G, 4, R)     orientation-combination distances
    w        f32   (G, R)        record weights (0 for padding)
    -> delta f32 (G, P), acc bool (G, P); the caches and ``contrib``
       of accepted rows are updated in place.

``delta_generation`` runs the kernel for CUDA tensors and the plain
version for CPU tensors; nothing else picks the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from haphic_tpu_torch.kernels import build as kbuild

# records one block of the kernel streams (see csrc/delta_generation.cu)
RECORDS_PER_BLOCK = 8192


def contrib_from_cache(posA, sA, oA, posB, sB, oB, la, lb, d, w):
    """Per-record score contributions (G, P, R) from cached endpoint
    state: posA/posB int32 slots, sA/sB EXACT int32 start offsets (f32
    offsets carry ulp ~64 bp at chromosome scale and broke the delta
    hill climb in the JAX package), oA/oB int32 orientations, la/lb
    int32 (G, R) contig lengths, d f32 (G, 4, R), w f32 (G, R). The gap
    is exact; only the final f32 conversion rounds."""
    a_first = posA < posB
    gap = torch.where(a_first, sB - (sA + la[:, None]),
                      sA - (sB + lb[:, None])).to(torch.float32)
    combo = 2 * oA + oB
    combo = torch.where(a_first, combo, 3 - combo)
    dd = d[:, None]
    dval = torch.where(combo == 0, dd[:, :, 0],
                       torch.where(combo == 1, dd[:, :, 1],
                                   torch.where(combo == 2, dd[:, :, 2],
                                               dd[:, :, 3])))
    dist = torch.clamp(gap + dval, min=1.0)
    return w[:, None] / dist


def endpoint_update(pos, s, o, le, do, op, i, j, t, Sx, Sy, Lx, Ly, Et):
    """Closed-form update of one record endpoint under one move.

    pos/s/o: cached slot / start / orientation (G, P, R); le (G, R) the
    endpoint contig's length. Scalars (G, P): Sx/Sy = starts of slots
    i/j, Lx/Ly = lengths at slots i/j, Et = start of slot t.
      swap i<->j: slot i keeps start Sx (now holds contig Y); contig X
        lands at start Sy + Ly - Lx; middle slots shift by Ly - Lx.
      inversion [i,j]: slot of contig c -> i + j - pos; its start ->
        Sx + (Sy + Ly) - s - len(c); orientation flips.
      rotation [i,t) by r=j-i: block A=[i,j) (length W = Sy - Sx)
        moves right by t - j and +(Et - Sy); block B=[j,t) moves left
        by j - i and -W.
      flip [i,j]: orientation flips in the span.
    """
    i_, j_, t_ = i[..., None], j[..., None], t[..., None]
    Sx_, Sy_ = Sx[..., None], Sy[..., None]
    dL = (Ly - Lx)[..., None]
    Ej_ = (Sy + Ly)[..., None]
    Et_ = Et[..., None]
    op_ = op[..., None]
    le_ = le[:, None, :]

    is_i = pos == i_
    is_j = pos == j_
    mid = (pos > i_) & (pos < j_)
    in_ij = (pos >= i_) & (pos <= j_)
    in_rot = (pos >= i_) & (pos < t_)
    in_a = (pos >= i_) & (pos < j_)

    # swap
    pos_sw = torch.where(is_i, j_, torch.where(is_j, i_, pos))
    s_sw = torch.where(is_i, Sy_ + dL,
                       torch.where(is_j, Sx_,
                                   torch.where(mid, s + dL, s)))
    # inversion
    pos_inv = torch.where(in_ij, i_ + j_ - pos, pos)
    s_inv = torch.where(in_ij, Sx_ + Ej_ - s - le_, s)
    o_flip = torch.where(in_ij, 1 - o, o)
    # rotation
    pos_rot = torch.where(in_a, pos + (t_ - j_),
                          torch.where(in_rot, pos - (j_ - i_), pos))
    s_rot = torch.where(in_a, s + (Et_ - Sy_),
                        torch.where(in_rot, s - (Sy_ - Sx_), s))

    pos_n = torch.where(op_ == 0, pos_sw,
                        torch.where(op_ == 1, pos_inv,
                                    torch.where(op_ == 2, pos_rot, pos)))
    s_n = torch.where(op_ == 0, s_sw,
                      torch.where(op_ == 1, s_inv,
                                  torch.where(op_ == 2, s_rot, s)))
    o_n = torch.where((op_ == 1) | (op_ == 3), o_flip, o)
    keep = ~do[..., None]
    return (torch.where(keep, pos, pos_n),
            torch.where(keep, s, s_n),
            torch.where(keep, o, o_n))


def delta_generation_plain(caches, contrib, move, thr, la, lb, d, w,
                           accept=None):
    """The same function in plain torch ops: both endpoints of every
    record updated, the new contributions, delta = sum(new - old) per
    row (unaffected records give exactly 0.0: the same arithmetic on
    the same bits), acceptance ``delta > thr`` (or the given mask), and
    the accepted rows written back in place."""
    posA, sA, oA, posB, sB, oB = caches
    new = (endpoint_update(posA, sA, oA, la, *move)
           + endpoint_update(posB, sB, oB, lb, *move))
    new_c = contrib_from_cache(*new, la, lb, d, w)
    delta = (new_c - contrib).sum(dim=2)
    acc = delta > thr if accept is None else accept
    a_ = acc[..., None]
    for old, upd in zip(tuple(caches) + (contrib,), new + (new_c,)):
        torch.where(a_, upd, old, out=old)
    return delta, acc


@functools.lru_cache(maxsize=None)
def _fns():
    lib = kbuild.load('delta_generation')
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.delta_scores_launch.argtypes = [vp] * 15 + [i32, i32, i64, i64,
                                                    i32, i32, vp]
    lib.delta_scores_launch.restype = ctypes.c_int
    lib.delta_commit_launch.argtypes = [vp] * 14 + [i32, i32, i64, i64,
                                                    i32, i32, vp]
    lib.delta_commit_launch.restype = ctypes.c_int
    return lib.delta_scores_launch, lib.delta_commit_launch


def _check(caches, contrib, move, thr, la, lb, d, w, accept):
    G, P, R = contrib.shape
    want = [(c, torch.int32, (G, P, R)) for c in caches]
    want += [(contrib, torch.float32, (G, P, R))]
    want += [(m, torch.int32, (G, P)) for m in move[1:]]
    want += [(move[0], torch.bool, (G, P)), (thr, torch.float32, (G, P)),
             (la, torch.int32, (G, R)), (lb, torch.int32, (G, R)),
             (d, torch.float32, (G, 4, R)), (w, torch.float32, (G, R))]
    if accept is not None:
        want.append((accept, torch.bool, (G, P)))
    if len(caches) != 6 or len(move) != 10:
        raise ValueError('want 6 caches and 10 move fields')
    for n, (t, dtype, shape) in enumerate(want):
        if t.device != contrib.device:
            raise ValueError('input {} is on {}, contrib on {}'.format(
                n, t.device, contrib.device))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('input {}: want {} {}, got {} {}'.format(
                n, dtype, shape, t.dtype, tuple(t.shape)))
    for n, t in enumerate(tuple(caches) + (contrib, la, lb, d, w)):
        if not t.is_contiguous():
            raise ValueError('input {} must be contiguous'.format(n))


def delta_generation(caches, contrib, move, thr, la, lb, d, w,
                     accept=None):
    """(delta, acc) of one delta generation; accepted rows' caches and
    contributions are updated in place. The CUDA kernel on CUDA tensors,
    the plain version on CPU tensors. ``accept`` replaces the threshold
    test with a given mask (``thr`` is then unused)."""
    _check(caches, contrib, move, thr, la, lb, d, w, accept)
    dev = contrib.device
    if dev.type == 'cpu':
        return delta_generation_plain(caches, contrib, move, thr, la, lb,
                                      d, w, accept)
    if dev.type != 'cuda':
        raise ValueError('unsupported device {}'.format(dev))
    G, P, R = contrib.shape
    packed = torch.stack([move[0].to(torch.int32)] + list(move[1:]),
                         dim=-1).contiguous()
    nchunks = max(1, -(-R // RECORDS_PER_BLOCK))
    vec = int(R % 4 == 0 and all(c.data_ptr() % 16 == 0
                                 for c in (caches[0], caches[3])))
    partial = torch.empty((G, P, nchunks), dtype=torch.float32, device=dev)
    touched = torch.empty((G, P, nchunks), dtype=torch.uint8, device=dev)
    delta = torch.empty((G, P), dtype=torch.float32, device=dev)
    scores_fn, commit_fn = _fns()
    ptrs = [c.data_ptr() for c in caches] + [
        contrib.data_ptr(), la.data_ptr(), lb.data_ptr(), d.data_ptr(),
        w.data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = scores_fn(packed.data_ptr(), *ptrs, partial.data_ptr(),
                        touched.data_ptr(), delta.data_ptr(), G, P, R,
                        RECORDS_PER_BLOCK, nchunks, vec, stream)
        if err != 0:
            raise RuntimeError('delta_generation scores kernel launch '
                               'failed: CUDA error {}'.format(err))
        acc = (delta > thr if accept is None else accept).contiguous()
        err = commit_fn(packed.data_ptr(), acc.data_ptr(),
                        touched.data_ptr(), *ptrs, G, P, R,
                        RECORDS_PER_BLOCK, nchunks, vec, stream)
        if err != 0:
            raise RuntimeError('delta_generation commit kernel launch '
                               'failed: CUDA error {}'.format(err))
    delta_generation.launches += 1
    return delta, acc


delta_generation.launches = 0

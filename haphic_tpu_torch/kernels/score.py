"""Population tour scorer: the CUDA kernel's wrapper and its plain
torch version.

Counterpart of haphic_tpu/order/optimize.py ``_score_stacked_pallas``
(Pallas body ``_score_kernel``, tables from ``_build_tables``) and of
the XLA scorer ``_score_population`` / ``_score_batched`` that computes
the same function. Shapes, batched over groups G:

    order, ori  int32 (G, P, k)    tour slots -> contig, orientation
    lengths     int64 (G, k)       contig lengths (0 for k padding)
    pa, pb      int32 (G, R)       record endpoints (local contig ids)
    d           f32   (G, 4, R)    orientation-combination distances
    w           f32   (G, R)       record weights (0 for padding)
    -> scores   f32   (G, P)

``score_population`` runs the kernel for CUDA tensors and the plain
version for CPU tensors; nothing else picks the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from haphic_tpu_torch.kernels import build as kbuild

# the JAX scorer's chunk: the plain version sums records in chunks of
# this size so its intermediates stay O(G * P * chunk)
PLAIN_CHUNK = 1 << 14
# kernel geometry (see csrc/score_population.cu)
TILE_MAX = 16                 # individuals per block (SCORE_TILE_MAX)
SMEM_TILE_BYTES = 56 * 1024   # table bytes per block: ~4 blocks per SM
SMEM_MAX_BYTES = 200 * 1024   # under the 227 KB a block may use
RECORDS_PER_BLOCK = 4096      # records one block streams
MAX_P = 256


def build_tables(order, ori, lengths):
    """Per-contig tables of every tour: (slot of contig int32, start
    offset f32, orientation int32), each (G, P, k), plus the lengths as
    f32 (G, k). Starts are the f32 cumsum of the slot lengths as in
    _score_population (optimize.py:296-303); the permutation inverse is
    a scatter."""
    G, P, k = order.shape
    Lf = lengths.to(torch.float32)
    idx = order.long()
    L_slot = torch.gather(Lf[:, None, :].expand(G, P, k), 2, idx)
    starts = torch.cumsum(L_slot, dim=2) - L_slot
    slots = torch.arange(k, dtype=torch.int32, device=order.device)
    pos_of = torch.empty_like(order).scatter_(
        2, idx, slots.expand(G, P, k).contiguous())
    start_of = torch.empty_like(starts).scatter_(2, idx, starts)
    ori_of = torch.empty_like(ori).scatter_(2, idx, ori)
    return pos_of, start_of, ori_of, Lf


def score_population_plain(order, ori, lengths, pa, pb, d, w,
                           chunk: int = PLAIN_CHUNK):
    """The same function in plain torch ops (records in chunks)."""
    G, P, k = order.shape
    R = pa.shape[1]
    pos_of, start_of, ori_of, Lf = build_tables(order, ori, lengths)
    total = torch.zeros((G, P), dtype=torch.float32, device=order.device)
    for r0 in range(0, R, chunk):
        a = pa[:, r0:r0 + chunk].long()
        b = pb[:, r0:r0 + chunk].long()
        n = a.shape[1]
        ia = a[:, None, :].expand(G, P, n)
        ib = b[:, None, :].expand(G, P, n)
        pos_a = torch.gather(pos_of, 2, ia)
        pos_b = torch.gather(pos_of, 2, ib)
        sa = torch.gather(start_of, 2, ia)
        sb = torch.gather(start_of, 2, ib)
        oa = torch.gather(ori_of, 2, ia)
        ob = torch.gather(ori_of, 2, ib)
        la = torch.gather(Lf, 1, a)[:, None, :]
        lb = torch.gather(Lf, 1, b)[:, None, :]
        a_first = pos_a < pos_b
        gap = torch.where(a_first, sb - (sa + la), sa - (sb + lb))
        combo = 2 * oa + ob
        combo = torch.where(a_first, combo, 3 - combo)
        dval = torch.gather(
            d[:, :, r0:r0 + chunk][:, None].expand(G, P, 4, n), 2,
            combo.long()[:, :, None, :])[:, :, 0]
        dist = torch.clamp(gap + dval, min=1.0)
        total += (w[:, None, r0:r0 + chunk] / dist).sum(dim=2)
    return total


@functools.lru_cache(maxsize=None)
def _fn():
    lib = kbuild.load('score_population')
    fn = lib.score_population_launch
    vp = ctypes.c_void_p
    fn.argtypes = [vp] * 10 + [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               vp]
    fn.restype = ctypes.c_int
    return fn


def _geometry(P: int, k: int):
    """(tile, use_smem): individuals per block and whether their tables
    sit in shared memory. Tiles fill SMEM_TILE_BYTES; a single tour's
    tables past that still use shared memory up to SMEM_MAX_BYTES, and
    past that are read from global memory (L2)."""
    per = 12 * k
    tile = min(TILE_MAX, P, max(1, SMEM_TILE_BYTES // per))
    return tile, int(tile * per <= SMEM_MAX_BYTES)


def _check(order, ori, lengths, pa, pb, d, w):
    G, P, k = order.shape
    R = pa.shape[1]
    want = [(order, torch.int32, (G, P, k)), (ori, torch.int32, (G, P, k)),
            (lengths, torch.int64, (G, k)), (pa, torch.int32, (G, R)),
            (pb, torch.int32, (G, R)), (d, torch.float32, (G, 4, R)),
            (w, torch.float32, (G, R))]
    names = ('order', 'ori', 'lengths', 'pa', 'pb', 'd', 'w')
    for name, (t, dtype, shape) in zip(names, want):
        if t.device != order.device:
            raise ValueError('{} is on {}, order on {}'.format(
                name, t.device, order.device))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('{}: want {} {}, got {} {}'.format(
                name, dtype, shape, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if P > MAX_P:
        raise ValueError('population {} exceeds {}'.format(P, MAX_P))


def score_population(order, ori, lengths, pa, pb, d, w):
    """(G, P) tour scores: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(order, ori, lengths, pa, pb, d, w)
    dev = order.device
    if dev.type == 'cpu':
        return score_population_plain(order, ori, lengths, pa, pb, d, w)
    if dev.type != 'cuda':
        raise ValueError('unsupported device {}'.format(dev))
    G, P, k = order.shape
    R = pa.shape[1]
    pos_of, start_of, ori_of, Lf = build_tables(order, ori, lengths)
    tile, use_smem = _geometry(P, k)
    nchunks = max(1, -(-R // RECORDS_PER_BLOCK))
    partial = torch.empty((G, P, nchunks), dtype=torch.float32, device=dev)
    out = torch.empty((G, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(pos_of.data_ptr(), start_of.data_ptr(),
                    ori_of.data_ptr(), Lf.data_ptr(), pa.data_ptr(),
                    pb.data_ptr(), d.data_ptr(), w.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), G, P, k, R, tile,
                    RECORDS_PER_BLOCK, nchunks, use_smem, stream)
    if err != 0:
        raise RuntimeError('score_population kernel launch failed: CUDA '
                           'error {}'.format(err))
    score_population.launches += 1
    return out


score_population.launches = 0

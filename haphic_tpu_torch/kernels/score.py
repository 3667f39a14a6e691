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
TILE_MAX = 32                   # tours per block (SCORE_TILE_MAX)
STAGE = 1024                    # records per staged chunk (SCORE_STAGE)
SMEM_BYTES = 232448             # shared memory a block may use (227 KB)
# table bytes per block: what the two record stages (2 x 7 x STAGE x 4
# bytes) and the static per-warp reduction buffer and barriers leave
TABLE_BUDGET = SMEM_BYTES - 2 * 7 * STAGE * 4 - 4096 - 64
MAX_P = 256


def build_tables(order, ori, lengths):
    """Per-contig tables of every tour: (slot of contig int32, start
    offset f32, orientation int32), each (G, P, k), plus the lengths as
    f32 (G, k). Starts are the exact int64 prefix sums of the slot
    lengths, rounded once to f32: the values the kernel builds in its
    prologue (the XLA scorer's f32 cumsum, optimize.py:296-303, is the
    same below 2^24 bp); the permutation inverse is a scatter."""
    G, P, k = order.shape
    idx = order.long()
    L_slot = torch.gather(lengths[:, None, :].expand(G, P, k), 2, idx)
    starts = (torch.cumsum(L_slot, dim=2) - L_slot).to(torch.float32)
    slots = torch.arange(k, dtype=torch.int32, device=order.device)
    pos_of = torch.empty_like(order).scatter_(
        2, idx, slots.expand(G, P, k).contiguous())
    start_of = torch.empty_like(starts).scatter_(2, idx, starts)
    ori_of = torch.empty_like(ori).scatter_(2, idx, ori)
    return pos_of, start_of, ori_of, lengths.to(torch.float32)


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
    fn.argtypes = [vp] * 9 + [ctypes.c_int64, vp, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def _geometry(P: int, k: int):
    """(tile, smem_table): tours per block and whether their tables are
    copied into shared memory. The kernel lays a tile's tables out
    contig-major over the tile padded to a multiple of 4 tours; a tile
    holds as many such groups as TABLE_BUDGET fits (at most TILE_MAX
    tours), balanced over the population. Past one group of 4, the
    block reads the tables from device memory (L2), where the kernel's
    table pass builds them in every case."""
    fit = TABLE_BUDGET // (8 * k) // 4 * 4
    cap = min(fit, TILE_MAX) if fit >= 4 else TILE_MAX
    tile = -(-P // -(-P // cap))
    return tile, int(fit >= 4)


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
    if R % 4:
        # bulk copies move 16-byte multiples: pad with zero-weight
        # records (pa = pb = 0, d = 0), which add exactly 0.0
        pad = 4 - R % 4
        pa, pb, d, w = [torch.nn.functional.pad(x, (0, pad))
                        for x in (pa, pb, d, w)]
        R += pad
    pa, pb, d, w = [x if x.data_ptr() % 16 == 0 else x.clone()
                    for x in (pa, pb, d, w)]
    tile, smem_table = _geometry(P, k)
    max_chunks = max(1, -(-R // STAGE))
    partial = torch.empty((G, P, max_chunks), dtype=torch.float32,
                          device=dev)
    pad = -(-tile // 4) * 4
    gtab = torch.empty((G, -(-P // tile), k, pad), dtype=torch.int64,
                       device=dev)                         # the tables
    out = torch.empty((G, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn()(order.data_ptr(), ori.data_ptr(), lengths.data_ptr(),
                    gtab.data_ptr(),
                    pa.data_ptr(), pb.data_ptr(), d.data_ptr(),
                    w.data_ptr(), partial.data_ptr(), max_chunks,
                    out.data_ptr(), G, P, k, R, tile, smem_table, stream)
    if err != 0:
        raise RuntimeError('score_population kernel launch failed: CUDA '
                           'error {}'.format(err))
    score_population.launches += 1
    return out


score_population.launches = 0

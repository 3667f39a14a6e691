"""The GA cycle's rescoring of a population: the CUDA kernel's wrapper
and its plain torch version.

Counterpart of ``scores_of`` in ``_evolve_delta_impl``
(haphic_tpu/order/optimize.py:911-919, jitted XLA, not Pallas):
``_build_caches`` (:685) and ``_contrib_from_cache`` (:659), then each
row's sum. ``cycle`` (:921) calls it three times per cycle: on the
parents, on the offspring and on the selected population. Shapes,
batched over groups G:

    order, ori  int32 (G, P, k)    tour slots -> contig, orientation (0/1)
    lengths     int64 (G, k)       contig lengths (0 for k padding)
    pa, pb      int32 (G, R)       record endpoints (local contig ids)
    la, lb      int32 (G, R)       their contig lengths
    d           f32   (G, 4, R)    orientation-combination distances
    w           f32   (G, R)       record weights (0 for padding)
    -> scores   f32   (G, P)                       (caches=False)
    -> (L_slot int32 (G, P, k), startsx int32 (G, P, k+1), posA, sA, oA,
        posB, sB, oB int32 (G, P, R), contrib f32 (G, P, R), scores)
                                                   (caches=True)

``rescore`` launches the CUDA kernel (csrc/rescore_population.cu) on
CUDA tensors, one launch a call, and runs ``rescore_plain`` on CPU
tensors; nothing else picks the plain version. The caches and
contributions of both are the same bits; a kernel score is the f64 sum
of the row's f32 contributions in a fixed order, rounded once, and its
bits do not depend on the groups launched beside it nor on the mode
(the plain version sums one group at a time in f32, ``group_sums``).

The kernel's launch plan is set up once per shape and device (``plan``)
and its workspace (per-tile arrival counters, left at 0 by every call,
and the rows' f64 partials) is kept per device (``_WORK``): two calls
must not run at once on two streams of one device. The GA makes its
calls on one stream, and a mesh has one process a rank.

What bounds it (tools/kernelkit.py): in scores mode the operations,
about 19 FP32 operations per (tour, record) pair; in caches mode the
bytes, 28 written per pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from haphic_tpu_torch.kernels import build as kbuild
from haphic_tpu_torch.kernels.delta import contrib_from_cache


def inverse(order: torch.Tensor) -> torch.Tensor:
    """pos_of[..., c] = slot of contig c (scatter of the slot ids)."""
    k = order.shape[-1]
    slots = torch.arange(k, dtype=order.dtype, device=order.device)
    return torch.empty_like(order).scatter_(
        -1, order.long(), slots.expand(order.shape).contiguous())


def build_caches(order, ori, lengths, pa, pb):
    """Per-record endpoint caches + slot tables from the population.
    Returns (L_slot (G,P,k) int32, startsx (G,P,k+1) int32 slot starts
    with a total-length sentinel, posA, sA, oA, posB, sB, oB (G,P,R)),
    all coordinates exact int32."""
    G, P, k = order.shape
    R = pa.shape[1]
    Li = lengths.to(torch.int32)
    idx = order.long()
    L_slot = torch.gather(Li[:, None, :].expand(G, P, k), 2, idx)
    startsx = torch.cat([
        torch.zeros((G, P, 1), dtype=torch.int32, device=order.device),
        torch.cumsum(L_slot, dim=2, dtype=torch.int32)], dim=2)
    pos_of = inverse(order)
    start_of = torch.empty_like(L_slot).scatter_(2, idx, startsx[..., :k])
    ori_of = torch.empty_like(ori).scatter_(2, idx, ori)
    iA = pa.long()[:, None, :].expand(G, P, R)
    iB = pb.long()[:, None, :].expand(G, P, R)
    caches = [torch.gather(t, 2, ix) for ix in (iA, iB)
              for t in (pos_of, start_of, ori_of)]
    return (L_slot, startsx) + tuple(caches)


def group_sums(contrib: torch.Tensor) -> torch.Tensor:
    """(G, P) row sums of (G, P, R) contributions, one reduction per
    group. On the card a torch sum's block layout follows its output
    count, so a batched sum could round a row differently in a batch of
    another group count; per group, a row's sum does not depend on the
    groups beside it. On the CPU the rows sum in the same order either
    way."""
    return torch.stack([c.sum(dim=1) for c in contrib.unbind(0)])


def rescore_plain(order, ori, lengths, pa, pb, la, lb, d, w, caches: bool):
    """The same function in plain torch ops: the caches, each record's
    contribution, each row's f32 sum (one group at a time)."""
    c = build_caches(order, ori, lengths, pa, pb)
    contrib = contrib_from_cache(*c[2:], la, lb, d, w)
    scores = group_sums(contrib)
    return c + (contrib, scores) if caches else scores


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kbuild.load('rescore_population')
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rescore_plan.argtypes = [i32, i32, i32, i64, ctypes.POINTER(i64)]
    lib.rescore_plan.restype = ctypes.c_int
    fn = lib.rescore_population_launch
    fn.argtypes = [vp] * 22 + [i32, i32, i32, i64, ctypes.POINTER(i64), i32,
                               vp]
    fn.restype = ctypes.c_int
    return lib


# (device index, G, P, k, R) -> the kernel's launch plan (int64[12]:
# chunk, nchunks, then per mode, scores and caches: tile, smem_table,
# ntiles, chunks a CTA, the grid's chunk groups)
_PLANS = {}
# device index -> (arrival counters int32, partials f64): the kernel's
# workspace, reused by every call on the device (the counters are 0
# between calls; calls on two streams at once must not share it)
_WORK = {}


def plan(device: torch.device, G: int, P: int, k: int, R: int):
    """The kernel's launch plan for this shape on ``device`` (set up on the
    first call of the shape, then cached): a ctypes int64[12] of chunk
    (records, a function of k alone) and nchunks, then for scores mode
    and for caches mode: tile (tours a CTA), smem_table, ntiles, m
    (chunks a CTA) and the grid's chunk groups."""
    key = (device.index, G, P, k, R)
    p = _PLANS.get(key)
    if p is None:
        p = (ctypes.c_int64 * 12)()
        err = _lib().rescore_plan(G, P, k, R, p)
        if err != 0:
            raise RuntimeError('rescore_population plan failed: CUDA error '
                               '{}'.format(err))
        _PLANS[key] = p
    return p


def _workspace(device: torch.device, n_counters: int, n_partial: int):
    """The device's (counters, partials), grown to at least these sizes;
    new counters start at 0."""
    counters, partial = _WORK.get(device.index, (None, None))
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(n_partial, dtype=torch.float64, device=device)
    _WORK[device.index] = counters, partial
    return counters, partial


def _check(order, ori, lengths, pa, pb, la, lb, d, w):
    if order.dim() != 3 or pa.dim() != 2:
        raise ValueError('order must be (G, P, k) and pa (G, R), got {} '
                         'and {}'.format(tuple(order.shape),
                                         tuple(pa.shape)))
    G, P, k = order.shape
    R = pa.shape[1]
    i32, f32 = torch.int32, torch.float32
    want = [('order', order, i32, (G, P, k)), ('ori', ori, i32, (G, P, k)),
            ('lengths', lengths, torch.int64, (G, k)),
            ('pa', pa, i32, (G, R)), ('pb', pb, i32, (G, R)),
            ('la', la, i32, (G, R)), ('lb', lb, i32, (G, R)),
            ('d', d, f32, (G, 4, R)), ('w', w, f32, (G, R))]
    for name, t, dtype, shape in want:
        if t.device != order.device:
            raise ValueError('{} is on {}, order on {}'.format(
                name, t.device, order.device))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError('{}: want {} {}, got {} {}'.format(
                name, dtype, shape, t.dtype, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if G < 1 or P < 1 or k < 1:
        raise ValueError('empty population: G, P, k = {}, {}, {}'.format(
            G, P, k))
    if order.device.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device {}'.format(order.device))


def _launch(order, ori, lengths, pa, pb, la, lb, d, w, caches: bool,
            stream: int):
    """One launch on checked tensors that the library can address, on
    ``stream``; returns what ``rescore`` returns."""
    dev = order.device
    G, P, k = order.shape
    R = pa.shape[1]
    p = plan(dev, G, P, k, R)
    nchunks = p[1]
    tile, smem, ntiles, _, ny = p[2 + 5 * caches:7 + 5 * caches]
    counters, partial = _workspace(dev, G * ntiles, G * P * nchunks)
    # the global-table path: a slab of k padded rows a CTA
    gtab = None if smem else torch.empty(
        (G * ny * ntiles, k, tile + 2, 2), dtype=torch.int32, device=dev)
    scores = torch.empty((G, P), dtype=torch.float32, device=dev)
    out = ()
    if caches:
        out = (torch.empty((G, P, k), dtype=torch.int32, device=dev),
               torch.empty((G, P, k + 1), dtype=torch.int32, device=dev)) + \
            tuple(torch.empty((G, P, R), dtype=torch.int32, device=dev)
                  for _ in range(6)) + \
            (torch.empty((G, P, R), dtype=torch.float32, device=dev),)
    ptrs = [x.data_ptr() for x in (order, ori, lengths, pa, pb, la, lb, d, w)]
    ptrs += [None if gtab is None else gtab.data_ptr(), partial.data_ptr(),
             counters.data_ptr()]
    ptrs += [x.data_ptr() for x in out] if caches else [None] * 9
    err = _lib().rescore_population_launch(
        *ptrs, scores.data_ptr(), G, P, k, R, p, int(caches), stream)
    if err != 0:
        raise RuntimeError('rescore_population kernel launch failed: CUDA '
                           'error {}'.format(err))
    rescore.launches += 1
    return out + (scores,) if caches else scores


def rescore(order, ori, lengths, pa, pb, la, lb, d, w, caches: bool):
    """The population's scores (``caches`` False) or its caches,
    contributions and scores (``caches`` True; see the module's
    docstring): the CUDA kernel on CUDA tensors (one launch), the plain
    version on CPU tensors."""
    _check(order, ori, lengths, pa, pb, la, lb, d, w)
    args = (order, ori, lengths, pa, pb, la, lb, d, w, caches)
    if order.device.type == 'cpu':
        return rescore_plain(*args)
    with torch.cuda.device(order.device):
        return _launch(*args, torch.cuda.current_stream(
            order.device).cuda_stream)


rescore.launches = 0

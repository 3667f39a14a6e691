"""Delta generation of the device GA: one greedy generation from its
random draws, as the CUDA kernel's wrapper and its plain torch version.

Counterpart of ``dgen`` in ``_evolve_delta_impl``
(haphic_tpu/order/optimize.py:824-894), which is jitted XLA, not
Pallas: all of it but the draws. One generation proposes one move per
(group, individual) row; this module makes the move from the row's
seven draws (``moves_from_draws``, the JAX package's ``_sample_moves``
after its draws), reads the move's slot scalars, scores the move as an
explicit delta over the CLM records, accepts it against the
span-proportional threshold, commits the accepted rows' caches and
contributions, and applies their moves to the slot tables. Shapes,
batched over groups G (the GA state, in ``optimize``'s order):

    order, ori, L_slot  int32 (G, P, k)    tours and slot lengths
    startsx  int32 (G, P, k+1) exact slot starts (total-length sentinel)
    caches   int32 (G, P, R) x6  posA, sA, oA, posB, sB, oB: slot, exact
                                 start offset and orientation of each
                                 record's two contigs in each tour
    contrib  f32   (G, P, R)     carried per-record score contributions
    scores   f32   (G, P)        carried tour scores
    draws    (G, P) x7           u_do, op, e1, e2, e3, u_local, u_span
                                 (f32 uniforms in [0, 1), int32 draws)
    move     (G, P) x5           do (bool), op, i, j, t (int32)
    la, lb   int32 (G, R)        record endpoint lengths
    d        f32   (G, 4, R)     orientation-combination distances
    w        f32   (G, R)        record weights (0 for padding)
    -> delta f32 (G, P), acc bool (G, P); the state is updated in
       place (accepted rows only), which saves a copy of every (G, P, R)
       array per generation.

``delta_generation_from_draws`` (the GA's generation) and
``delta_generation`` (a given move, optionally a given acceptance) run
the kernel for CUDA tensors, one launch per generation in either mode,
and the plain version for CPU tensors; nothing else picks the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from haphic_tpu_torch.kernels import build as kbuild

STATE_FIELDS = ('order', 'ori', 'L_slot', 'startsx', 'posA', 'sA', 'oA',
                'posB', 'sB', 'oB', 'contrib', 'scores')
# the per-row (G, P) inputs of the two modes, with their dtypes
DRAW_FIELDS = (('u_do', torch.float32), ('op', torch.int32),
               ('e1', torch.int32), ('e2', torch.int32),
               ('e3', torch.int32), ('u_local', torch.float32),
               ('u_span', torch.float32))
MOVE_FIELDS = (('do', torch.bool), ('op', torch.int32), ('i', torch.int32),
               ('j', torch.int32), ('t', torch.int32))

# log(0.75) rounded to f32: the geometric span's divisor
LOG_075 = float(np.log(np.float32(0.75)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _log_075_on(device: torch.device) -> torch.Tensor:
    """LOG_075 as a 0-dim f32 tensor on ``device``, made once: making it
    copies from pageable host memory, which waits for the card. It must
    be a tensor on the device: CUDA divides by a Python scalar as a
    multiply by its reciprocal, which changes the quotient's bits."""
    return torch.tensor(LOG_075, dtype=torch.float32, device=device)


def moves_from_draws(u_do, op, e1, e2, e3, u_local, u_span, k: int,
                     mutprob: float, local_frac: float = 0.5):
    """(do, op, i, j, t) with op in {0 swap, 1 inversion of [i,j],
    2 rotation of [i,t) by j-i, 3 orientation flip of [i,j]}. A
    ``local_frac`` share of the moves is local (geometric span, mean
    ~4). The kernel's draws mode makes the same moves in the same f32
    arithmetic."""
    do = u_do < mutprob
    i = torch.minimum(e1, e2)
    j = torch.maximum(e1, e2)
    local = u_local < local_frac
    span = 1 + torch.floor(torch.log(1.0 - u_span)
                           / _log_075_on(u_span.device)).to(torch.int32)
    j_local = torch.clamp(e1 + span, max=k - 1)
    i = torch.where(local, e1, i)
    j = torch.where(local, torch.maximum(j_local, e1), j)
    e3 = torch.where(local, j, e3)
    t = torch.maximum(j, e3)
    return do, op, i, j, t


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


def move_scalars(startsx, i, j, t):
    """(Sx, Sy, Lx, Ly, Et) per individual, gathered from the int32
    slot-start table (G, P, k+1)."""
    v = torch.gather(startsx, 2, torch.stack(
        [i, i + 1, j, j + 1, t], dim=-1).long())
    Sx, Sxe, Sy, Sye, Et = v.unbind(-1)
    return Sx, Sy, Sxe - Sx, Sye - Sy, Et


def move_src(do, op, i, j, t, k: int):
    """Slot-level source indices of one move: new[idx] = old[src[idx]],
    plus the orientation-flip mask (inversion and op 3 flip the
    span)."""
    idx = torch.arange(k, dtype=torch.int32, device=do.device)
    ii, jj, tt = i[..., None], j[..., None], t[..., None]
    opx = op[..., None]
    src_swap = torch.where(idx == ii, jj, torch.where(idx == jj, ii, idx))
    in_span = (idx >= ii) & (idx <= jj)
    src_inv = torch.where(in_span, ii + jj - idx, idx)
    span = torch.clamp(tt - ii, min=1)
    in_rot = (idx >= ii) & (idx < tt)
    src_rot = torch.where(in_rot, ii + (idx - ii + (jj - ii)) % span, idx)
    src = torch.where(opx == 0, src_swap,
                      torch.where(opx == 1, src_inv,
                                  torch.where(opx == 2, src_rot, idx)))
    src = torch.where(do[..., None], src, idx)
    flip = do[..., None] & in_span & ((opx == 1) | (opx == 3))
    return src, flip


def apply_move(order, ori, src, flip):
    new_order = torch.gather(order, -1, src.long())
    new_ori = torch.gather(ori, -1, src.long())
    return new_order, torch.where(flip, 1 - new_ori, new_ori)


def touched_records(posA, posB, move):
    """bool (G, P, R): the records whose endpoint state ``move`` may
    change (an endpoint on a slot of [i, j], or [i, t) for a rotation):
    the records an accepted row writes. The rest give exactly 0.0."""
    do, op, i, j, t = [x[..., None] for x in move]
    hi = torch.where(op == 2, t - 1, j)
    return do & (((posA >= i) & (posA <= hi)) |
                 ((posB >= i) & (posB <= hi)))


def changed_records(posA, posB, move):
    """bool (G, P, R): the touched records whose contribution ``move``
    may change, the ones the kernel computes for the delta. The other
    touched records have both endpoints in one block that moves whole
    (the middle of a swap, the span of an inversion, either block of a
    rotation): the same gap, the same orientation combination seen from
    the first contig, so a bit-identical contribution. A flip changes
    every touched record."""
    do, op, i, j, t = [x[..., None] for x in move]
    hi = torch.where(op == 2, t - 1, j)

    def block(pos):
        b = torch.where(op == 0, torch.where(pos == i, 3, torch.where(
            pos == j, 4, 1)), torch.where((op == 2) & (pos >= j), 2, 1))
        return torch.where(do & (pos >= i) & (pos <= hi), b, 0)
    ca, cb = block(posA), block(posB)
    return ((ca | cb) != 0) & ((op == 3) | (ca != cb))


def record_update(state, move, la, lb, d, w):
    """(new caches posA, sA, oA, posB, sB, oB; new contributions) of
    every record under ``move``; ``state`` is not changed. The delta of
    a row sums new - old over its records."""
    posA, sA, oA, posB, sB, oB = state[4:10]
    scal = move_scalars(state[3], *move[2:])
    new = (endpoint_update(posA, sA, oA, la, *move, *scal)
           + endpoint_update(posB, sB, oB, lb, *move, *scal))
    return new, contrib_from_cache(*new, la, lb, d, w)


def delta_generation_plain(state, move, la, lb, d, w, min_gain: float,
                           span_gain: float, accept=None):
    """The same function in plain torch ops, operation for operation
    what the JAX package's dgen body computes after its draw: the move
    scalars, the threshold scores * (min_gain + span_gain * span), both
    endpoints of every record updated, the new contributions, delta =
    sum(new - old) per row (unaffected records give exactly 0.0: the
    same arithmetic on the same bits), acceptance ``delta > thr`` (or
    the given mask), and the accepted rows' caches, contributions, slot
    tables and scores written back in place."""
    (order, ori, L_slot, startsx, posA, sA, oA, posB, sB, oB, contrib,
     scores) = state
    do, op, i, j, t = move
    # span-proportional acceptance threshold (rejects score-neutral
    # macro moves that ride on an epsilon boundary gain)
    spanv = torch.where(op == 2, t - i, j - i).to(torch.float32)
    thr = scores * (min_gain + span_gain * spanv)
    new, new_c = record_update(state, move, la, lb, d, w)
    delta = (new_c - contrib).sum(dim=2)
    acc = delta > thr if accept is None else accept
    a_ = acc[..., None]
    for old, upd in zip((posA, sA, oA, posB, sB, oB, contrib),
                        new + (new_c,)):
        torch.where(a_, upd, old, out=old)
    src, flip = move_src(do, op, i, j, t, order.shape[-1])
    order2, ori2 = apply_move(order, ori, src, flip)
    torch.where(a_, order2, order, out=order)
    torch.where(a_, ori2, ori, out=ori)
    torch.where(a_, torch.gather(L_slot, -1, src.long()), L_slot,
                out=L_slot)
    startsx[..., 1:] = torch.cumsum(L_slot, dim=2, dtype=torch.int32)
    torch.where(acc, scores + delta, scores, out=scores)
    return delta, acc


@functools.lru_cache(maxsize=None)
def _launcher(draws: bool = False):
    lib = kbuild.load('delta_generation')
    vp, f = ctypes.c_void_p, ctypes.c_float
    if draws:
        fn = lib.delta_generation_draws_launch
        fn.argtypes = [vp] * 30 + [ctypes.c_int] * 3 + [
            ctypes.c_int64, f, f, f, f, f, ctypes.c_int, vp]
    else:
        fn = lib.delta_generation_launch
        fn.argtypes = [vp] * 24 + [ctypes.c_int] * 3 + [
            ctypes.c_int64, f, f, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    return fn


def _fields(xs, fields, kind):
    """(name, tensor, dtype) of the per-row (G, P) tensors ``xs``."""
    if len(xs) != len(fields):
        raise ValueError('want the {} {} fields ({})'.format(
            len(fields), kind, ', '.join(n for n, _ in fields)))
    return [('{} {}'.format(kind, n), x, dtype)
            for (n, dtype), x in zip(fields, xs)]


def _check(state, la, lb, d, w, rows):
    """Raises ValueError unless the state, the records and the per-row
    tensors ``rows`` ((name, tensor, dtype), each (G, P)) are what the
    kernel takes: on one device, contiguous, with the dtypes and shapes
    of the module docstring."""
    if len(state) != 12:
        raise ValueError('want the 12 state tensors ({})'.format(
            ', '.join(STATE_FIELDS)))
    if state[0].dim() != 3 or state[4].dim() != 3:
        raise ValueError('order and the caches must be (G, P, *)')
    G, P, k = state[0].shape
    R = state[4].shape[2]
    i32, f32 = torch.int32, torch.float32
    want = [(n, x, i32, (G, P, k)) for n, x in zip(STATE_FIELDS, state[:3])]
    want += [('startsx', state[3], i32, (G, P, k + 1))]
    want += [(n, x, i32, (G, P, R))
             for n, x in zip(STATE_FIELDS[4:10], state[4:10])]
    want += [('contrib', state[10], f32, (G, P, R)),
             ('scores', state[11], f32, (G, P))]
    want += [('la', la, i32, (G, R)), ('lb', lb, i32, (G, R)),
             ('d', d, f32, (G, 4, R)), ('w', w, f32, (G, R))]
    want += [(n, x, dtype, (G, P)) for n, x, dtype in rows]
    dev = state[0].device
    for name, x, dtype, shape in want:
        if x.device != dev:
            raise ValueError('{} is on {}, order on {}'.format(
                name, x.device, dev))
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError('{}: want {} {}, got {} {}'.format(
                name, dtype, shape, x.dtype, tuple(x.shape)))
        if not x.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError('unsupported device {}'.format(dev))


def _vec(state) -> int:
    """1 when the kernel may load slots 16 bytes at a time: 16-byte
    aligned rows."""
    R = state[4].shape[2]
    return int(R % 4 == 0 and state[4].data_ptr() % 16 == 0
               and state[7].data_ptr() % 16 == 0)


def _outputs(state):
    G, P = state[0].shape[:2]
    dev = state[0].device
    return (torch.empty((G, P), dtype=torch.float32, device=dev),
            torch.empty((G, P), dtype=torch.bool, device=dev))


def _launched(err):
    if err != 0:
        raise RuntimeError('delta_generation kernel launch failed: CUDA '
                           'error {}'.format(err))
    delta_generation.launches += 1


def delta_generation(state, move, la, lb, d, w, min_gain: float,
                     span_gain: float, accept=None):
    """(delta, acc) of one delta generation of the given ``move``; the
    state's accepted rows are updated in place. The CUDA kernel on CUDA
    tensors (one launch), the plain version on CPU tensors. ``accept``
    replaces the threshold test with a given mask."""
    rows = _fields(move, MOVE_FIELDS, 'move')
    if accept is not None:
        rows.append(('accept', accept, torch.bool))
    _check(state, la, lb, d, w, rows)
    dev = state[0].device
    if dev.type == 'cpu':
        return delta_generation_plain(state, move, la, lb, d, w, min_gain,
                                      span_gain, accept)
    G, P, k = state[0].shape
    R = state[4].shape[2]
    delta, acc = _outputs(state)
    ptrs = [x.data_ptr() for x in tuple(state) + tuple(move)
            + (la, lb, d, w)]
    ptrs += [None if accept is None else accept.data_ptr(),
             delta.data_ptr(), acc.data_ptr()]
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*ptrs, G, P, k, R, min_gain, span_gain, _vec(state),
                     stream)
    _launched(err)
    return delta, acc


def delta_generation_from_draws(state, draws, la, lb, d, w,
                                mutprob: float, local_frac: float,
                                min_gain: float, span_gain: float,
                                moves_out=None):
    """(delta, acc) of one whole delta generation from the seven
    ``draws`` (u_do, op, e1, e2, e3, u_local, u_span; each (G, P)) that
    ``moves_from_draws`` turns into moves; the state's accepted rows are
    updated in place. On CUDA tensors one kernel launch makes the moves
    too (counted in ``delta_generation.launches``); on CPU tensors
    ``moves_from_draws`` and the plain version. ``moves_out``, five
    (G, P) tensors (do bool, op, i, j, t int32), receives the moves."""
    rows = _fields(draws, DRAW_FIELDS, 'draw')
    if moves_out is not None:
        rows += _fields(moves_out, MOVE_FIELDS, 'moves_out')
    _check(state, la, lb, d, w, rows)
    dev = state[0].device
    G, P, k = state[0].shape
    if dev.type == 'cpu':
        move = moves_from_draws(*draws, k, mutprob, local_frac)
        if moves_out is not None:
            for out, x in zip(moves_out, move):
                out.copy_(x)
        return delta_generation_plain(state, move, la, lb, d, w, min_gain,
                                      span_gain)
    R = state[4].shape[2]
    delta, acc = _outputs(state)
    ptrs = [x.data_ptr() for x in tuple(state) + tuple(draws)
            + (la, lb, d, w, delta, acc)]
    ptrs += [None] * 5 if moves_out is None else [
        x.data_ptr() for x in moves_out]
    launch = _launcher(draws=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(*ptrs, G, P, k, R, min_gain, span_gain, mutprob,
                     local_frac, LOG_075, _vec(state), stream)
    _launched(err)
    return delta, acc


delta_generation.launches = 0

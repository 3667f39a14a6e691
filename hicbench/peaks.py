"""The yardstick's peaks and the operations and bytes of each kernel
call, frozen here so that a change to the program cannot move them.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM and 67 TFLOP/s FP32 outside the tensor cores (the
port runs FP32 with TF32 off).

Each ``*_cost`` function takes a call's arguments and gives (bytes,
operations, peak operations a second) for that call: each input byte
read once, each output byte written once, for what these inputs need.
The column pass's bytes are a copy, at commit 2773cb2, of
``haphic_tpu_torch/kernels/mcl_column.py`` ``pass_bytes`` /
``bound_ms``, cut to one call; the GA rescoring's a copy, at commit
334ba37, of ``haphic_tpu_torch/kernels/rescore.py`` ``bound_ms`` and
``OPS_PER_PAIR``. The sparse engine's two kernels count the columns they
are given, at the widths they are given, read once and their outputs
written once; the columns that a product gathers again are not counted.
A bound of a call is the larger of bytes over HBM_BPS and operations
over its peak.
"""

from __future__ import annotations

HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / HBM_BPS, ops / peak)


def gemm_cost(m, e: int):
    """``_matpower(m, e)``: e - 1 FP32 products of (..., n, n) matrices,
    2 n^3 operations each; the operands read and the product written."""
    n = m.shape[-1]
    B = m.numel() // (n * n)
    return (12 * B * n * n * (e - 1), 2 * B * n ** 3 * (e - 1), FP32_FLOPS)


def mcl_column_cost(e, infl, pruning, old=None):
    """One dense column pass: e read once (its storage, which iteration
    0 shares over the batch as a stride-0 view), old read once when
    given, the new matrices written once; a logf and an expf an entry."""
    B, n = e.shape[0], e.shape[-1]
    e_mats = 1 if e.stride(0) == 0 else B
    nbytes = 4 * n * n * (e_mats + B + (B if old is not None else 0))
    return nbytes, 2 * B * n * n, FP32_FLOPS


# FP32 operations a (tour, record) pair in the GA's rescoring: unpack two
# table entries (4), compare the slots (1), the gap (3), its conversion
# (1), the combination (3) and its distance's selection (3), the add,
# the clamp, the division and the sum (4)
RESCORE_OPS_PER_PAIR = 19


def rescore_cost(order, ori, lengths, pa, pb, la, lb, d, w, caches: bool):
    """One rescoring of a (G, P, k) population over (G, R) records:
    order and ori (8 B a slot) and lengths (8 B a contig) read, each
    record's pa, pb, la, lb, d[4], w (36 B) read, the scores written; in
    caches mode also the slot tables L_slot and startsx (8 B a slot) and
    the six endpoint caches and the contribution (28 B a pair) written.
    RESCORE_OPS_PER_PAIR operations a pair."""
    G, P, k = order.shape
    R = pa.shape[1]
    nbytes = 8 * G * P * k + 8 * G * k + 36 * G * R + 4 * G * P
    if caches:
        nbytes += 4 * G * P * (2 * k + 1) + 28 * G * P * R
    return nbytes, RESCORE_OPS_PER_PAIR * G * P * R, FP32_FLOPS


def sparse_column_cost(A_i, A_v, ci, cv, infl, n, K, pruning, expand):
    """One sparse column call on (B, C, Kc) columns: their ids and
    values (8 B an entry) read once and the (B, C, K) result written
    once; the columns of A that a product gathers are the iterate's own
    columns, which a sweep step reads once as its chunks' ``ci``, so they
    are not counted again. Operations: with ``expand`` the Kc x KA
    products a column, else one power an entry."""
    B, C, Kc = ci.shape
    nbytes = 8 * B * C * (Kc + K) + 4 * B
    ops = B * C * Kc * (A_i.shape[2] if expand else 1)
    return nbytes, ops, FP32_FLOPS


# FP32 operations an entry of a column pair in the convergence
# statistic's union merge: the difference, its absolute value, less
# rtol x |old|, the running max
COL_ALLCLOSE_OPS_PER_ENTRY = 4


def col_allclose_cost(old_i, old_v, new_i, new_v, n, bad=None):
    """One convergence statistic over (B, C) column pairs: the old
    (B, C, Ko) and new (B, C, Kn) ids and values read once (8 B an
    entry), the (B, C) f32 statistic written; the union merge's
    operations on each of the Ko + Kn entries."""
    B, C, Ko = old_i.shape
    Kn = new_i.shape[2]
    nbytes = 8 * B * C * (Ko + Kn) + 4 * B * C
    return (nbytes, COL_ALLCLOSE_OPS_PER_ENTRY * B * C * (Ko + Kn),
            FP32_FLOPS)
